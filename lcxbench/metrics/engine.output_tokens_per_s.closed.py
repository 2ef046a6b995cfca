"""``output_tokens_per_s`` read per layer in a closed-loop cell: the tokens
the window's ticks served over the window, in a traced run (its profiled
ticks included).  The engine's eager decode dispatch sets it there, and
the host's speed with it, too unsteady from run to run to bound."""
from lcxbench.readers import reader


def read(run):
    return reader("output_tokens_per_s")(run)
