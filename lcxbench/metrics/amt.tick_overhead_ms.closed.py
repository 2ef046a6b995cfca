"""``amt.tick_overhead_ms`` in a closed-loop cell, where the decode ticks set
the rate of output tokens."""
from lcxbench.readers import reader


def read(run):
    return reader("amt.tick_overhead_ms")(run)
