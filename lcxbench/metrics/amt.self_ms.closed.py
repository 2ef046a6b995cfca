"""``amt.self_ms`` in a closed-loop cell, where the decode ticks set the
rate of output tokens."""
from lcxbench.readers import reader


def read(run):
    return reader("amt.self_ms")(run)
