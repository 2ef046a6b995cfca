"""``model.mfu.decode`` in a closed-loop cell, where the decode ticks set
the rate of output tokens."""
from lcxbench.readers import reader


def read(run):
    return reader("model.mfu.decode")(run)
