"""``kernel.decode_roofline`` in a closed-loop cell, where the decode ticks
set the rate of output tokens."""
from lcxbench.readers import reader


def read(run):
    return reader("kernel.decode_roofline")(run)
