"""``device.idle_share.dispatch`` in a closed-loop cell, where the decode
ticks set the rate of output tokens."""
from lcxbench.readers import reader


def read(run):
    return reader("device.idle_share.dispatch")(run)
