"""``device.decode_wait_ms`` in a closed-loop cell, where the decode ticks
set the rate of output tokens."""
from lcxbench.readers import reader


def read(run):
    return reader("device.decode_wait_ms")(run)
