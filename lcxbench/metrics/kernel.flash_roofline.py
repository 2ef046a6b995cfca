"""The flash-attention launches in the profiled sub-window: the sum of
their least times (``kernels/flash_attention.py``: ``counts.flash_work``
at each admitted prompt's length, causal) over the sum of the device
times of ``flash`` kernels, in %."""
from lcxbench.readers import kernel_roofline


def read(run):
    return kernel_roofline(run, "flash_attention")
