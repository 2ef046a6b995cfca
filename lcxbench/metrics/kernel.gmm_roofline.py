"""The grouped matmul's launches in the profiled sub-window: the sum of
their least times (``kernels/moe_gmm.py``: the rows routed to each expert
up to the launch's capacity, and the weights of the experts at least one
row chose) over the sum of the device times of ``gmm`` kernels, in %."""
from lcxbench.readers import kernel_roofline


def read(run):
    return kernel_roofline(run, "moe_gmm")
