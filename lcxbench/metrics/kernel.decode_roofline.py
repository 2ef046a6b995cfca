"""The decode-attention kernel's launches in the profiled sub-window (one
a GQA layer and decode tick): the sum of their least times
(``kernels/decode_attention.py``: each slot's valid cache rows read, q,
the new rows and the output, ``counts.decode_attention_work``) over the
sum of the device times of ``decode_attn_kernel`` kernels, in %."""
from lcxbench.readers import kernel_roofline


def read(run):
    return kernel_roofline(run, "decode_attention")
