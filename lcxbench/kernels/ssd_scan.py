"""The SSD chunked scan (``ssd_scan(x [B, S, H, P], dt [B, S, H], A [H],
B [B, S, H, N], C, *, chunk)``): x, dt, A, B and C read once, y and the
final state written once, and the products the data needs
(``counts.ssd_work``).  B and C count once for all heads where they come
with stride 0 over the heads (one group, as the mixer passes them), once
a head where the mixer had to repeat a group's over its heads.  One call
runs three kernels: each chunk's state, the pass over chunks, the
outputs."""
from lcxbench import counts

marks = ("ssd_state_", "ssd_pass_kernel", "ssd_out_")
kernels_per_call = 3
CHUNK = 64   # the CUDA kernel's own (``repro_torch.kernels.ssd_scan``)


def record(args, kwargs):
    x, b_mat = args[0], args[3]
    return (tuple(x.shape), tuple(b_mat.shape), b_mat.stride(2) == 0,
            x.element_size())


def bound_s(cfg, rec, ctx):
    (b, s, h, p), (_, _, _, n), shared, esize = rec[:4]
    return counts.bound_s(*counts.ssd_work(b, s, h, p, n, 1 if shared else h,
                                           CHUNK, esize))
