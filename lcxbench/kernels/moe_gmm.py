"""The grouped matmul (``moe_gmm(xb [E, C, d], w [E, d, f])``): the rows
that the last routing sent to each expert, up to the launch's capacity C
(padding left out), through their experts, and the weights of the experts
that at least one row chose (``counts.gmm_work``)."""
from lcxbench import counts

marks = ("gmm_mma_kernel", "gmm_kernel")


def record(args, kwargs):
    xb, w = args[:2]
    return tuple(xb.shape), tuple(w.shape)


def bound_s(cfg, rec, ctx):
    (e, c, d_in), (_, _, d_out) = rec[0], rec[1]
    n_e = ctx["route"].reshape(-1).bincount(minlength=e).clamp(max=c)
    rows, experts = int(n_e.sum()), int((n_e > 0).sum())
    return counts.bound_s(*counts.gmm_work(rows, experts, d_in, d_out))
