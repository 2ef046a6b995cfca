"""Flash attention (``flash_attention(q [B, S, Hq, D], k [B, Sk, Hkv, D],
v, *, causal, scale)``): the two products over the pairs the mask keeps,
and q, k, v read and o written once (``counts.flash_work``), for each of
the B sequences."""
from lcxbench import counts

marks = ("flash_mma_kernel", "flash_f32_kernel")


def record(args, kwargs):
    q, k = args[:2]
    return tuple(q.shape), tuple(k.shape), kwargs.get("causal", True)


def bound_s(cfg, rec, ctx):
    (b, sq, hq, d), (_, sk, hkv, _) = rec[0], rec[1]
    fl, nb = counts.flash_work(hq, hkv, sq, sk, d, rec[2])
    return counts.bound_s(b * fl, b * nb)
