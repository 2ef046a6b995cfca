"""GQA decode attention (``decode_attention(q [B, 1, Hq, hd], k_new,
v_new, cos, sin, k_cache [B, Smax, Hkv, hd], v_cache, lengths [B], *,
scale, window)``): over each slot's valid rows, positions
``max(0, length - window + 1)`` to ``min(length, Smax - 1)`` (a free slot,
length 0, has the one row it writes), the two products, those rows of K
and V read once, q, the new rows, cos, sin and the lengths read once, the
output and the two rows written once (``counts.decode_attention_work``).

The record keeps the ``lengths`` tensor itself, read after the window:
the engine builds it anew each decode step and nothing writes it after.
A CPU tensor may share its memory with the engine's own lengths, which
change; it is copied."""
from lcxbench import counts

marks = ("decode_attn_kernel",)


def record(args, kwargs):
    q, k_cache, lengths = args[0], args[5], args[7]
    if not lengths.is_cuda:
        lengths = lengths.clone()
    return (tuple(q.shape), tuple(k_cache.shape), lengths,
            kwargs.get("window"), q.element_size())


def valid_rows(lengths, smax: int, window) -> int:
    """Cache rows the step reads, over every slot."""
    hi = lengths.long().clamp(0, smax - 1)
    lo = (lengths.long() - window + 1).clamp(min=0) if window else 0
    return int((hi - lo + 1).clamp(min=1).sum())


def bound_s(cfg, rec, ctx):
    (b, _, hq, hd), (_, smax, hkv, _), lengths, window, esize = rec[:5]
    rows = valid_rows(lengths.cpu(), smax, window)
    return counts.bound_s(*counts.decode_attention_work(b, hq, hkv, hd,
                                                        rows, esize))
