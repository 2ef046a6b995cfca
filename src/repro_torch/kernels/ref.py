"""Plain-PyTorch oracles, one for each kernel of the port (the port of
``repro/kernels/ref.py``)."""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        scale: Optional[float] = None) -> torch.Tensor:
    """q [B,Hq,Sq,Dk], k [B,Hkv,Sk,Dk], v [B,Hkv,Sk,Dv] -> [B,Hq,Sq,Dv].
    GQA via head grouping (Hq % Hkv == 0).  The causal mask is
    bottom-right aligned (``tril`` with offset Sk - Sq), unlike the
    kernel's top-left one; the two agree when Sq == Sk."""
    b, hq, sq, dk = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = dk ** -0.5 if scale is None else scale
    qg = q.reshape(b, hkv, g, sq, dk)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg.float(), k.float()) * scale
    if causal:
        mask = torch.ones(sq, sk, dtype=torch.bool,
                          device=q.device).tril(sk - sq)
        s = torch.where(mask, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return o.reshape(b, hq, sq, v.shape[-1]).to(v.dtype)


def ssd_scan_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 Bm: torch.Tensor, Cm: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequential (non-chunked) SSD recurrence, one position at a time:
    the gold reference.  x [B,S,H,P], dt [B,S,H] (>= 0), A [H] (< 0),
    B/C [B,S,H,N] -> y [B,S,H,P] in x's dtype, h_final [B,H,N,P] f32.
    (The reference's ``chunk`` argument is unused there and dropped.)"""
    b, s, h, p = x.shape
    f32 = torch.float32
    hstate = torch.zeros((b, h, Bm.shape[-1], p), dtype=f32,
                         device=x.device)
    ys = []
    for t in range(s):
        dtt = dt[:, t].to(f32)                          # [b,h]
        hstate = hstate * torch.exp(dtt * A)[..., None, None] \
            + torch.einsum("bh,bhn,bhp->bhnp", dtt, Bm[:, t].to(f32),
                           x[:, t].to(f32))
        ys.append(torch.einsum("bhn,bhnp->bhp", Cm[:, t].to(f32), hstate))
    return torch.stack(ys, dim=1).to(x.dtype), hstate


def moe_gmm_ref(xb: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Grouped (expert-batched) matmul: [E,C,d] @ [E,d,f] -> [E,C,f],
    summed in f32 and cast to xb's dtype."""
    return torch.einsum("ecd,edf->ecf", xb.float(), w.float()).to(xb.dtype)


def ring_allgather_ref(x: torch.Tensor) -> torch.Tensor:
    """Rank-stacked ``x [n, 1, *r] -> [n, n, *r]`` with ``out[r] =
    x[:, 0]``: ``lax.all_gather(x[0], axis, tiled=False)`` for every
    rank."""
    n = x.shape[0]
    return x[:, 0].unsqueeze(0).expand((n,) + tuple(x[:, 0].shape)).clone()


def decode_attention_ref(q: torch.Tensor, k_new: torch.Tensor,
                         v_new: torch.Tensor, cos: torch.Tensor,
                         sin: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, lengths: torch.Tensor, *,
                         scale: float, window: Optional[int] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One decode step, a sequence at a time, in f32, the caches left as
    they are: q [B,1,Hq,hd] and k_new / v_new [B,1,Hkv,hd] un-roped, cos /
    sin [B,hd/2], caches [B,Smax,Hkv,hd], lengths [B] -> (out [B,1,Hq,hd]
    in q's dtype, the key and value rows [B,Hkv,hd] that belong at row
    ``min(length, Smax - 1)``, in the cache's dtype).  Sequence i attends
    the rows ``max(0, len - window + 1) .. len`` with the new row in
    place."""
    b, _, hq, hd = q.shape
    smax, hkv = k_cache.shape[1], k_cache.shape[2]
    half = hd // 2

    def rope(x, i):                     # x [H, hd] -> f32
        x = x.float()
        c, s = cos[i].float(), sin[i].float()
        return torch.cat([x[:, :half] * c - x[:, half:] * s,
                          x[:, :half] * s + x[:, half:] * c], dim=-1)

    outs, k_rows, v_rows = [], [], []
    for i in range(b):
        n = int(lengths[i])
        at = min(max(n, 0), smax - 1)
        k_row = rope(k_new[i, 0], i).to(k_cache.dtype)
        v_row = v_new[i, 0].to(v_cache.dtype)
        lo = 0 if window is None else max(0, n - window + 1)
        k = torch.cat([k_cache[i, lo:at], k_row[None]]).float()
        v = torch.cat([v_cache[i, lo:at], v_row[None]]).float()
        qi = rope(q[i, 0], i).to(q.dtype).float()          # [Hq, hd]
        qg = qi.reshape(hkv, hq // hkv, hd)
        p = torch.softmax(torch.einsum("hgd,khd->hgk", qg, k) * scale, -1)
        o = torch.einsum("hgk,khd->hgd", p, v)
        outs.append(o.reshape(1, hq, hd).to(q.dtype))
        k_rows.append(k_row)
        v_rows.append(v_row)
    return torch.stack(outs), torch.stack(k_rows), torch.stack(v_rows)
