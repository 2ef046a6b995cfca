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
