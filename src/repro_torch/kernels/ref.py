"""Plain-PyTorch oracles, one for each kernel of the port (the port of
``repro/kernels/ref.py``; the other kernels' oracles come with their
slices)."""
from __future__ import annotations

from typing import Optional

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
