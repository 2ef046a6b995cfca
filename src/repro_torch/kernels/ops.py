"""Kernel entry points and the model's kernel hooks.

``model_kernels(cfg)`` builds the ``kernels=`` dict that
`repro_torch.models` reads.  The flash-attention hook takes the model's
seq-major layout, q [B,S,Hq,D] and k/v [B,S,Hkv,D], and returns
[B,S,Hq,Dv].  The SSD-scan hook comes with the SSM slice.
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from .flash_attention import flash_attention

__all__ = ["flash_attention", "model_kernels"]


def model_kernels(cfg: Any) -> Dict[str, Callable[..., torch.Tensor]]:
    """Kernels dict for the model hooks (``cfg`` is kept for the hooks
    of later slices, which read their chunk sizes from it)."""

    def attn_hook(q, k, v, *, causal, scale):
        o = flash_attention(q.transpose(1, 2).contiguous(),
                            k.transpose(1, 2).contiguous(),
                            v.transpose(1, 2).contiguous(),
                            causal=causal, scale=scale)
        return o.transpose(1, 2)

    return {"flash_attention": attn_hook}
