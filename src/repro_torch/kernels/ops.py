"""Kernel entry points and the model's kernel hooks.

``model_kernels(cfg)`` builds the ``kernels=`` dict that
`repro_torch.models` reads, with the reference's hook signatures:

- ``flash_attention(q, k, v, *, causal, scale)``: the model's seq-major
  layout, q [B,S,Hq,D] and k/v [B,S,Hkv,D] -> [B,S,Hq,Dv];
- ``ssd_scan(x, dt, A, B, C, *, chunk)`` -> (y, h_final): the model's
  layout, which the kernel reads as it is.  ``chunk`` is the TPU
  kernel's block size (``cfg.ssm_chunk``); the CUDA kernel keeps its own
  chunk of ``ssd_scan.CHUNK`` rows, which changes only the order of the
  f32 sums.
"""
from __future__ import annotations

from typing import Any, Callable, Dict

from .flash_attention import flash_attention
from .ssd_scan import ssd_scan

__all__ = ["flash_attention", "ssd_scan", "model_kernels"]


def model_kernels(cfg: Any) -> Dict[str, Callable[..., Any]]:
    """Kernels dict for the model hooks (``cfg`` is kept for the hooks
    of later slices)."""

    def attn_hook(q, k, v, *, causal, scale):
        o = flash_attention(q.transpose(1, 2).contiguous(),
                            k.transpose(1, 2).contiguous(),
                            v.transpose(1, 2).contiguous(),
                            causal=causal, scale=scale)
        return o.transpose(1, 2)

    def ssd_hook(x, dt, A, Bm, Cm, *, chunk):
        return ssd_scan(x, dt, A, Bm, Cm)

    return {"flash_attention": attn_hook, "ssd_scan": ssd_hook}
