"""Kernel entry points and the model's kernel hooks.

``model_kernels(cfg)`` builds the ``kernels=`` dict that
`repro_torch.models` reads, with the reference's hook signatures:

- ``flash_attention(q, k, v, *, causal, scale)``: the model's seq-major
  layout, q [B,S,Hq,D] and k/v [B,S,Hkv,D] -> [B,S,Hq,Dv]; left out for
  a config with a ``sliding_window`` (the kernel has no window mask);
- ``ssd_scan(x, dt, A, B, C, *, chunk)`` -> (y, h_final): the model's
  layout, which the kernel reads as it is.  ``chunk`` is the TPU
  kernel's block size (``cfg.ssm_chunk``); the CUDA kernel keeps its own
  chunk of ``ssd_scan.CHUNK`` rows, which changes only the order of the
  f32 sums;
- ``moe_gmm(xb, w)``: the expert FFN's products, xb [E,C,d] @ w [E,d,f]
  -> [E,C,f].  The reference builds no such hook (its expert FFN runs
  einsums, which compute the same function); the port's ``_expert_ffn``
  runs the kernel when the hook is there and the einsums when not;
- ``decode_attention(q, k_new, v_new, cos, sin, k_cache, v_cache,
  lengths, *, scale, window)`` -> out [B,1,Hq,hd]: one decode step of a
  GQA layer between its projections, fused: RoPE of the un-roped q and
  k_new, the cache-row write in place and the attention over each slot's
  valid rows (``decode_attention.decode_attention``).  Given where
  ``decode_attention.takes(cfg)``: bf16, GQA layers, a head dim of 64 or
  128 and at most 16 query heads a KV head (every GQA config of the
  port), a sliding window included.  The reference builds no such hook
  (it decodes in plain JAX); ``attn_decode`` runs its plain steps when
  the hook is absent.

``ring_all_gather(x, axis, *, axis_size)`` is the ring kernel's own entry
point, as in the reference: LCX's ``all_gather`` does not call it.

Every entry point takes the reference's ``backend=``.  A CPU tensor
takes the plain PyTorch version whatever it says.  On a CUDA tensor
``"xla"`` raises, naming the ``*_plain`` function a caller that wants the
plain version calls, and every other value (``None``, ``"pallas"``) takes
the kernel.  A kernel that fails to build or launch raises: no path
falls back to the plain version.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from ..core import ranks
from . import decode_attention as _decode
from . import ring_allgather as _ring
from .decode_attention import decode_attention
from .flash_attention import flash_attention
from .moe_gmm import moe_gmm
from .ssd_scan import ssd_scan

__all__ = ["flash_attention", "ssd_scan", "moe_gmm", "ring_all_gather",
           "decode_attention", "model_kernels"]


def ring_all_gather(x: torch.Tensor, axis: str, *, axis_size: int,
                    backend: Optional[str] = None) -> torch.Tensor:
    """Rank-stacked ``x [axis_size, 1, *r] -> [axis_size, axis_size, *r]``
    through the ring kernel (its plain version for a CPU tensor).  ``axis``
    must be bound to ``axis_size`` ranks (``ranks.bind_axis``), as the
    reference runs under ``shard_map`` over that axis."""
    if x.dim() == 0 or x.shape[0] != axis_size:
        raise ValueError(f"rank-stacked x has shape {tuple(x.shape)}, "
                         f"axis_size is {axis_size}")
    bound = ranks.axis_size(axis)
    if bound != axis_size:
        raise ValueError(f"axis {axis!r} is bound to {bound} ranks, "
                         f"axis_size is {axis_size}")
    return _ring.ring_all_gather(x, backend=backend)


def model_kernels(cfg: Any, backend: Optional[str] = None
                  ) -> Dict[str, Callable[..., Any]]:
    """Kernels dict for the model hooks.

    A config with a ``sliding_window`` gets no ``flash_attention`` hook:
    the kernel applies no window, so prefill takes the plain windowed
    attention (``attention_full`` / ``attention_chunked``), as the
    reference's serve path does (it builds its engine with no kernels).
    Such a config keeps the ``ssd_scan``, ``moe_gmm`` and
    ``decode_attention`` hooks.  Every hook passes ``backend`` on."""
    q_block = getattr(cfg, "q_block", 256)

    def attn_hook(q, k, v, *, causal, scale):
        # the kernel reads the transposed views and writes [B,S,H,D]
        o = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=causal, scale=scale,
                            block_q=q_block, block_k=q_block,
                            backend=backend)
        return o.transpose(1, 2)

    def ssd_hook(x, dt, A, Bm, Cm, *, chunk):
        return ssd_scan(x, dt, A, Bm, Cm, chunk=chunk, backend=backend)

    def gmm_hook(xb, w):
        return moe_gmm(xb, w, backend=backend)

    def decode_hook(q, k_new, v_new, cos, sin, k_cache, v_cache, lengths,
                    *, scale, window):
        return decode_attention(q, k_new, v_new, cos, sin, k_cache, v_cache,
                                lengths, scale=scale, window=window,
                                backend=backend)

    hooks = {"ssd_scan": ssd_hook, "moe_gmm": gmm_hook}
    if not getattr(cfg, "sliding_window", None):  # cfg may be None
        hooks["flash_attention"] = attn_hook
    if _decode.takes(cfg):
        hooks["decode_attention"] = decode_hook
    return hooks
