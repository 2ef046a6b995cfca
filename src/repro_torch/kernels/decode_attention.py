"""GQA decode attention: the Hopper kernel and its plain version.

:func:`decode_attention` launches ``csrc/decode_attention.cu`` for CUDA
tensors and takes :func:`decode_attention_plain` for CPU tensors only.
Both take one decode step's un-roped ``q`` and new key and value rows,
the step's RoPE ``cos`` / ``sin``, one layer's cache and each slot's
length, and do what ``models.attention.attn_decode`` does between its
projections: rope ``q`` and the new key in f32 and round them to the
cache's bf16, write the new key and value into row ``clamp(length, 0,
Smax - 1)`` of the cache in place, and attend each slot's query heads over
its valid rows (those up to its length, within the window if there is
one).  The plain version is exactly that function's arithmetic
(:func:`repro_torch.models.attention.decode_attend`, ``p`` rounded to v's
dtype after the softmax); the kernel reads only each slot's valid rows,
rounds ``p`` before it divides by the row sum and sums in another order.

The reference decodes in plain JAX, so the kernel replaces no TPU kernel.
``launches`` counts the kernel's launches; nothing else adds to it.
"""
from __future__ import annotations

import ctypes
from typing import Any, Dict, Optional

import torch

from ..models.attention import decode_attend
from ..models.common import apply_rope
from . import build

HEAD_DIMS = (64, 128)
MAX_GROUP = 16     # query heads a KV head: one m16 tile of the products
CHUNK = 256        # cache rows a split of the kernel's grid

launches = 0

_ARGTYPES = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 7
             + [ctypes.c_float, ctypes.c_void_p])
# a zero ticket per (slot, KV head) on each device, grown as needed; the
# kernel leaves every ticket at zero when it ends, so launches that share
# them run one after another (one stream)
_TICKETS: Dict[torch.device, torch.Tensor] = {}


def takes(cfg: Any) -> bool:
    """True where the kernel computes ``cfg``'s decode attention: bf16,
    GQA layers (``mixer == "attn"``) with a head dim of 64 or 128 and at
    most ``MAX_GROUP`` query heads a KV head."""
    if cfg is None or cfg.dtype != torch.bfloat16:
        return False
    if not any(spec.mixer == "attn" for spec in cfg.layer_plan()):
        return False
    return (cfg.head_dim in HEAD_DIMS and cfg.n_heads % cfg.n_kv_heads == 0
            and cfg.n_heads // cfg.n_kv_heads <= MAX_GROUP)


def _check(q, k_new, v_new, cos, sin, k_cache, v_cache, lengths) -> None:
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"q must be [B, 1, Hq, hd], got {tuple(q.shape)}")
    b, _, hq, hd = q.shape
    if k_cache.dim() != 4 or k_cache.shape != v_cache.shape \
            or k_cache.shape[0] != b or k_cache.shape[3] != hd:
        raise ValueError(f"caches {tuple(k_cache.shape)} and "
                         f"{tuple(v_cache.shape)} do not fit q "
                         f"{tuple(q.shape)}")
    hkv = k_cache.shape[2]
    if hq % hkv:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={hkv}")
    for name, t in (("k_new", k_new), ("v_new", v_new)):
        if tuple(t.shape) != (b, 1, hkv, hd):
            raise ValueError(f"{name} must be {(b, 1, hkv, hd)}, got "
                             f"{tuple(t.shape)}")
    for name, t in (("cos", cos), ("sin", sin)):
        if tuple(t.shape) != (b, hd // 2):
            raise ValueError(f"{name} must be {(b, hd // 2)}, got "
                             f"{tuple(t.shape)}")
    if tuple(lengths.shape) != (b,):
        raise ValueError(f"lengths must be [{b}], got "
                         f"{tuple(lengths.shape)}")
    ts = (q, k_new, v_new, cos, sin, k_cache, v_cache, lengths)
    if len({t.device for t in ts}) != 1:
        raise ValueError(f"inputs on different devices: "
                         f"{[str(t.device) for t in ts]}")


def decode_attention_plain(q: torch.Tensor, k_new: torch.Tensor,
                           v_new: torch.Tensor, cos: torch.Tensor,
                           sin: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, lengths: torch.Tensor, *,
                           scale: float, window: Optional[int] = None
                           ) -> torch.Tensor:
    """Plain PyTorch version of the kernel: ``attn_decode``'s own steps.
    q [B,1,Hq,hd], k_new / v_new [B,1,Hkv,hd] un-roped, cos / sin
    [B,hd/2] f32, caches [B,Smax,Hkv,hd] (written in place), lengths [B]
    -> out [B,1,Hq,hd]."""
    _check(q, k_new, v_new, cos, sin, k_cache, v_cache, lengths)
    c, s = cos[:, None], sin[:, None]
    return decode_attend(apply_rope(q, c, s), apply_rope(k_new, c, s), v_new,
                         k_cache, v_cache, lengths, scale=scale,
                         window=window)


def _tickets(device: torch.device, n: int) -> torch.Tensor:
    t = _TICKETS.get(device)
    if t is None or t.numel() < n:
        t = _TICKETS[device] = torch.zeros(n, dtype=torch.int32,
                                           device=device)
    return t


def decode_attention(q: torch.Tensor, k_new: torch.Tensor,
                     v_new: torch.Tensor, cos: torch.Tensor,
                     sin: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, lengths: torch.Tensor, *,
                     scale: float, window: Optional[int] = None,
                     backend: Optional[str] = None) -> torch.Tensor:
    """One decode step's attention, the cache rows written in place:
    q [B,1,Hq,hd], k_new / v_new [B,1,Hkv,hd] (un-roped), cos / sin
    [B,hd/2], caches [B,Smax,Hkv,hd], lengths [B] -> out [B,1,Hq,hd].

    CUDA tensors go to the kernel on the current stream: contiguous,
    bf16 (cos and sin f32, lengths int32), a head dim of 64 or 128, at most
    ``MAX_GROUP`` query heads a KV head, each length in [0, Smax).  The
    kernel's grid comes from the shapes alone, so nothing waits for the
    card.  CPU tensors go to :func:`decode_attention_plain`.
    ``backend="xla"`` on a CUDA tensor raises (call
    :func:`decode_attention_plain`); every other value takes the kernel.
    Anything else raises."""
    global launches
    _check(q, k_new, v_new, cos, sin, k_cache, v_cache, lengths)
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_new, v_new, cos, sin, k_cache,
                                      v_cache, lengths, scale=scale,
                                      window=window)
    build.refuse_xla(backend, "decode_attention_plain")
    if q.device.type != "cuda":
        raise ValueError(f"no decode-attention kernel for {q.device}")
    bf = torch.bfloat16
    if not (q.dtype == k_new.dtype == v_new.dtype == k_cache.dtype
            == v_cache.dtype == bf) or cos.dtype != torch.float32 \
            or sin.dtype != torch.float32 or lengths.dtype != torch.int32:
        raise TypeError("the decode-attention kernel takes bf16 q, k_new, "
                        "v_new and caches, f32 cos and sin, int32 lengths")
    ts = (q, k_new, v_new, cos, sin, k_cache, v_cache, lengths)
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("the decode-attention kernel needs contiguous "
                         "inputs")
    b, _, hq, hd = q.shape
    smax, hkv = k_cache.shape[1], k_cache.shape[2]
    if hd not in HEAD_DIMS or hq // hkv > MAX_GROUP:
        raise ValueError(f"head dim {hd} and {hq // hkv} query heads a KV "
                         f"head: the kernel takes {HEAD_DIMS} and at most "
                         f"{MAX_GROUP}")
    if any(t.data_ptr() % 16 for t in (k_cache, v_cache)):
        raise ValueError("the decode-attention kernel needs 16-byte aligned "
                         "caches")
    if not scale > 0 or (window is not None and window < 1):
        raise ValueError(f"scale {scale} must be positive and window "
                         f"{window} None or positive")
    splits = -(-smax // CHUNK)
    out = torch.empty_like(q)
    part_acc = part_ml = None
    if splits > 1:
        n = b * hq * splits
        part_acc = torch.empty(n * hd, dtype=torch.float32, device=q.device)
        part_ml = torch.empty(2 * n, dtype=torch.float32, device=q.device)
    tickets = _tickets(q.device, b * hkv)
    fn = build.load("decode_attention").lcx_decode_attention
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(*(ptr(t) for t in (q, k_new, v_new, cos, sin, k_cache,
                                   v_cache, lengths, out, part_acc, part_ml,
                                   tickets)),
                b, hq, hkv, smax, hd, window or 0, CHUNK, float(scale),
                stream)
    if rc != 0:
        raise RuntimeError(f"decode-attention kernel launch failed: "
                           f"cudaError {rc}")
    launches += 1
    return out
