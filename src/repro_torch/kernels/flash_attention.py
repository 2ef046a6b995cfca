"""GQA flash-attention forward: the Hopper kernel and its plain version.

:func:`flash_attention` launches ``csrc/flash_attention.cu`` for CUDA
tensors and takes :func:`flash_attention_plain` for CPU tensors only.  Both
compute what the TPU kernel ``repro.kernels.flash_attention._flash_kernel``
computes: scores, max and sum in f32, ``p`` rounded to v's dtype before
the PV product, a top-left aligned causal mask (row >= col, which is
``kernels/ref.py``'s bottom-right mask only when Sq == Sk), and the
``l == 0 -> 1`` guard.

The kernel reads q, k and v as strided views (innermost dim contiguous)
and writes its output into a ``[B, Sq, Hq, Dv]`` buffer that it returns as
the ``[B, Hq, Sq, Dv]`` view: the model's seq-major activations go in and
come out without a copy.  bfloat16 runs on tensor cores, float32 on
scalar FMAs (``csrc/flash_attention.cu``).

``launches`` counts the kernel's launches; nothing else adds to it.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import build

NEG_INF = -1e30
MAX_HEAD_DIM = 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0

_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.POINTER(ctypes.c_longlong)]
             + [ctypes.c_int] * 7
             + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if not (q.dim() == k.dim() == v.dim() == 4):
        raise ValueError("q, k, v must be 4-D [B, H, S, D]")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on different devices: "
                         f"{q.device}, {k.device}, {v.device}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError(f"q, k, v must share one dtype of float32 or "
                        f"bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    b, hq, sq, dk = q.shape
    if k.shape[0] != b or v.shape[0] != b or k.shape[1] != v.shape[1]:
        raise ValueError(f"batch/head mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if k.shape[3] != dk or k.shape[2] != v.shape[2]:
        raise ValueError(f"k {tuple(k.shape)} does not fit q "
                         f"{tuple(q.shape)} and v {tuple(v.shape)}")
    hkv = k.shape[1]
    if hkv < 1 or hq % hkv:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={hkv}")
    if min(sq, k.shape[2]) < 1:
        raise ValueError("empty sequence")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel (one block spanning all keys).
    q [B,Hq,Sq,Dk], k [B,Hkv,Sk,Dk], v [B,Hkv,Sk,Dv] -> [B,Hq,Sq,Dv]."""
    _check(q, k, v)
    b, hq, sq, dk = q.shape
    hkv, sk, dv = k.shape[1], k.shape[2], v.shape[3]
    scale = dk ** -0.5 if scale is None else scale
    qg = q.float().reshape(b, hkv, hq // hkv, sq, dk)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float()) * scale
    if causal:
        keep = torch.ones(sq, sk, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p.to(v.dtype).float(), v.float())
    return (o / l).reshape(b, hq, sq, dv).to(v.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q [B,Hq,Sq,Dk], k [B,Hkv,Sk,Dk], v [B,Hkv,Sk,Dv] -> [B,Hq,Sq,Dv].

    CUDA tensors (float32 or bfloat16, head dims up to 128, any strides
    with a contiguous innermost dim) go to the kernel on the current
    stream, whose output is the ``[B,Hq,Sq,Dv]`` view of a
    ``[B,Sq,Hq,Dv]``-contiguous tensor; CPU tensors go to
    :func:`flash_attention_plain`.  Anything else raises."""
    global launches
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"no flash-attention kernel for {q.device}")
    if any(t.stride(3) != 1 and t.shape[3] > 1 for t in (q, k, v)):
        raise ValueError("the flash-attention kernel needs q, k, v with a "
                         "contiguous innermost (head) dim")
    b, hq, sq, dk = q.shape
    hkv, sk, dv = k.shape[1], k.shape[2], v.shape[3]
    if max(dk, dv) > MAX_HEAD_DIM:
        raise ValueError(f"head dims {dk}/{dv} exceed {MAX_HEAD_DIM}")
    scale = dk ** -0.5 if scale is None else scale
    if not scale > 0:
        raise ValueError(f"the flash-attention kernel takes a positive "
                         f"scale, got {scale}")
    out = torch.empty((b, sq, hq, dv), dtype=v.dtype,
                      device=q.device).transpose(1, 2)
    strides = (ctypes.c_longlong * 12)(*[
        st for t in (q, k, v, out) for st in t.stride()[:3]])
    fn = build.load("flash_attention").lcx_flash_attention_fwd
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                strides, b, hq, hkv, sq, sk, dk, dv, float(scale),
                int(causal), _DTYPES[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"flash-attention kernel launch failed: "
                           f"cudaError {rc}")
    launches += 1
    return out
