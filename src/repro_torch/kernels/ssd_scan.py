"""Mamba-2 SSD chunked scan: the Hopper kernel and its plain version.

:func:`ssd_scan` launches ``csrc/ssd_scan.cu`` for CUDA tensors and takes
:func:`ssd_scan_plain` for CPU tensors only.  Both compute what the TPU
kernel ``repro.kernels.ssd_scan._ssd_kernel`` computes, in the model's
layout: x [B,S,H,P], dt [B,S,H] f32 (after softplus), A [H] f32
(negative), B/C [B,S,H,N] -> y [B,S,H,P] in x's dtype and the final
state h [B,H,N,P] in f32.  All decay arithmetic is in f32.

The chunk is fixed at :data:`CHUNK` rows.  Where S is not a multiple of
it, the last chunk's missing rows act as dt = 0, x = B = C = 0: the
cumulative decay stays flat over them and the state is unchanged.  (The
Pallas wrapper and ``ssd_chunked`` halve the chunk until it divides S
instead, down to one-row chunks for a prime S.)

On the card a call runs the chunk-parallel design of ``csrc/ssd_scan.cu``
in three kernel launches (each chunk's own state, the sequential pass
over chunk states, the outputs), with an f32 workspace of
:func:`workspace_floats` floats from ``torch.empty``.  ``launches``
counts calls of :func:`ssd_scan` that reach the kernel (one per Mamba
layer and prefill), not the three launches inside one; nothing else adds
to it.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from . import build

CHUNK = 64
MAX_STATE = 128
MAX_HEAD_DIM = 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0

_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
             + [ctypes.c_longlong] * 12 + [ctypes.c_int, ctypes.c_void_p])


def workspace_floats(b: int, s: int, h: int, p: int, n: int) -> int:
    """f32 floats of the kernel's workspace: each chunk's state [B,H,nc,N,P]
    (replaced in place by the state entering the chunk) and its decay
    gamma [B,H,nc]."""
    return b * h * (-(-s // CHUNK)) * (n * p + 1)


def _check(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
           Bm: torch.Tensor, Cm: torch.Tensor) -> None:
    if not (x.dim() == Bm.dim() == Cm.dim() == 4 and dt.dim() == 3
            and A.dim() == 1):
        raise ValueError("x, B, C must be 4-D [B,S,H,*], dt 3-D [B,S,H], "
                         "A 1-D [H]")
    if len({t.device for t in (x, dt, A, Bm, Cm)}) != 1:
        raise ValueError(f"inputs on different devices: "
                         f"{[str(t.device) for t in (x, dt, A, Bm, Cm)]}")
    if not (x.dtype == Bm.dtype == Cm.dtype) or x.dtype not in _DTYPES:
        raise TypeError(f"x, B, C must share one dtype of float32 or "
                        f"bfloat16, got {x.dtype}, {Bm.dtype}, {Cm.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"dt and A must be float32, got {dt.dtype}, "
                        f"{A.dtype}")
    b, s, h, _ = x.shape
    if (tuple(dt.shape) != (b, s, h) or tuple(A.shape) != (h,)
            or Bm.shape[:3] != x.shape[:3] or Bm.shape != Cm.shape):
        raise ValueError(f"shapes do not fit: x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, B "
                         f"{tuple(Bm.shape)}, C {tuple(Cm.shape)}")
    if s < 1:
        raise ValueError("empty sequence")


def ssd_scan_plain(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   Bm: torch.Tensor, Cm: torch.Tensor, *,
                   chunk: int = CHUNK) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: the three-phase chunked SSD
    (per-chunk quadratic term and chunk state, the sequential pass over
    chunk states, the carried state's offset) with ``chunk`` rows per
    chunk and a zero-dt tail.  Returns (y [B,S,H,P], h_final [B,H,N,P])."""
    _check(x, dt, A, Bm, Cm)
    b, s, h, p = x.shape
    f32 = torch.float32
    nc = -(-s // chunk)
    pad = nc * chunk - s

    def chunks(t: torch.Tensor) -> torch.Tensor:
        # [B,S,H,*] -> [B,nc,chunk,H,*] in f32, the tail rows zero
        t = F.pad(t.to(f32), (0, 0) * (t.dim() - 2) + (0, pad))
        return t.reshape((b, nc, chunk) + tuple(t.shape[2:]))

    xs, dts, Bs, Cs = map(chunks, (x, dt, Bm, Cm))
    A = A.to(f32)

    # phase 1: within-chunk term and each chunk's own state
    cum = torch.cumsum(dts * A, dim=2)                  # [b,nc,cs,H] <= 0
    cum_last = cum[:, :, -1:, :]
    scores = torch.einsum("bcihn,bcjhn->bchij", Cs, Bs)
    cum_t = cum.transpose(2, 3)                         # [b,nc,H,cs]
    tri = torch.ones(chunk, chunk, dtype=torch.bool, device=x.device).tril()
    # j > i would be exp of a positive number: mask before the exp
    decay = torch.exp((cum_t[..., :, None] - cum_t[..., None, :])
                      .masked_fill(~tri, float("-inf")))
    w = scores * decay * dts.transpose(2, 3)[..., None, :]
    y = torch.einsum("bchij,bcjhp->bcihp", w, xs)
    chunk_state = torch.einsum("bcjh,bcjhn,bcjhp->bchnp",
                               torch.exp(cum_last - cum) * dts, Bs, xs)
    gamma = torch.exp(cum_last[:, :, 0])                # [b,nc,H]

    # phase 2: the state entering each chunk
    hstate = torch.zeros((b, h, Bm.shape[-1], p), dtype=f32,
                         device=x.device)
    h_in = []
    for c in range(nc):
        h_in.append(hstate)
        hstate = hstate * gamma[:, c, :, None, None] + chunk_state[:, c]

    # phase 3: the carried state's contribution
    y = y + torch.einsum("bcihn,bchnp->bcihp", Cs,
                         torch.stack(h_in, dim=1)) * torch.exp(cum)[..., None]
    return y.reshape(b, nc * chunk, h, p)[:, :s].to(x.dtype), hstate


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B,S,H,P], dt [B,S,H], A [H], B/C [B,S,H,N] -> (y [B,S,H,P],
    h_final [B,H,N,P] f32).

    CUDA tensors (N and P up to 128, the last dim of x, B and C with
    stride 1, any other strides) go to the kernel on the current stream;
    CPU tensors go to :func:`ssd_scan_plain`.  Anything else raises."""
    global launches
    _check(x, dt, A, Bm, Cm)
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, A, Bm, Cm)
    if x.device.type != "cuda":
        raise ValueError(f"no SSD-scan kernel for {x.device}")
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    if n > MAX_STATE or p > MAX_HEAD_DIM:
        raise ValueError(f"state {n} / head dim {p} exceed "
                         f"{MAX_STATE} / {MAX_HEAD_DIM}")
    if any(t.stride(-1) != 1 for t in (x, Bm, Cm)):
        raise ValueError("the SSD-scan kernel needs x, B, C with a "
                         "unit-stride last dim")
    A = A.contiguous()
    y = torch.empty((b, s, h, p), dtype=x.dtype, device=x.device)
    h_final = torch.empty((b, h, n, p), dtype=torch.float32,
                          device=x.device)
    ws = torch.empty(workspace_floats(b, s, h, p, n), dtype=torch.float32,
                     device=x.device)
    fn = build.load("ssd_scan").lcx_ssd_scan_fwd
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                Cm.data_ptr(), y.data_ptr(), h_final.data_ptr(),
                ws.data_ptr(), b, s, h, p, n, *x.stride()[:3], *dt.stride(),
                *Bm.stride()[:3], *Cm.stride()[:3], _DTYPES[x.dtype],
                stream)
    if rc != 0:
        raise RuntimeError(f"SSD-scan kernel launch failed: cudaError {rc}")
    launches += 1
    return y, h_final
