"""Capacity-format grouped matmul: the Hopper kernel and its plain version.

:func:`moe_gmm` launches ``csrc/moe_gmm.cu`` for CUDA tensors and takes
:func:`moe_gmm_plain` for CPU tensors only.  Both compute what the TPU
kernel ``repro.kernels.moe_gmm._gmm_kernel`` computes: ``xb [E, C, d] @
w [E, d, f] -> [E, C, f]`` with every product summed in f32 and rounded
once to ``xb``'s dtype.  The kernel sums each output in one fixed order
whatever C is, so an output row does not depend on the other rows of the
launch; the plain version sums in PyTorch's order.

``launches`` counts the kernel's launches; nothing else adds to it.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0

_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 4
             + [ctypes.c_int, ctypes.c_void_p])


def _check(xb: torch.Tensor, w: torch.Tensor) -> None:
    if xb.dim() != 3 or w.dim() != 3:
        raise ValueError(f"xb must be [E, C, d] and w [E, d, f], got "
                         f"{tuple(xb.shape)} and {tuple(w.shape)}")
    if xb.shape[0] != w.shape[0] or xb.shape[2] != w.shape[1]:
        raise ValueError(f"xb {tuple(xb.shape)} does not fit w "
                         f"{tuple(w.shape)}")
    if xb.device != w.device:
        raise ValueError(f"xb and w on different devices: {xb.device}, "
                         f"{w.device}")
    if xb.dtype != w.dtype or xb.dtype not in _DTYPES:
        raise TypeError(f"xb and w must share one dtype of float32 or "
                        f"bfloat16, got {xb.dtype} and {w.dtype}")


def moe_gmm_plain(xb: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: one f32 batched product, cast
    to ``xb``'s dtype."""
    _check(xb, w)
    return torch.einsum("ecd,edf->ecf", xb.float(), w.float()).to(xb.dtype)


def moe_gmm(xb: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``xb [E, C, d] @ w [E, d, f] -> [E, C, f]``.

    Contiguous CUDA tensors of one dtype (float32 or bfloat16) go to the
    kernel on the current stream (which refuses E above 65535 and C, d, f
    of 2^31 or more); CPU tensors go to :func:`moe_gmm_plain`.  Anything
    else raises."""
    global launches
    _check(xb, w)
    if xb.device.type == "cpu":
        return moe_gmm_plain(xb, w)
    if xb.device.type != "cuda":
        raise ValueError(f"no grouped-matmul kernel for {xb.device}")
    if not (xb.is_contiguous() and w.is_contiguous()):
        raise ValueError("the grouped-matmul kernel needs contiguous xb, w")
    e, c, d = xb.shape
    f = w.shape[2]
    if min(e, c, f) == 0 or d == 0:
        # nothing to launch: an empty output, or sums of no terms
        return torch.zeros((e, c, f), dtype=xb.dtype, device=xb.device)
    out = torch.empty((e, c, f), dtype=xb.dtype, device=xb.device)
    fn = build.load("moe_gmm").lcx_moe_gmm
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    with torch.cuda.device(xb.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(xb.data_ptr(), w.data_ptr(), out.data_ptr(), e, c, d, f,
                _DTYPES[xb.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"grouped-matmul kernel launch failed: "
                           f"cudaError {rc}")
    launches += 1
    return out
