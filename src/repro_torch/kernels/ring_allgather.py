"""Ring all-gather over rank-stacked tensors: the Hopper kernel and its
plain version.

:func:`ring_all_gather` launches ``csrc/ring_allgather.cu`` for CUDA
tensors and takes :func:`ring_all_gather_plain` for CPU tensors only.
Both compute what the TPU kernel
``repro.kernels.ring_allgather._ring_kernel`` computes, rank-stacked:
``x [n, 1, *r]`` (rank i's shard is ``x[i]``) -> ``out [n, n, *r]`` with
``out[r, i] = x[i, 0]``, by the TPU kernel's ring: each rank copies its
shard into its own slot, then for n - 1 steps puts the slot it received
last into the same slot of its right neighbour's row.  It is a byte copy,
so any dtype goes.

``launches`` counts the kernel's launches; nothing else adds to it.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

# csrc/ring_allgather.cu's MAX_BLOCKS_PER_RANK: the flag scratch holds
# one word per (rank, step, block)
MAX_BLOCKS_PER_RANK = 256

launches = 0

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_longlong, ctypes.c_void_p]


def _check(x: torch.Tensor) -> None:
    if x.dim() < 2 or x.shape[1] != 1 or x.shape[0] < 1:
        raise ValueError(f"x must be rank-stacked [n, 1, *r], got "
                         f"{tuple(x.shape)}")


def ring_all_gather_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the same loopback copy and
    n - 1 ring steps, as tensor copies along dim 0."""
    _check(x)
    n = x.shape[0]
    rows = torch.arange(n, device=x.device)
    out = x.new_empty((n, n) + tuple(x.shape[2:]))
    out[rows, rows] = x[:, 0]
    for step in range(n - 1):
        slot = (rows - step) % n
        out[(rows + 1) % n, slot] = out[rows, slot]
    return out


def ring_all_gather(x: torch.Tensor) -> torch.Tensor:
    """``x [n, 1, *r] -> [n, n, *r]``, ``out[r, i] = x[i, 0]``.

    A contiguous CUDA tensor goes to the kernel on the current stream; a
    CPU tensor goes to :func:`ring_all_gather_plain`.  Anything else
    raises."""
    global launches
    _check(x)
    if x.device.type == "cpu":
        return ring_all_gather_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"no ring all-gather kernel for {x.device}")
    if not x.is_contiguous():
        raise ValueError("the ring all-gather kernel needs a contiguous x")
    n = x.shape[0]
    out = torch.empty((n, n) + tuple(x.shape[2:]), dtype=x.dtype,
                      device=x.device)
    shard = x[0].numel() * x.element_size()
    if shard == 0:
        return out
    flags = torch.empty(n * (n - 1) * MAX_BLOCKS_PER_RANK,
                        dtype=torch.int32, device=x.device)
    fn = build.load("ring_allgather").lcx_ring_allgather
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(x.data_ptr(), out.data_ptr(), flags.data_ptr(),
                flags.numel(), n, shard, stream)
    if rc != 0:
        raise RuntimeError(f"ring all-gather kernel launch failed: "
                           f"cudaError {rc}")
    launches += 1
    return out
