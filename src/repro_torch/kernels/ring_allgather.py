"""Ring all-gather over rank-stacked tensors: the Hopper kernel and its
plain version.

:func:`ring_all_gather` launches ``csrc/ring_allgather.cu`` for CUDA
tensors and takes :func:`ring_all_gather_plain` for CPU tensors only.
Both compute what the TPU kernel
``repro.kernels.ring_allgather._ring_kernel`` computes, rank-stacked:
``x [n, 1, *r]`` (rank i's shard is ``x[i]``) -> ``out [n, n, *r]`` with
``out[r, i] = x[i, 0]``.  The plain version follows the TPU kernel's
ring: each rank copies its shard into its own slot, then for n - 1 steps
puts the slot it received last into the same slot of its right
neighbour's row.  The CUDA kernel computes the same function by a
broadcast copy: on one card every rank's row lies in one memory, so it
reads each shard once and stores it to all n rows, along the plan that
:func:`plan` makes.  It is a byte copy, so any dtype goes.

``launches`` counts the kernel's launches; nothing else adds to it.
"""
from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional

import torch

from . import build

# the persistent grid: blocks per SM (csrc/ring_allgather.cu's TMA path
# fits 3 of its 64 KiB rings of shared memory on an SM)
BLOCKS_PER_SM = 3
VECS = (16, 8, 4, 2, 1)
# tiles are whole multiples of this many bytes, so that a tile never
# splits a cache line that its shard's start does not split
TILE_ALIGN = 4096

launches = 0

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
             ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
             ctypes.c_int, ctypes.c_void_p]
_FN: Optional[ctypes._CFuncPtr] = None
_SM_COUNT: Dict[int, int] = {}


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


class Plan(NamedTuple):
    """How the kernel copies: every shard's bytes ``[head, head + body)``
    in vectors of ``vec`` bytes, by TMA bulk copies if ``tma`` (16-byte
    vectors only) or else through registers, cut into tiles of ``tile``
    bytes (the last tile of a shard may be shorter) that ``grid`` blocks
    walk grid-stride; the shard's other bytes, ``[0, head)`` and
    ``[head + body, head + body + tail)``, by the byte path."""
    vec: int
    head: int
    body: int
    tail: int
    tile: int
    tiles_per_shard: int
    grid: int
    tma: bool


def plan(n: int, shard_bytes: int, x_mod16: int, out_mod16: int,
         sm_count: int) -> Plan:
    """The kernel's plan for ``n`` shards of ``shard_bytes`` at addresses
    ``x`` and ``out`` (given mod 16) on a card of ``sm_count`` SMs.

    ``vec`` is the widest vector at which every shard's body is aligned
    in both ``x[i]`` and every ``out[r, i]``: ``x`` and ``out`` must agree
    mod ``vec``, and with more than one shard ``shard_bytes`` must be a
    multiple of it.  The head runs up to ``x``'s first aligned byte.
    A 16-byte body goes by TMA.  Tiles are sized so that each of
    ``BLOCKS_PER_SM * sm_count`` blocks gets one tile or none."""
    if n < 1 or shard_bytes < 1 or sm_count < 1:
        raise ValueError(f"no plan for n={n}, shard_bytes={shard_bytes}, "
                         f"sm_count={sm_count}")
    vec = next(v for v in VECS if (x_mod16 - out_mod16) % v == 0
               and (n == 1 or shard_bytes % v == 0))
    head = min(-x_mod16 % vec, shard_bytes)
    body = (shard_bytes - head) // vec * vec
    tail = shard_bytes - head - body
    blocks = BLOCKS_PER_SM * sm_count
    per_shard = max(1, blocks // n)
    tile = max(1, _cdiv(_cdiv(body, per_shard), TILE_ALIGN)) * TILE_ALIGN
    tiles_per_shard = _cdiv(body, tile)
    grid = max(1, min(n * tiles_per_shard, blocks))
    return Plan(vec, head, body, tail, tile, tiles_per_shard, grid,
                vec == 16)


def _check(x: torch.Tensor) -> None:
    if x.dim() < 2 or x.shape[1] != 1 or x.shape[0] < 1:
        raise ValueError(f"x must be rank-stacked [n, 1, *r], got "
                         f"{tuple(x.shape)}")


def ring_all_gather_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel's function, by the TPU kernel's
    ring: the same loopback copy and n - 1 ring steps, as tensor copies
    along dim 0."""
    _check(x)
    n = x.shape[0]
    rows = torch.arange(n, device=x.device)
    out = x.new_empty((n, n) + tuple(x.shape[2:]))
    out[rows, rows] = x[:, 0]
    for step in range(n - 1):
        slot = (rows - step) % n
        out[(rows + 1) % n, slot] = out[rows, slot]
    return out


def _kernel() -> ctypes._CFuncPtr:
    global _FN
    if _FN is None:
        fn = build.load("ring_allgather").lcx_ring_allgather
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _sm_count(device: torch.device) -> int:
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    if idx not in _SM_COUNT:
        _SM_COUNT[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _SM_COUNT[idx]


def launch(x: torch.Tensor, out: torch.Tensor, p: Plan) -> None:
    """Launch the kernel on the current stream: ``out[r, i] = x[i, 0]``
    along plan ``p`` (of :func:`plan`, for these tensors' addresses),
    for contiguous CUDA tensors ``x [n, 1, *r]`` and ``out [n, n, *r]``."""
    global launches
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _kernel()(x.data_ptr(), out.data_ptr(), x.shape[0],
                       p.head + p.body + p.tail, p.vec, p.head, p.body,
                       p.tile, p.grid, int(p.tma), stream)
    if rc != 0:
        raise RuntimeError(f"ring all-gather kernel launch failed: "
                           f"cudaError {rc}")
    launches += 1


def ring_all_gather(x: torch.Tensor, *,
                    backend: Optional[str] = None) -> torch.Tensor:
    """``x [n, 1, *r] -> [n, n, *r]``, ``out[r, i] = x[i, 0]``.

    A contiguous CUDA tensor goes to the kernel on the current stream; a
    CPU tensor goes to :func:`ring_all_gather_plain`.  ``backend="xla"``
    on a CUDA tensor raises (call :func:`ring_all_gather_plain`); every
    other value takes the kernel.  Anything else raises."""
    _check(x)
    if x.device.type == "cpu":
        return ring_all_gather_plain(x)
    build.refuse_xla(backend, "ring_all_gather_plain")
    if x.device.type != "cuda":
        raise ValueError(f"no ring all-gather kernel for {x.device}")
    if not x.is_contiguous():
        raise ValueError("the ring all-gather kernel needs a contiguous x")
    n = x.shape[0]
    out = torch.empty((n, n) + tuple(x.shape[2:]), dtype=x.dtype,
                      device=x.device)
    shard = x[0].numel() * x.element_size()
    if shard:
        launch(x, out, plan(n, shard, x.data_ptr() % 16,
                            out.data_ptr() % 16, _sm_count(x.device)))
    return out
