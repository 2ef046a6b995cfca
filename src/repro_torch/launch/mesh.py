"""Mesh construction (the port of ``repro/launch/mesh.py``).

The port's mesh (:class:`repro_torch.parallel.sharding.Mesh`) is names
and sizes with every rank on one card, so these are functions of the
shape alone and touch no device state.

Single pod:  (data=16, model=16)            = 256 ranks
Multi-pod:   (pod=2, data=16, model=16)     = 512 ranks

Axis roles (see ``repro_torch.parallel.sharding.DEFAULT_RULES``):
- ``pod``   — data parallelism across pods;
- ``data``  — data parallelism + FSDP (ZeRO-3) parameter sharding;
- ``model`` — tensor / expert parallelism, and sequence parallelism for
  long-context decode.

The shapes of :func:`make_production_mesh`, (16, 16) and (2, 16, 16),
stay the reference's (a TPU pod's): the dry run counts the reference's
cells on them.  The hardware constants below are the H100's, which the
roofline (``analysis/roofline.py``) divides the counted work by.  The
collective term prices every byte at NVLink's rate, which holds inside
one 8-GPU node; an axis wider than a node crosses InfiniBand, which is
slower, so there the term is a lower bound.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..parallel.sharding import Mesh


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes)


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...]) -> Mesh:
    return Mesh(shape, axes)


def make_host_mesh(model: Optional[int] = None) -> Optional[Mesh]:
    """A (data, model) mesh over the CUDA devices there are; ``None`` for
    one (or none), as the reference gives for one JAX device."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 1
    if n <= 1:
        return None
    model = model or (2 if n % 2 == 0 else 1)
    return make_mesh((n // model, model), ("data", "model"))


# Hardware constants of one NVIDIA H100 SXM5 80 GB at its 700 W limit (the
# NVIDIA H100 Tensor Core GPU datasheet), used by the roofline analysis.
PEAK_FLOPS_BF16 = 989e12          # dense bf16 tensor-core FLOP/s, datasheet
PEAK_FLOPS_F32 = 67e12            # float32 FLOP/s outside the tensor cores
HBM_BW = 3.35e12                  # HBM3 B/s, datasheet
HBM_BYTES = 80 * 10 ** 9          # 80 GB of HBM3, datasheet
NVLINK_BW = 450e9                 # NVLink 4 B/s per direction (900 GB/s
#                                   bidirectional), datasheet
