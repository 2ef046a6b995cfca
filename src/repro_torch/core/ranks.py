"""The rank model: many ranks as one rank-stacked tensor on one device.

The reference posts LCX operations inside ``jax.vmap(..., axis_name=a)``
or ``shard_map``, where a named axis is bound and every value is one
rank's slice.  The port has no bound-axis SPMD.  Instead every per-rank
value carries a leading ``[n_ranks]`` dimension, the LCX engine's Python
state runs once for all ranks (as it runs once per trace in the
reference), and a transfer is a permutation along dim 0.

``bind_axis(a, n)`` plays the part of the bound axis: inside it,
``Device(axis=a).axis_size`` is ``n`` without a ``mesh_shape`` attribute.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Iterator, List, Sequence, Tuple

import torch

_BOUND = threading.local()


def _stack() -> List[Tuple[str, int]]:
    if not hasattr(_BOUND, "axes"):
        _BOUND.axes = []
    return _BOUND.axes


@contextlib.contextmanager
def bind_axis(name: str, size: int) -> Iterator[None]:
    """Bind axis ``name`` to ``size`` ranks for this thread."""
    if size < 1:
        raise ValueError(f"axis {name!r} needs at least one rank, got {size}")
    _stack().append((name, int(size)))
    try:
        yield
    finally:
        _stack().pop()


def axis_size(name: str) -> int:
    """Size of the innermost binding of ``name``; NameError when unbound
    (as ``jax.lax.axis_size`` raises for an unbound axis name)."""
    for bound, size in reversed(_stack()):
        if bound == name:
            return size
    raise NameError(f"unbound axis name: {name}")


def bound_names() -> frozenset:
    """Names of the axes bound on this thread (the reference's axis env
    inside a ``shard_map`` / ``vmap`` region)."""
    return frozenset(name for name, _ in _stack())


def permute(value: torch.Tensor, pairs: Sequence[Tuple[int, int]]
            ) -> torch.Tensor:
    """``lax.ppermute`` on a rank-stacked tensor: rank ``dst`` receives
    rank ``src``'s slice for each ``(src, dst)``; ranks that receive
    nothing get zeros."""
    n = value.shape[0]
    src = torch.zeros(n, dtype=torch.long)
    received = torch.zeros(n, dtype=torch.bool)
    for s, d in pairs:
        src[d] = s
        received[d] = True
    out = value.index_select(0, src.to(value.device))
    if not bool(received.all()):
        keep = received.to(value.device).reshape(
            (n,) + (1,) * (value.dim() - 1))
        out = torch.where(keep, out, torch.zeros((), dtype=out.dtype,
                                                  device=out.device))
    return out
