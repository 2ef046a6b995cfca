"""Gradient compression: int8 quantisation with error feedback.

The port of ``repro/optim/compression.py``: :func:`compress_int8` /
:func:`decompress_int8`; :func:`compressed_psum`, a data-parallel
all-reduce in int8 over a bound axis of rank-stacked gradients (a shared
per-tensor scale, an int32 sum, 4x fewer bytes on the wire than f32);
and :class:`CompressedAccumulator`, the int8 + error-feedback gradient
accumulator of microbatched training (1 byte a parameter for the
accumulated sum, the quantisation error carried in f32 to the next
microbatch so that it cancels instead of biasing).
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from ..core import ranks
from ..models.common import PyTree, tree_map

INT8_MAX = 127.0


def compress_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (q int8, scale f32 scalar).  ``torch.round`` rounds half to
    even, as ``jnp.round`` does."""
    xf = x.float()
    scale = torch.clamp(torch.max(torch.abs(xf)) / INT8_MAX, min=1e-30)
    q = torch.clamp(torch.round(xf / scale), -INT8_MAX, INT8_MAX)
    return q.to(torch.int8), scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def compressed_psum(x: torch.Tensor, axis: str,
                    err: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """All-reduce the rank-stacked ``x [n, ...]`` over the bound ``axis``
    in int8 -> (the mean on every rank [n, ...], each rank's new
    error-feedback residual [n, ...] f32).  The scale is shared: the max
    of |x| over all ranks, so the int32 sum cannot overflow."""
    n = ranks.axis_size(axis)
    if x.shape[0] != n:
        raise ValueError(f"rank-stacked x has {x.shape[0]} ranks on dim 0, "
                         f"axis {axis!r} has {n}")
    xf = x.float()
    if err is not None:
        xf = xf + err
    scale = torch.clamp(torch.max(torch.abs(xf)) / INT8_MAX, min=1e-30)
    q = torch.clamp(torch.round(xf / scale), -INT8_MAX, INT8_MAX)
    new_err = xf - q * scale                       # each rank's residual
    total = q.to(torch.int32).sum(0, dtype=torch.int32)
    out = (total.float() * scale / n).to(x.dtype)
    return out.expand_as(x), new_err


def _is_acc(t: Any) -> bool:
    return isinstance(t, dict) and "q" in t


class CompressedAccumulator:
    """int8 + error-feedback microbatch gradient accumulator (functional:
    all state is returned)."""

    @staticmethod
    def init(params: PyTree) -> PyTree:
        return tree_map(
            lambda p: {"q": torch.zeros(p.shape, dtype=torch.int8,
                                        device=p.device),
                       "scale": torch.zeros((), dtype=torch.float32,
                                            device=p.device),
                       "err": torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device)}, params)

    @staticmethod
    def add(acc: PyTree, grads: PyTree) -> PyTree:
        def one(a, g):
            cur = a["q"].float() * a["scale"] + a["err"]
            tot = cur + g.float()
            q, scale = compress_int8(tot)
            err = tot - q.float() * scale
            return {"q": q, "scale": scale, "err": err}
        return tree_map(one, acc, grads, is_leaf=_is_acc)

    @staticmethod
    def value(acc: PyTree, count: int) -> PyTree:
        return tree_map(lambda a: (a["q"].float() * a["scale"] + a["err"])
                        / count, acc, is_leaf=_is_acc)
