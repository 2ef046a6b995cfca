"""Collectives built on LCX point-to-point operations.

The port of ``repro/core/collectives.py``.  LCI's position is that AMT
communication is point-to-point; collectives are *library-level*
compositions over p2p (the way RCCL/UCC build them over verbs).  The
ring algorithms make every step an LCX ``put`` with an explicit
``progress()``, and the ``native`` backends compute the same function
directly with tensor ops along the rank dimension, so the two can be
compared.

Rank model (:mod:`repro_torch.core.ranks`): ``x`` is rank-stacked,
``[n_ranks, *s]`` where the reference sees one rank's ``s``, and the
device's axis must be bound (``ranks.bind_axis`` or a ``mesh_shape``
attribute).  A rank's own index is the row number, so the reference's
``lax.axis_index`` arithmetic becomes indexing with ``arange(n)``.  The
``native`` sums (``psum``) reduce over dim 0 in ``x``'s dtype, in
torch's order, which is not XLA's: they may differ from the reference's
in the last bits.  On one card all ranks share one stream, so
:func:`barrier` has nothing to wait for beyond checking the axis.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
import torch.nn.functional as F

from .flex import FlexOp, plain
from .resources import (Device, Endpoint, Perm, Runtime, Synchronizer,
                        resolve_resources)
from . import ops as lcx_ops


def _resolve_dev(op: FlexOp) -> tuple:
    """(runtime, device) for a collective op, resolved through the same
    endpoint -> device -> runtime-defaults path as the posting ops."""
    res = resolve_resources(runtime=op.arg_or("runtime", None),
                            endpoint=op.arg_or("endpoint", None),
                            device=op.arg_or("device", None))
    return res.runtime, res.device


def _axis_of(dev: Device) -> str:
    if dev.axis is None:
        raise ValueError("collective needs a device bound to a mesh axis")
    return dev.axis


def _stacked(x: torch.Tensor, dev: Device) -> int:
    """The axis size, after checking that ``x`` has one row per rank."""
    n = dev.axis_size
    if x.dim() == 0 or x.shape[0] != n:
        raise ValueError(
            f"rank-stacked input has shape {tuple(x.shape)}, axis "
            f"{dev.axis!r} has {n} ranks")
    return n


def _ranks(n: int, x: torch.Tensor) -> torch.Tensor:
    """Every rank's own index, on ``x``'s device."""
    return torch.arange(n, device=x.device)


def _psum(x: torch.Tensor) -> torch.Tensor:
    """``lax.psum`` over the rank dimension: every row gets the sum."""
    return x.sum(0, keepdim=True, dtype=x.dtype).expand_as(x).contiguous()


def _lcx_shift(x: Any, k: int, rt: Runtime, device: Device, tag: int) -> Any:
    """One ring hop expressed as an LCX put + progress + completion."""
    sync = Synchronizer(threshold=1)
    lcx_ops.put_x(x).perm(Perm.shift(k)).tag(tag).remote_comp(sync) \
        .runtime(rt).device(device)()
    lcx_ops.progress_x().runtime(rt).device(device)()
    (ev,) = sync.wait()
    return ev.payload


# ---------------------------------------------------------------------------
# all-gather (ring)
# ---------------------------------------------------------------------------
class all_gather_x(FlexOp):
    """Gather each rank's ``x`` along a new leading axis (then merged into
    the rank's dim 0 when ``tiled``), ring or native backend:
    ``[n, *s] -> [n, n, *s]`` or ``[n, n * s0, *s[1:]]``."""

    _positional = ("x",)
    _optional = dict(device=None, runtime=None, endpoint=None,
                     backend="ring", tiled=True, tag=0)

    def _invoke(self) -> Any:
        x = self.arg("x")
        rt, dev = _resolve_dev(self)
        _axis_of(dev)
        n = _stacked(x, dev)
        tiled = self.arg_or("tiled", True)
        if self.arg_or("backend", "ring") == "native":
            if tiled and x.dim() == 1:
                raise ValueError("axis 0 is out of bounds for array of "
                                 "dimension 0")
            buf = x.unsqueeze(0).expand((n,) + tuple(x.shape)).contiguous()
        else:
            rows = _ranks(n, x)
            buf = x.new_zeros((n, n) + tuple(x.shape[1:]))
            buf[rows, rows] = x
            cur = x
            for step in range(n - 1):
                cur = _lcx_shift(cur, 1, rt, dev, self.arg_or("tag", 0))
                buf[rows, (rows - step - 1) % n] = cur
        if tiled and x.dim() > 1:
            return buf.reshape((n, n * x.shape[1]) + tuple(x.shape[2:]))
        return buf


# ---------------------------------------------------------------------------
# reduce-scatter (ring)
# ---------------------------------------------------------------------------
class reduce_scatter_x(FlexOp):
    """Sum-reduce ``x`` across the axis, leaving each rank with its
    1/N slice of dim 0: ``[n, s0, *s] -> [n, s0 / n, *s]``."""

    _positional = ("x",)
    _optional = dict(device=None, runtime=None, endpoint=None,
                     backend="ring", tag=0)

    def _invoke(self) -> Any:
        x = self.arg("x")
        rt, dev = _resolve_dev(self)
        _axis_of(dev)
        n = _stacked(x, dev)
        if x.shape[1] % n:
            raise ValueError(f"reduce_scatter dim0 {x.shape[1]} % {n}")
        rest = tuple(x.shape[2:])
        if self.arg_or("backend", "ring") == "native":
            return x.sum(0, dtype=x.dtype).reshape(
                (n, x.shape[1] // n) + rest)
        rows = _ranks(n, x)
        chunks = x.reshape((n, n, x.shape[1] // n) + rest)
        # The accumulator carrying chunk c starts at rank c+1 and moves +1
        # per hop; after n-1 hops it has visited every rank and lands at
        # rank c.  So rank i seeds with its local chunk (i-1) and, at hop
        # s (1-indexed), the arriving accumulator carries chunk (i-s-1),
        # to which we add our local copy.
        acc = chunks[rows, (rows - 1) % n]
        for step in range(n - 1):
            acc = _lcx_shift(acc, 1, rt, dev, self.arg_or("tag", 0))
            acc = acc + chunks[rows, (rows - step - 2) % n]
        return acc


# ---------------------------------------------------------------------------
# all-reduce = reduce-scatter + all-gather (ring) or native psum
# ---------------------------------------------------------------------------
class all_reduce_x(FlexOp):
    _positional = ("x",)
    _optional = dict(device=None, runtime=None, endpoint=None,
                     backend="ring", tag=0)

    def _invoke(self) -> Any:
        x = self.arg("x")
        rt, dev = _resolve_dev(self)
        _axis_of(dev)
        n = _stacked(x, dev)
        backend = self.arg_or("backend", "ring")
        if backend == "native":
            return _psum(x)
        flat = x.reshape(n, -1)
        pad = (-flat.shape[1]) % n
        if pad:
            flat = F.pad(flat, (0, pad))
        rs = reduce_scatter_x(flat).runtime(rt).device(dev) \
            .backend(backend).tag(self.arg_or("tag", 0))()
        ag = all_gather_x(rs).runtime(rt).device(dev).backend(backend) \
            .tag(self.arg_or("tag", 0) + 1)()
        if pad:
            ag = ag[:, :-pad]
        return ag.reshape(x.shape)


# ---------------------------------------------------------------------------
# all-to-all (pairwise LCX puts or native)
# ---------------------------------------------------------------------------
class all_to_all_x(FlexOp):
    """Exchange chunk i of dim 0 with rank i.  A rank's dim 0 must equal
    the axis size times the chunk size; the pairwise backend posts n-1
    LCX puts."""

    _positional = ("x",)
    _optional = dict(device=None, runtime=None, endpoint=None,
                     backend="pairwise", tag=0)

    def _invoke(self) -> Any:
        x = self.arg("x")
        rt, dev = _resolve_dev(self)
        _axis_of(dev)
        n = _stacked(x, dev)
        if x.shape[1] % n:
            raise ValueError(f"all_to_all dim0 {x.shape[1]} % {n}")
        chunks = x.reshape((n, n, x.shape[1] // n) + tuple(x.shape[2:]))
        if self.arg_or("backend", "pairwise") == "native":
            return chunks.transpose(0, 1).reshape(x.shape)
        rows = _ranks(n, x)
        out = torch.zeros_like(chunks)
        out[rows, rows] = chunks[rows, rows]
        for k in range(1, n):
            # send the chunk destined for rank (i+k); receive from (i-k)
            piece = chunks[rows, (rows + k) % n]
            got = _lcx_shift(piece, k, rt, dev, self.arg_or("tag", 0) + k)
            out[rows, (rows - k) % n] = got
        return out.reshape(x.shape)


class broadcast_x(FlexOp):
    """Broadcast from ``root`` (native masked psum)."""

    _positional = ("x",)
    _optional = dict(device=None, runtime=None, endpoint=None, root=0)

    def _invoke(self) -> Any:
        x = self.arg("x")
        _, dev = _resolve_dev(self)
        _axis_of(dev)
        n = _stacked(x, dev)
        mask = (_ranks(n, x) == self.arg_or("root", 0)).to(x.dtype)
        return _psum(x * mask.reshape((n,) + (1,) * (x.dim() - 1)))


def barrier(device: Optional[Device] = None,
            runtime: Optional[Runtime] = None,
            endpoint: Optional[Endpoint] = None) -> None:
    res = resolve_resources(runtime=runtime, endpoint=endpoint, device=device)
    dev = res.device
    if dev is not None and dev.axis is not None:
        dev.axis_size           # raises when the axis is not bound


all_gather = plain(all_gather_x)
reduce_scatter = plain(reduce_scatter_x)
all_reduce = plain(all_reduce_x)
all_to_all = plain(all_to_all_x)
broadcast = plain(broadcast_x)
