"""The step walker: flops, dot bytes, all-op bytes and collectives of one
eager step, counted as it runs (the port's counterpart of the
reference's HLO-text walker, ``repro/analysis/hlo_walk.py``).

The reference walks the optimized HLO text because
``compiled.cost_analysis()`` counts each ``while`` body once, which
undercounts a scan over layers by about the layer count.  The port has
no HLO: its step is eager PyTorch, and an eager step is unrolled, so
every layer and every loop iteration is an op that runs.  :func:`walk`
runs ``fn(*args)`` under a ``TorchDispatchMode`` and sees every aten op
that reaches the dispatcher (autograd's backward and remat's recompute
included), on whatever device the arguments are on; the dry run passes
prototypes on the ``meta`` device, so nothing is computed or allocated.

Per op:

- ``flops``: ``2 * M * N * K`` for the matmul ops (``mm``, ``addmm``,
  ``bmm``, ``baddbmm``: every ``einsum``, ``matmul`` and ``linear``
  lowers to them), attention's score and value products included, as
  the reference counts its ``dot`` ops and nothing else;
- ``dot_bytes``: a matmul's operand and result bytes;
- ``bytes``: every op that is not a view reads each input once and
  writes each output once (an expanded input counts its distinct
  elements).  An eager step is not fused, so this exceeds XLA's
  ``bytes accessed`` for the same function: it is what the port's step
  reads and writes.

Collectives come from what the step posts through LCX
(``core.ops.collective_tap``): kind, dtype, per-rank shape and group
size, priced with the reference's ring / all-to-all cost model
(:func:`repro_torch.analysis.roofline._wire`).  The collectives that
GSPMD inserts in the reference (resharding, the partial-softmax psums)
have no counterpart in a rank-stacked step, so ``coll_wire`` is a lower
bound of the reference's.

The step runs every rank stacked on one device, so the counts are sums
over ranks; ``walk(..., ranks=n)`` gives one device's share of them:

- an op outside a rank-stacked region counts ``1/n``, the share of a
  balanced partition;
- an op inside a region (``ranks.bind_axis``, the reference's
  ``shard_map``) counts ``1/m``, ``m`` the product of the bound axes'
  sizes (at most ``n``): each rank of them does its part, and every rank of the other
  mesh axes repeats it, as the reference's region replicates over the
  axes it does not name;
- a value a region hands out as replicated (``ranks.replicated``, the
  reference's psum over the bound axes) is held by every rank of them,
  so an op outside the region that reads it counts ``r/n``, ``r`` the
  product of the sizes of those axes that no sharded parameter the op
  reads splits (``shardings=``, the bundle's tree per argument): the
  output projection after the context-parallel decode attention runs on
  every ``model`` rank, as the reference's partitioner runs it.

The replication follows views and one-input ops (a dtype cast) of the
marked value and stops at any op that also reads an unmarked tensor.
"""
from __future__ import annotations

import dataclasses
import math
import weakref
from typing import (Any, Callable, Dict, FrozenSet, Iterator, List,
                    Optional, Sequence, Tuple)

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..core import ops as lcx_ops
from ..core import ranks as _ranks

_aten = torch.ops.aten
_MATMULS = {_aten.mm.default, _aten.addmm.default, _aten.bmm.default,
            _aten.baddbmm.default}
# ops that allocate and write nothing the step reads back as data
_NO_BYTES = {_aten.empty.memory_format, _aten.empty_strided.default,
             _aten.empty_like.default, _aten.new_empty.default,
             _aten.new_empty_strided.default}


def _distinct_bytes(t: torch.Tensor) -> int:
    """Bytes of the distinct elements a tensor addresses (an expanded
    dim, stride 0, holds one)."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size() if t.numel() else 0


def _tensors(items: Any) -> Iterator[torch.Tensor]:
    """The tensors among an op's arguments or results (one level of
    lists, as ``cat`` takes them)."""
    for x in items:
        if isinstance(x, torch.Tensor):
            yield x
        elif isinstance(x, (list, tuple)):
            for y in x:
                if isinstance(y, torch.Tensor):
                    yield y


_VIEWS: Dict[Any, bool] = {}


def _is_view(func: Any) -> bool:
    """An op whose result aliases an input without a write (a view)."""
    if func not in _VIEWS:
        _VIEWS[func] = any(r.alias_info is not None
                           and not r.alias_info.is_write
                           for r in func._schema.returns)
    return _VIEWS[func]


def _matmul_flops(func: Any, args: tuple, out: torch.Tensor) -> float:
    """2 * (result elements) * (contracted length)."""
    a = args[1] if func in (_aten.addmm.default,
                             _aten.baddbmm.default) else args[0]
    return 2.0 * out.numel() * a.shape[-1]


@dataclasses.dataclass
class WalkTotals:
    flops: float = 0.0
    dot_bytes: float = 0.0
    bytes: float = 0.0
    coll_wire: float = 0.0
    coll_by_kind: Dict[str, float] = dataclasses.field(default_factory=dict)
    n_coll: float = 0.0
    n_ops: int = 0
    # every LCX collective posted, one rank's view (``CollectiveOp``)
    collectives: List[Any] = dataclasses.field(default_factory=list)

    def scaled(self, factor: float) -> "WalkTotals":
        return dataclasses.replace(
            self, flops=self.flops * factor,
            dot_bytes=self.dot_bytes * factor, bytes=self.bytes * factor,
            coll_wire=self.coll_wire * factor,
            coll_by_kind={k: v * factor
                          for k, v in self.coll_by_kind.items()},
            n_coll=self.n_coll * factor)


class _Marks:
    """A value per tensor, keyed by identity, for tensors that stay
    alive: the args (held by the caller) and what the step makes."""

    def __init__(self) -> None:
        self._d: Dict[int, Tuple[Any, Any]] = {}

    def get(self, t: torch.Tensor, default: Any) -> Any:
        hit = self._d.get(id(t))
        return hit[1] if hit is not None and hit[0]() is t else default

    def set(self, t: torch.Tensor, value: Any) -> None:
        self._d[id(t)] = (weakref.ref(t), value)


def _spec_axes(sharding: Any) -> FrozenSet[str]:
    axes = set()
    for part in sharding.spec:
        if part is not None:
            axes.update((part,) if isinstance(part, str) else part)
    return frozenset(axes)


def _seed(marks: _Marks, arg: Any, sharding: Any) -> None:
    """Each tensor of ``arg`` gets the mesh axes its sharding splits."""
    if isinstance(arg, torch.Tensor):
        marks.set(arg, _spec_axes(sharding))
    elif isinstance(arg, dict):
        for k in arg:
            _seed(marks, arg[k], sharding[k])
    elif isinstance(arg, (list, tuple)):
        # ``params["stack"]``'s periods share one tree (its leaves'
        # specs lead with the replicated "layers" dim)
        per = (sharding if isinstance(sharding, (list, tuple))
               else [sharding] * len(arg))
        for a, s in zip(arg, per):
            _seed(marks, a, s)
    elif dataclasses.is_dataclass(arg):
        for f in dataclasses.fields(arg):
            _seed(marks, getattr(arg, f.name), getattr(sharding, f.name))


_NONE: FrozenSet[Any] = frozenset()


class _Counter(TorchDispatchMode):
    def __init__(self, totals: WalkTotals, n_ranks: int) -> None:
        super().__init__()
        self.totals = totals
        self.n_ranks = n_ranks
        self.axes = _Marks()        # mesh axes a (sharded) param splits
        self.rep = _Marks()         # (axis, size) pairs a value is held on

    def _share(self, ins: List[torch.Tensor]) -> float:
        """One device's share of this op (module docstring)."""
        bound = _ranks.bound_sizes()
        if bound:
            return 1.0 / min(self.n_ranks, math.prod(bound.values()))
        rep = set().union(*(self.rep.get(x, _NONE) for x in ins))
        split = set().union(*(self.axes.get(x, _NONE) for x in ins))
        r = math.prod(n for a, n in rep if a not in split)
        return min(1.0, r / self.n_ranks)

    def _propagate(self, func: Any, ins: List[torch.Tensor],
                   outs: List[torch.Tensor]) -> None:
        if len(ins) == 1 or (_is_view(func) and ins):
            axes = self.axes.get(ins[0], None)
            rep = self.rep.get(ins[0], None)
        else:
            axes = None
            reps = [self.rep.get(x, _NONE) for x in ins]
            rep = frozenset.intersection(*reps) if reps else None
        for o in outs:
            if axes:
                self.axes.set(o, axes)
            if rep:
                self.rep.set(o, rep)

    def mark_replicated(self, t: torch.Tensor, bound: Dict[str, int]
                        ) -> None:
        self.rep.set(t, frozenset(bound.items()))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        t = self.totals
        t.n_ops += 1
        ins = list(_tensors(args))
        if kwargs:
            ins += list(_tensors(kwargs.values()))
        outs = list(_tensors(out if isinstance(out, (list, tuple))
                             else (out,)))
        self._propagate(func, ins, outs)
        if func in _NO_BYTES or _is_view(func):
            return out
        share = self._share(ins)
        moved = sum(_distinct_bytes(x) for x in ins + outs) * share
        t.bytes += moved
        if func in _MATMULS:
            t.flops += _matmul_flops(func, args, out) * share
            t.dot_bytes += moved
        return out


def _on_collective(totals: WalkTotals, kind: str, dtype: torch.dtype,
                   shape: tuple, group: int, n_groups: int) -> None:
    """One LCX collective over ``n_groups`` groups of ``group`` ranks,
    each rank holding ``shape`` of ``dtype`` (for an all-gather, its
    gathered output): the wire bytes of every participating rank."""
    from .roofline import CollectiveOp, _wire
    nbytes = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
    op = CollectiveOp(kind=kind, dtype=str(dtype)[6:], shape=tuple(shape),
                      bytes=nbytes, group=group,
                      wire_bytes=_wire(kind, nbytes, group))
    totals.collectives.append(op)
    wire = op.wire_bytes * group * n_groups
    totals.coll_wire += wire
    totals.coll_by_kind[kind] = totals.coll_by_kind.get(kind, 0.0) + wire
    totals.n_coll += group * n_groups


def walk(fn: Callable[..., Any], *args: Any, ranks: int = 1,
         shardings: Optional[Sequence[Any]] = None) -> WalkTotals:
    """Run ``fn(*args)`` once and count one device's share of it, the
    step stacking ``ranks`` ranks on its device (module docstring);
    ``shardings`` is a sharding tree per argument."""
    totals = WalkTotals()
    counter = _Counter(totals, ranks)
    for arg, sharding in zip(args, shardings or ()):
        _seed(counter.axes, arg, sharding)
    tap = lambda *a: _on_collective(totals, *a)  # noqa: E731
    _ranks._REPLICATED_TAPS.append(counter.mark_replicated)
    try:
        with lcx_ops.collective_tap(tap), counter:
            fn(*args)
    finally:
        _ranks._REPLICATED_TAPS.remove(counter.mark_replicated)
    if ranks == 1:
        return totals
    per = totals.scaled(1.0 / ranks)     # the collectives: one rank's
    return dataclasses.replace(per, flops=totals.flops,
                               dot_bytes=totals.dot_bytes,
                               bytes=totals.bytes)
