"""Logical-axis sharding: names -> mesh axes (the port of
``repro/parallel/sharding.py``).

Every parameter and activation carries a tuple of *logical dimension
names* (``models.model.abstract_init`` gives the params' dims); this
module resolves them to :class:`PartitionSpec` s against the active mesh
with a rule table.  Rules are applied left to right per tensor with two
filters:

- an axis already claimed by an earlier dim of the same tensor is
  skipped (a mesh axis is used at most once in a spec);
- an axis (or axis-tuple prefix) whose size does not divide the dim is
  skipped (8 KV heads cannot shard 16 ways, so they stay replicated).

The default rules are **FSDP (ZeRO-3) x TP/EP**: ``embed`` (the
contracting dim of most weights) over the data axes, head / FFN / expert
/ vocab dims over ``model``, ``batch`` over (pod, data).

A mesh here is names and sizes with no devices (:class:`Mesh`): every
rank lives on the one card (``parallel/__init__.py``).  The specs are
the reference's, tuple for tuple, but automatic sharding changes layout,
not values, so :func:`constrain` returns its input unchanged and a
:class:`NamedSharding` is data that the mesh paths and the trainer read.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Iterator, Optional, Sequence, Tuple

import torch

from ..core import ranks

Rules = Dict[str, Tuple[str, ...]]


class Mesh:
    """Named mesh axes and their sizes, as the reference reads a
    ``jax.sharding.Mesh``: ``mesh.shape[a]`` (an ordered dict of name to
    size) and ``mesh.axis_names``.  It holds no devices."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        if len(shape) != len(axis_names):
            raise ValueError(f"shape {tuple(shape)} and axes "
                             f"{tuple(axis_names)} differ in length")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"repeated mesh axis in {tuple(axis_names)}")
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        self.shape: Dict[str, int] = {a: int(n) for a, n in
                                      zip(axis_names, shape)}

    @property
    def size(self) -> int:
        n = 1
        for s in self.shape.values():
            n *= s
        return n

    def __eq__(self, other: Any) -> bool:
        return (isinstance(other, Mesh) and other.axis_names ==
                self.axis_names and other.shape == self.shape)

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"


class PartitionSpec(tuple):
    """One entry per tensor dim: a mesh axis name, a tuple of them, or
    ``None`` (replicated); a tuple, so it compares with the reference's
    ``PartitionSpec`` as one."""

    def __new__(cls, *parts: Any) -> "PartitionSpec":
        return super().__new__(cls, parts)


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: the layout of a tensor over the mesh's ranks."""
    mesh: Mesh
    spec: PartitionSpec


def abstract_mesh(shape: Sequence[int], axes: Sequence[str]) -> Mesh:
    return Mesh(shape, axes)


# logical dim -> preferred mesh axes (tried in order, prefix-divisible)
DEFAULT_RULES: Rules = {
    # activations: the model axis carries sequence parallelism for the
    # mixers and tensor parallelism for FFN / vocab; "attn_chunks" is the
    # chunk-stack dim of the blocked attention layout
    "batch": ("pod", "data"),
    "seq": ("model",),
    "attn_chunks": ("model",),
    "vocab": ("model",),
    "q_heads": (),
    "ssm_act_heads": (),
    # params: FSDP on the embed / contracting dim, TP on the feature dim
    "embed": ("data",),
    "embed_out": (),
    "mlp": ("model",),
    "q_proj": (),
    "kv_proj": (),
    "router": (),
    "experts": ("model",),
    "moe_mlp": (),
    "q_lora": ("model",),
    "kv_lora": (),
    "layers": (),                # the periodic stack's leading dim
    # ssm
    "ssm_in": ("model",),
    "ssm_inner": ("model",),
    "ssm_conv_ch": ("model",),
    "ssm_heads": ("model",),
    "conv_k": (),
    "state": (),
    "head": (),
    # kv-cache
    "cache_batch": ("pod", "data"),
    "cache_seq": (),
    "kv_heads": ("model",),
}

_ACTIVE: Dict[str, Any] = {"mesh": None, "rules": dict(DEFAULT_RULES)}


def set_active_mesh(mesh: Optional[Mesh],
                    rules: Optional[Rules] = None) -> None:
    _ACTIVE["mesh"] = mesh
    if rules is not None:
        _ACTIVE["rules"] = {**DEFAULT_RULES, **rules}


def set_rules(rules: Rules) -> None:
    _ACTIVE["rules"] = {**DEFAULT_RULES, **rules}


def active_mesh() -> Optional[Mesh]:
    return _ACTIVE["mesh"]


def active_rules() -> Rules:
    return _ACTIVE["rules"]


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh],
             rules: Optional[Rules] = None) -> Iterator[None]:
    prev = dict(_ACTIVE)
    set_active_mesh(mesh, rules)
    try:
        yield
    finally:
        _ACTIVE.update(prev)


def dp_axes(mesh: Mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def ep_axis_name() -> str:
    return "model"


# ---------------------------------------------------------------------------
# spec resolution
# ---------------------------------------------------------------------------
def _bound_axis_names() -> frozenset:
    """Mesh axes bound by ``ranks.bind_axis``: inside a rank-stacked
    region the data along them is already split, so rule resolution
    skips them (the reference skips the axes manual in its trace)."""
    return ranks.bound_names()


def _axes_for(dim: Optional[str], size: Optional[int], mesh: Mesh,
              used: set, rules: Rules) -> Optional[Tuple[str, ...]]:
    if dim is None:
        return None
    chosen = []
    prod = 1
    for ax in rules.get(dim, ()):
        if ax not in mesh.shape or ax in used:
            continue
        nxt = prod * mesh.shape[ax]
        if size is not None and size % nxt != 0:
            break
        chosen.append(ax)
        prod = nxt
    if not chosen:
        return None
    used.update(chosen)
    return tuple(chosen)


def logical_spec(dims: Sequence[Optional[str]],
                 shape: Optional[Sequence[int]] = None,
                 mesh: Optional[Mesh] = None,
                 rules: Optional[Rules] = None) -> PartitionSpec:
    mesh = mesh or active_mesh()
    rules = rules or active_rules()
    if mesh is None:
        return P()
    used: set = set(_bound_axis_names())
    parts = []
    for i, d in enumerate(dims):
        size = None if shape is None else int(shape[i])
        axes = _axes_for(d, size, mesh, used, rules)
        parts.append(None if axes is None
                     else (axes[0] if len(axes) == 1 else axes))
    while parts and parts[-1] is None:
        parts.pop()
    return P(*parts)


def constrain(x: torch.Tensor, dims: Sequence[Optional[str]]
              ) -> torch.Tensor:
    """The reference's sharding constraint: a layout hint for its
    compiler.  Every rank of the port's mesh is on one card, so there is
    no layout to pin: ``x`` is returned as it is."""
    return x


def _leaf_shape(t: Any) -> Tuple[int, ...]:
    """The shape of a params leaf; a list of tensors (the port's
    ``params["stack"]``, one per period) is one leaf stacked along a
    leading dim, as the reference holds it."""
    if isinstance(t, list):
        return (len(t),) + tuple(_leaf_shape(t[0]))
    return tuple(t.shape)


def _periods_as_leaves(tree: Any) -> Any:
    """A list of same-structured nests (``params["stack"]``) as one nest
    whose leaves are lists of the periods' tensors."""
    if isinstance(tree, dict):
        return {k: _periods_as_leaves(v) for k, v in tree.items()}
    if isinstance(tree, list) and tree and isinstance(tree[0], dict):
        return {k: _periods_as_leaves([t[k] for t in tree])
                for k in tree[0]}
    return tree


def param_shardings(dims_tree: Any, params_tree: Any = None,
                    mesh: Optional[Mesh] = None,
                    rules: Optional[Rules] = None) -> Any:
    """Map a dims tree (leaves: tuples of logical names) to
    :class:`NamedSharding` s, mirroring the dims tree.  ``params_tree``
    supplies shapes for the divisibility checks; the port's
    ``params["stack"]`` (a list of periods) counts as one stacked leaf."""
    mesh = mesh or active_mesh()
    shapes = None if params_tree is None else _periods_as_leaves(params_tree)

    def walk(d: Any, p: Any) -> Any:
        if isinstance(d, tuple):
            shape = None if p is None else _leaf_shape(p)
            return NamedSharding(mesh, logical_spec(d, shape, mesh, rules))
        return {k: walk(v, None if p is None else p[k])
                for k, v in d.items()}

    return walk(dims_tree, shapes)
