"""Roofline analysis of a counted dry-run step (the port of
``repro/analysis/roofline.py``).

Per (arch x shape x mesh) three per-device time terms, on one H100's
constants (``launch/mesh.py``):

    compute    = flops / PEAK_FLOPS_BF16          (989e12, dense bf16)
    memory     = bytes / HBM_BW                   (3.35e12 B/s)
    collective = wire_bytes / NVLINK_BW           (450e9 B/s a direction)

``flops`` and ``bytes`` come from :func:`.hlo_walk.walk` of the eager
step on ``meta`` (every layer and loop iteration, as it runs), divided
by the ranks it stacks: the share of a balanced partition.  ``bytes``
keeps the reference's ``max(dot_bytes, all-op bytes)``; an eager step
is not fused, so its all-op bytes are what it reads and writes, more
than XLA's ``bytes accessed``.  ``wire_bytes`` prices what the step
posts through LCX with the reference's cost models (:func:`_wire`):

    all-gather      out_bytes x (g-1)/g
    reduce-scatter  in_bytes  x (g-1)/g
    all-reduce      2 x bytes x (g-1)/g
    all-to-all      bytes x (g-1)/g
    collective-permute  bytes

The reference parses these from the optimized HLO
(``parse_collectives``, ``collective_bytes``), GSPMD's implicit
collectives among them; the port has no HLO and a rank-stacked step
posts no implicit collective, so the term counts LCX's collectives only
and the report marks it as a lower bound
(``collective_is_lower_bound``).

``model_flops`` is the useful-work yardstick, with the reference's
counting rule as it is: embeddings are left out of the 6·N·D
convention, and of the routed experts only top-k of E count as active.
Leaves are named as the reference names them
(``models.common.keyed_leaves``), so a params nest on the ``meta``
device (``models.abstract_init``) counts as the reference's
``jax.eval_shape`` proto does.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Tuple

import torch

from ..launch.mesh import HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16
from ..models.common import keyed_leaves, tree_leaves
from ..parallel.sharding import NamedSharding
from .hlo_walk import WalkTotals, walk


@dataclasses.dataclass
class CollectiveOp:
    kind: str
    dtype: str
    shape: Tuple[int, ...]
    bytes: int           # tensor bytes (per device output/input)
    group: int           # replica group size
    wire_bytes: float    # estimated bytes over the links per device


def _wire(kind: str, nbytes: int, g: int) -> float:
    if g <= 1:
        return 0.0
    frac = (g - 1) / g
    kind = kind.lower()
    if kind == "all-gather":
        return nbytes * frac            # nbytes = gathered (output) size
    if kind == "reduce-scatter":
        return nbytes * frac            # nbytes = input size (per device)
    if kind == "all-reduce":
        return 2.0 * nbytes * frac
    if kind == "all-to-all":
        return nbytes * frac
    if kind == "collective-permute":
        return float(nbytes)
    return float(nbytes)


def active_params(cfg: Any, params_proto: Any) -> Tuple[int, int]:
    """(total, active-per-token) parameter counts, embeddings excluded
    from the 6ND convention."""
    total = 0
    active = 0
    for name, leaf in keyed_leaves(params_proto):
        parts = leaf if isinstance(leaf, list) else [leaf]
        n = sum(t.numel() for t in parts)
        total += n
        if "embed" in name or "head" in name and "['head']" in name:
            continue
        if "ffn" in name and ("w_gate" in name or "w_up" in name
                              or "w_down" in name):
            # routed experts: only top-k of E active
            if cfg.n_experts:
                active += n * cfg.n_experts_per_tok // cfg.n_experts
            else:
                active += n
        else:
            active += n
    return total, active


def model_flops(cfg: Any, params_proto: Any, kind: str, seq_len: int,
                global_batch: int) -> float:
    """6·N_active·D for train, 2·N_active·D for inference (global)."""
    _, n_active = active_params(cfg, params_proto)
    if kind == "train":
        tokens = seq_len * global_batch
        return 6.0 * n_active * tokens
    if kind == "prefill":
        tokens = seq_len * global_batch
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * global_batch


# ---------------------------------------------------------------------------
# report
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float            # per device: the counted step's flops
    hlo_bytes: float            # per device
    wire_bytes: float           # per device, LCX's collectives only
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops_global: float
    useful_ratio: float         # model_flops / (hlo_flops * chips)
    roofline_frac: float        # max-term lower bound vs dominant
    n_collectives: int
    collectives_by_kind: Dict[str, float]
    memory_analysis: Dict[str, float]
    collective_is_lower_bound: bool = True

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def summary(self) -> str:
        return (f"{self.arch:28s} {self.shape:12s} {self.mesh:9s} "
                f"compute={self.compute_s*1e3:9.3f}ms "
                f"memory={self.memory_s*1e3:9.3f}ms "
                f"coll>={self.collective_s*1e3:9.3f}ms "
                f"bound={self.bottleneck:10s} "
                f"useful={self.useful_ratio:6.3f} "
                f"frac={self.roofline_frac:5.3f}")


def _shards(sharding: Any) -> int:
    """Devices a tensor is split over under ``sharding`` (1 for a
    replicated one or no mesh)."""
    if sharding is None or sharding.mesh is None:
        return 1
    n = 1
    for part in sharding.spec:
        for ax in ((part,) if isinstance(part, str) else part or ()):
            n *= sharding.mesh.shape[ax]
    return n


def _tensor_bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _sharded_bytes(tree: Any, shardings: Any) -> int:
    """Per-device bytes of ``tree`` under the mirroring ``shardings``
    tree (a ``NamedSharding`` leaf may stand for a whole subtree, and
    the port's ``params["stack"]``, a list of periods, for one stacked
    leaf).  Exact: the rules split a dim only over axes that divide
    it."""
    if isinstance(shardings, NamedSharding) or shardings is None:
        return sum(_tensor_bytes(t) for t in tree_leaves(tree)) \
            // _shards(shardings)
    if isinstance(tree, list):
        return sum(_sharded_bytes(t, shardings) for t in tree)
    if dataclasses.is_dataclass(tree):
        return sum(_sharded_bytes(getattr(tree, f.name),
                                  getattr(shardings, f.name))
                   for f in dataclasses.fields(tree))
    return sum(_sharded_bytes(tree[k], shardings[k]) for k in tree)


@dataclasses.dataclass
class CountedStep:
    """One step run once on its prototypes and counted: the port's
    stand-in for the reference's compiled executable.
    ``t_build_s`` is the time to build the bundle, ``t_count_s`` the
    time of the counted meta run."""
    totals: WalkTotals            # per device
    argument_bytes: int           # per device
    output_bytes: int             # per device
    t_build_s: float = 0.0
    t_count_s: float = 0.0

    def memory_analysis(self) -> Dict[str, float]:
        """``argument_size_in_bytes`` and ``output_size_in_bytes`` per
        device, exactly, from the shardings.  No peak: an eager step's
        temporaries are freed as their last use ends, which a meta run
        does not report, and no number is given in its place."""
        return {"argument_size_in_bytes": float(self.argument_bytes),
                "output_size_in_bytes": float(self.output_bytes)}


def _output_bytes(bundle: Any, out: Any) -> int:
    """Per-device bytes of the step's outputs: the donated arguments
    (params and optimizer state, the caches) come back with their
    argument's sharding; the logits [B, S', V] take ("batch", None,
    "vocab") through the rules, and the train metrics are replicated
    scalars."""
    from ..parallel.sharding import logical_spec, use_mesh
    mesh = bundle.mesh
    if isinstance(out, tuple) and len(out) == 3:            # train
        params, opt, metrics = out
        return (_sharded_bytes(params, bundle.shardings[0])
                + _sharded_bytes(opt, bundle.shardings[1])
                + sum(_tensor_bytes(t) for t in metrics.values()))
    logits, caches = (out, None) if isinstance(out, torch.Tensor) else out
    with use_mesh(mesh, bundle.rules):
        spec = logical_spec(("batch", None, "vocab"), tuple(logits.shape),
                            mesh)
    total = _tensor_bytes(logits) // _shards(NamedSharding(mesh, spec))
    if caches is not None:
        total += _sharded_bytes(caches, bundle.shardings[bundle.donate[0]])
    return total


def count_step(bundle: Any, t_build_s: float = 0.0) -> CountedStep:
    """Run ``bundle.fn`` once on its prototypes under the walker and
    size its arguments and outputs per device."""
    ranks = bundle.mesh.size if bundle.mesh is not None else 1
    box: Dict[str, Any] = {}

    def run(*args):
        box["out"] = bundle.fn(*args)

    t0 = time.perf_counter()
    totals = walk(run, *bundle.args, ranks=ranks,
                  shardings=bundle.shardings)
    t_count = time.perf_counter() - t0
    args = sum(_sharded_bytes(a, s)
               for a, s in zip(bundle.args, bundle.shardings))
    return CountedStep(totals=totals, argument_bytes=args,
                       output_bytes=_output_bytes(bundle, box["out"]),
                       t_build_s=t_build_s, t_count_s=t_count)


def analyze_compiled(compiled: CountedStep, *, arch: str, shape: str,
                     mesh_name: str, chips: int, cfg: Any = None,
                     params_proto: Any = None, kind: str = "train",
                     seq_len: int = 0, global_batch: int = 0
                     ) -> RooflineReport:
    """The reference's ``analyze_compiled`` on a :class:`CountedStep`
    (what :func:`count_step` gives) in place of a compiled
    executable."""
    totals = compiled.totals
    flops = totals.flops
    nbytes = max(totals.dot_bytes, totals.bytes)
    wire = totals.coll_wire
    compute_s = flops / PEAK_FLOPS_BF16
    memory_s = nbytes / HBM_BW
    collective_s = wire / NVLINK_BW
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    bottleneck = max(terms, key=terms.get)
    mf = (model_flops(cfg, params_proto, kind, seq_len, global_batch)
          if cfg is not None and params_proto is not None else 0.0)
    useful = mf / (flops * chips) if flops else 0.0
    tot = sum(terms.values())
    frac = terms[bottleneck] / tot if tot else 0.0
    return RooflineReport(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        hlo_flops=flops, hlo_bytes=nbytes, wire_bytes=wire,
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        bottleneck=bottleneck, model_flops_global=mf,
        useful_ratio=useful, roofline_frac=frac,
        n_collectives=int(round(totals.n_coll)),
        collectives_by_kind=dict(totals.coll_by_kind),
        memory_analysis=compiled.memory_analysis())
