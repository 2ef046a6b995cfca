"""Sharding rules of the step builders (the port of the rule functions of
``repro/launch/steps.py``): per-architecture rule overrides and the
logical dims of the decode caches.  The rules choose the mesh branches
the models take (``decode_rules`` turns on the context-parallel and
resident-expert decode)."""
from __future__ import annotations

from typing import Any, Dict, Tuple

from ..models.attention import attn_cache_dims
from ..models.common import PyTree, tree_map
from ..models.mla import mla_cache_dims
from ..models.moe import resident_plan
from ..models.ssm import ssm_cache_dims
from ..parallel.sharding import Mesh


def arch_rules(cfg: Any, mesh: Mesh, kind: str
               ) -> Dict[str, Tuple[str, ...]]:
    """Per-architecture rule overrides.

    Head-TP configs (n_kv_heads divides the model axis: MLA's 128 heads,
    hubert's 16) shard qkv column-parallel and wo row-parallel, so q/k/v
    come out head-sharded; chunk-mode configs keep qkv / wo replicated
    over ``model`` (sequence parallelism carries attention)."""
    rules: Dict[str, Tuple[str, ...]] = {}
    tp = mesh.shape.get("model", 1)
    if tp > 1 and cfg.n_kv_heads and cfg.n_kv_heads % tp == 0:
        rules.update({"q_proj": ("model",), "kv_proj": ("model",)})
    if kind == "decode":
        rules.update(decode_rules(cfg, mesh))
    return rules


def decode_rules(cfg: Any, mesh: Mesh) -> Dict[str, Tuple[str, ...]]:
    """Rule overrides for decode.

    KV caches shard over the model axis by heads when they divide it;
    otherwise (and always for MLA's head-less latent cache) by sequence:
    context-parallel decode.  With experts, the experts shard over the
    joint (model, data...) axes when :func:`resident_plan` fits them, so
    the FFN weights stay resident."""
    tp = mesh.shape.get("model", 1)
    rules: Dict[str, Tuple[str, ...]] = {}
    if cfg.n_experts:
        axes = resident_plan(cfg, mesh)
        if axes is not None:
            rules["experts"] = axes
    if cfg.n_kv_heads and cfg.n_kv_heads % tp == 0 \
            and not cfg.kv_lora_rank:
        return rules
    rules.update({"cache_seq": ("model",), "kv_heads": ()})
    return rules


def cache_dims(cfg: Any, caches: PyTree) -> PyTree:
    """Logical-dims tree mirroring ``init_cache``'s output (the stacked
    layers' caches with a leading ``"layers"`` dim)."""
    prefix, period, _ = cfg.scan_plan()

    def dims_for(spec):
        if spec.mixer == "attn":
            return attn_cache_dims()
        if spec.mixer == "mla":
            return mla_cache_dims()
        return ssm_cache_dims()

    out: Dict[str, Any] = {}
    for i, spec in enumerate(prefix):
        out[f"prefix_{i}"] = dims_for(spec)
    out["stack"] = {
        f"l{j}": tree_map(lambda d: ("layers",) + d, dims_for(spec),
                          is_leaf=lambda t: isinstance(t, tuple))
        for j, spec in enumerate(period)}
    return out
