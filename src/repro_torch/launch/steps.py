"""Step builders of the dry run (the port of ``repro/launch/steps.py``):
per (architecture x step kind), the step function with its input
prototypes and the :class:`~repro_torch.parallel.NamedSharding` tree of
every argument.

- The prototypes are tensors on the ``meta`` device (shapes and dtypes,
  nothing allocated), where the reference gives ``ShapeDtypeStruct`` s:
  :func:`~repro_torch.models.abstract_init` builds the params there.
- ``fn`` runs the step eagerly under ``use_mesh(mesh, arch_rules(...))``:
  the models take the reference's mesh branches on rank-stacked views
  (``parallel/``), every rank on one device.  Called on the prototypes
  it runs on ``meta``: the dry run counts it (``analysis/hlo_walk.py``).
- ``donate`` names the arguments the reference donates; the port's steps
  update those (the params and optimizer state, the caches) in place.

The rules choose the mesh branches the models take (``decode_rules``
turns on the context-parallel and resident-expert decode)."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..data import batch_specs
from ..models import (abstract_init, apply_model, decode_step, init_cache,
                      prefill)
from ..models.attention import attn_cache_dims
from ..models.common import PyTree, tree_map
from ..models.mla import mla_cache_dims
from ..models.moe import resident_plan
from ..models.ssm import ssm_cache_dims
from ..optim import AdamWState, adamw_init, cosine_schedule
from ..parallel.sharding import (Mesh, NamedSharding, P, logical_spec,
                                 param_shardings, use_mesh)
from ..runtime.trainer import TrainConfig, make_train_step


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


@dataclasses.dataclass
class StepBundle:
    fn: Callable[..., Any]        # the step, run under the bundle's mesh
    args: Tuple[Any, ...]         # prototypes on the ``meta`` device
    donate: Tuple[int, ...] = ()
    shardings: Tuple[Any, ...] = ()   # a NamedSharding tree per argument
    mesh: Optional[Mesh] = None
    rules: Dict[str, Tuple[str, ...]] = dataclasses.field(
        default_factory=dict)


def _meta(shape: Tuple[int, ...], dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _rules(cfg: Any, mesh: Optional[Mesh], kind: str
           ) -> Dict[str, Tuple[str, ...]]:
    return arch_rules(cfg, mesh, kind) if mesh is not None else {}


def _under_mesh(step: Callable[..., Any], mesh: Optional[Mesh],
                rules: Dict[str, Tuple[str, ...]]) -> Callable[..., Any]:
    def fn(*args):
        with use_mesh(mesh, rules):
            return step(*args)
    return fn


def _spec(dims: Tuple[Optional[str], ...], t: torch.Tensor,
          mesh: Optional[Mesh]) -> NamedSharding:
    return NamedSharding(mesh, logical_spec(dims, tuple(t.shape), mesh))


def build_train_bundle(cfg: Any, mesh: Optional[Mesh], seq_len: int,
                       global_batch: int,
                       kernels: Optional[Dict[str, Any]] = None,
                       tcfg: Optional[TrainConfig] = None) -> StepBundle:
    tcfg = tcfg or TrainConfig(seq_len=seq_len, global_batch=global_batch)
    rules = _rules(cfg, mesh, "train")
    with use_mesh(mesh, rules):
        params_proto, dims = abstract_init(cfg)
        pshard = param_shardings(dims, params_proto, mesh)
        opt_proto = adamw_init(params_proto, cfg.opt_dtype)
        opt_shard = AdamWState(step=NamedSharding(mesh, P()),
                               m=pshard, v=pshard)
        bspecs = batch_specs(cfg, seq_len, global_batch)
        bshard = {k: _spec(("batch",) + (None,) * (v.dim() - 1), v, mesh)
                  for k, v in bspecs.items()}
    lr_fn = cosine_schedule(tcfg.lr, tcfg.warmup, tcfg.total_steps)
    step = make_train_step(cfg, tcfg, lr_fn, kernels)
    return StepBundle(fn=_under_mesh(step, mesh, rules),
                      args=(params_proto, opt_proto, bspecs),
                      donate=(0, 1), shardings=(pshard, opt_shard, bshard),
                      mesh=mesh, rules=rules)


def build_prefill_bundle(cfg: Any, mesh: Optional[Mesh], seq_len: int,
                         global_batch: int,
                         kernels: Optional[Dict[str, Any]] = None
                         ) -> StepBundle:
    rules = _rules(cfg, mesh, "prefill")
    with use_mesh(mesh, rules):
        params_proto, dims = abstract_init(cfg)
        pshard = param_shardings(dims, params_proto, mesh)
        tok_proto = _meta((global_batch, seq_len), torch.int32)
        tok_shard = _spec(("batch", None), tok_proto, mesh)
        if cfg.family == "audio":
            # encoder-only: "prefill" is the full forward over frame
            # embeddings (the modality frontend stub); no KV cache exists
            fe_proto = _meta((global_batch, seq_len, cfg.d_model),
                             cfg.dtype)
            fe_shard = _spec(("batch", "seq", None), fe_proto, mesh)

            @torch.no_grad()
            def astep(params, tokens, frontend):
                logits, _ = apply_model(cfg, params, tokens,
                                        frontend_embeds=frontend,
                                        kernels=kernels)
                return logits

            return StepBundle(fn=_under_mesh(astep, mesh, rules),
                              args=(params_proto, tok_proto, fe_proto),
                              shardings=(pshard, tok_shard, fe_shard),
                              mesh=mesh, rules=rules)

        fe_len = cfg.frontend_len if cfg.family == "vlm" else 0
        caches_proto = init_cache(cfg, global_batch, seq_len + fe_len,
                                  device="meta")
        cshard = param_shardings(cache_dims(cfg, caches_proto),
                                 caches_proto, mesh)
        if fe_len:
            fe_proto = _meta((global_batch, fe_len, cfg.d_model), cfg.dtype)
            fe_shard = _spec(("batch", None, None), fe_proto, mesh)

            def vstep(params, tokens, frontend, caches):
                return prefill(cfg, params, tokens, caches,
                               frontend_embeds=frontend, kernels=kernels)

            return StepBundle(fn=_under_mesh(vstep, mesh, rules),
                              args=(params_proto, tok_proto, fe_proto,
                                    caches_proto), donate=(3,),
                              shardings=(pshard, tok_shard, fe_shard,
                                         cshard), mesh=mesh, rules=rules)

    def step(params, tokens, caches):
        return prefill(cfg, params, tokens, caches, kernels=kernels)

    return StepBundle(fn=_under_mesh(step, mesh, rules),
                      args=(params_proto, tok_proto, caches_proto),
                      donate=(2,), shardings=(pshard, tok_shard, cshard),
                      mesh=mesh, rules=rules)


def build_decode_bundle(cfg: Any, mesh: Optional[Mesh], seq_len: int,
                        global_batch: int,
                        kernels: Optional[Dict[str, Any]] = None
                        ) -> StepBundle:
    """One decode step with a KV cache of ``seq_len`` tokens.  The length
    prototype is a 0-d int32, one fill level for every sequence, as the
    reference's."""
    rules = _rules(cfg, mesh, "decode")
    with use_mesh(mesh, rules):
        params_proto, dims = abstract_init(cfg)
        pshard = param_shardings(dims, params_proto, mesh)
        caches_proto = init_cache(cfg, global_batch, seq_len, device="meta")
        cshard = param_shardings(cache_dims(cfg, caches_proto),
                                 caches_proto, mesh)
        tok_proto = _meta((global_batch, 1), torch.int32)
        tok_shard = _spec(("batch", None), tok_proto, mesh)
        len_proto = _meta((), torch.int32)

    def step(params, tokens, caches, length):
        return decode_step(cfg, params, tokens, caches, length,
                           kernels=kernels)

    return StepBundle(fn=_under_mesh(step, mesh, rules),
                      args=(params_proto, tok_proto, caches_proto,
                            len_proto), donate=(2,),
                      shardings=(pshard, tok_shard, cshard,
                                 NamedSharding(mesh, P())),
                      mesh=mesh, rules=rules)


def build_bundle(cfg: Any, mesh: Optional[Mesh], kind: str, seq_len: int,
                 global_batch: int,
                 kernels: Optional[Dict[str, Any]] = None) -> StepBundle:
    if kind == "train":
        return build_train_bundle(cfg, mesh, seq_len, global_batch,
                                  kernels)
    if kind == "prefill":
        return build_prefill_bundle(cfg, mesh, seq_len, global_batch,
                                    kernels)
    if kind == "decode":
        return build_decode_bundle(cfg, mesh, seq_len, global_batch,
                                   kernels)
    raise ValueError(f"unknown step kind {kind!r}")
