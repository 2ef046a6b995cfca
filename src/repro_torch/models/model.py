"""Model builder: embed -> (prefix layers + periodic stack) -> head.

The port of ``repro/models/model.py``: dense, MoE, SSM, hybrid (attention
+ Mamba, with or without experts), MLA (DeepSeek) and encoder-only
plans, and the modality frontends.  Layer plans come from
``ModelConfig.layer_plan()``.  The reference stacks the periodic body's
params along a leading ``[n_periods]`` dim and runs it with
``lax.scan``; here ``params["stack"]`` is a list with one dict per
period and a Python loop walks it.  The decode caches keep the
reference's stacked layout, each layer with its own kind of cache:
``{k, v}`` for attention (``caches["stack"]["l0"]["k"]`` is
``[n_periods, B, Smax, Hkv, hd]``), ``{ckv, krope}`` for MLA (the
latents, ``[n_periods, B, Smax, kv_lora]`` and ``[..., rope]``) and
``{conv, h}`` for Mamba (``[n_periods, B, k-1, conv_ch]`` and
``[n_periods, B, H, N, P]``).  Each layer reads and writes its own slice
in place.  An MoE layer's FFN is :func:`repro_torch.models.moe.moe_apply`,
which runs the ``"moe_gmm"`` kernel hook when ``kernels`` has it.

Frontends are stubs, as in the reference: a VLM's precomputed patch
embeddings ``frontend_embeds [B, P, D]`` are prepended to the token
embeddings, and for audio the frame embeddings are the input (an audio
model has no ``embed`` table and no decode path).  With ``mtp_depth``
:func:`init_model` builds DeepSeek-V3's multi-token-prediction params
(``mtp_layer``, ``mtp_proj``, ``mtp_norm``) as the reference does, and
:func:`loss_fn` adds their loss.

Entry points: :func:`init_model` (:func:`abstract_init` on the ``meta``
device), :func:`apply_model` (full-sequence ``(logits, aux)``, with
gradients), :func:`loss_fn` (next-token cross entropy + MoE aux + MTP),
and for serving :func:`init_cache` / :func:`prefill` /
:func:`decode_step` (under ``torch.no_grad``).  In training the periodic
body is rematerialised per period as ``cfg.remat`` says: ``"full"``
recomputes it in the backward (``torch.utils.checkpoint``), ``"dots"``
keeps the matmul outputs and recomputes the rest, ``"none"`` keeps all.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple, Union

import torch
import torch.utils.checkpoint as ckpt

from ..configs.base import LayerSpec
from ..device import DeviceLike, resolve_device
from ..parallel.sharding import active_mesh, active_rules, use_mesh
from .attention import attn_apply, attn_cache_init, attn_decode, attn_init
from .common import (PyTree, dense, dense_init, embed, embed_init, gelu,
                     norm, norm_init, rope_cos_sin, softmax_xent, swiglu,
                     tree_map)
from .mla import _latents, mla_apply, mla_cache_init, mla_decode, mla_init
from .moe import moe_apply, moe_init
from .ssm import ssm_apply, ssm_cache_init, ssm_decode, ssm_init


# ---------------------------------------------------------------------------
# dense FFN
# ---------------------------------------------------------------------------
def ffn_init(gen: torch.Generator, cfg: Any, device: torch.device) -> PyTree:
    kw = dict(dtype=cfg.param_dtype, device=device)
    if cfg.act == "swiglu":
        return {"gate": dense_init(gen, cfg.d_model, cfg.d_ff, **kw),
                "up": dense_init(gen, cfg.d_model, cfg.d_ff, **kw),
                "down": dense_init(gen, cfg.d_ff, cfg.d_model, **kw)}
    return {"fc1": dense_init(gen, cfg.d_model, cfg.d_ff, bias=True, **kw),
            "fc2": dense_init(gen, cfg.d_ff, cfg.d_model, bias=True, **kw)}


def ffn_apply(cfg: Any, p: PyTree, x: torch.Tensor) -> torch.Tensor:
    if cfg.act == "swiglu":
        return dense(p["down"], swiglu(dense(p["gate"], x),
                                       dense(p["up"], x)))
    return dense(p["fc2"], gelu(dense(p["fc1"], x)))


# ---------------------------------------------------------------------------
# one layer
# ---------------------------------------------------------------------------
def layer_init(gen: torch.Generator, cfg: Any, spec: Any,
               device: torch.device) -> PyTree:
    mixer = {"attn": attn_init, "mla": mla_init,
             "mamba": ssm_init}[spec.mixer]
    p = {"norm1": norm_init(cfg.norm, cfg.d_model, cfg.param_dtype, device),
         "mixer": mixer(gen, cfg, device)}
    if spec.ffn is not None:
        p["norm2"] = norm_init(cfg.norm, cfg.d_model, cfg.param_dtype,
                               device)
        p["ffn"] = (moe_init(gen, cfg, device) if spec.ffn == "moe"
                    else ffn_init(gen, cfg, device))
    return p


def layer_apply(cfg: Any, spec: Any, p: PyTree, x: torch.Tensor, *,
                positions: torch.Tensor, mode: str = "train",
                cache: Optional[PyTree] = None,
                lengths: Optional[torch.Tensor] = None,
                impl: Optional[str] = None,
                kernels: Optional[Dict[str, Any]] = None,
                rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One layer -> (x, the MoE layer's aux loss or None).  In
    ``prefill`` and ``decode`` mode ``cache`` (this layer's ``{k, v}``
    [B,Smax,Hkv,hd], ``{ckv, krope}`` or ``{conv, h}``) is written in
    place.  ``rope``: the decode step's (cos, sin), for the
    ``"decode_attention"`` hook."""
    impl = impl or getattr(cfg, "attn_impl", "chunked")
    kernels = kernels or {}
    h = norm(cfg.norm, p["norm1"], x, cfg.norm_eps)
    if spec.mixer == "mamba":
        if mode == "decode":
            y, _ = ssm_decode(cfg, p["mixer"], h, cache)
        else:
            y, state = ssm_apply(cfg, p["mixer"], h,
                                 return_cache=(mode == "prefill"),
                                 kernel_fn=kernels.get("ssd_scan"))
            if mode == "prefill":
                # the whole state: nothing masks what a longer earlier
                # prompt left in this slot
                cache["conv"].copy_(state["conv"])
                cache["h"].copy_(state["h"])
    elif spec.mixer == "mla":
        if mode == "decode":
            y, _ = mla_decode(cfg, p["mixer"], h, cache, lengths)
        else:
            y = mla_apply(cfg, p["mixer"], h, positions=positions, impl=impl)
            if mode == "prefill":
                _mla_fill_cache(cfg, p["mixer"], h, positions, cache)
    elif mode == "decode":
        y, _ = attn_decode(cfg, p["mixer"], h, cache, lengths,
                           kernel_fn=kernels.get("decode_attention"),
                           rope=rope)
    else:
        y, k, v = attn_apply(cfg, p["mixer"], h, positions=positions,
                             impl=impl,
                             kernel_fn=kernels.get("flash_attention"))
        if mode == "prefill":
            s = h.shape[1]
            cache["k"][:, :s] = k.to(cache["k"].dtype)
            cache["v"][:, :s] = v.to(cache["v"].dtype)
    x = x + y
    aux = None
    if spec.ffn is not None:
        h = norm(cfg.norm, p["norm2"], x, cfg.norm_eps)
        if spec.ffn == "moe":
            y, aux = moe_apply(cfg, p["ffn"], h,
                               kernel_fn=kernels.get("moe_gmm"),
                               decode=(mode == "decode"))
        else:
            y = ffn_apply(cfg, p["ffn"], h)
        x = x + y
    return x, aux


def _mla_fill_cache(cfg: Any, p: PyTree, h: torch.Tensor,
                    positions: torch.Tensor, cache: PyTree) -> None:
    """Write the prompt's latents to rows [0, S) of ``{ckv, krope}``."""
    c_kv, k_rope = _latents(cfg, p, h, positions)
    s = h.shape[1]
    cache["ckv"][:, :s] = c_kv.to(cache["ckv"].dtype)
    cache["krope"][:, :s] = k_rope.to(cache["krope"].dtype)


# ---------------------------------------------------------------------------
# whole model
# ---------------------------------------------------------------------------
def init_model(gen: torch.Generator, cfg: Any, *,
               device: DeviceLike = None) -> PyTree:
    """Random params from ``gen`` with the reference's distributions, on
    ``device`` (default ``"cuda"``; raises where CUDA is absent).  The
    draws run on the generator's device and are moved.  An audio model
    has no ``embed`` (its inputs are frame embeddings); with
    ``cfg.mtp_depth`` the multi-token-prediction params are built as in
    the reference, for :func:`loss_fn`'s MTP loss."""
    dev = resolve_device(device)
    prefix, period, n_periods = cfg.scan_plan()
    params: Dict[str, Any] = {}
    if cfg.family != "audio":
        params["embed"] = embed_init(gen, cfg.vocab, cfg.d_model,
                                     dtype=cfg.param_dtype, device=dev)
    for i, spec in enumerate(prefix):
        params[f"prefix_{i}"] = layer_init(gen, cfg, spec, dev)
    params["stack"] = [
        {f"l{j}": layer_init(gen, cfg, spec, dev)
         for j, spec in enumerate(period)}
        for _ in range(n_periods)]
    params["final_norm"] = norm_init(cfg.norm, cfg.d_model, cfg.param_dtype,
                                     dev)
    if not cfg.tie_embeddings:
        params["head"] = dense_init(gen, cfg.d_model, cfg.vocab,
                                    dtype=cfg.param_dtype, device=dev)
    if cfg.mtp_depth:
        spec = LayerSpec("attn" if cfg.family != "ssm" else "mamba", "dense")
        params["mtp_layer"] = layer_init(gen, cfg, spec, dev)
        params["mtp_proj"] = dense_init(gen, 2 * cfg.d_model, cfg.d_model,
                                        dtype=cfg.param_dtype, device=dev)
        params["mtp_norm"] = norm_init(cfg.norm, cfg.d_model,
                                       cfg.param_dtype, dev)
    return params


def _embed_in(cfg: Any, params: PyTree, tokens: Optional[torch.Tensor],
              frontend_embeds: Optional[torch.Tensor]) -> torch.Tensor:
    if cfg.family == "audio":
        # encoder stub: the inputs are frame embeddings [B, S, D]
        return frontend_embeds.to(cfg.dtype)
    x = embed(params["embed"], tokens, cfg.dtype)
    if frontend_embeds is not None:      # VLM: prepend patch embeddings
        x = torch.cat([frontend_embeds.to(cfg.dtype), x], dim=1)
    return x


def _head_out(cfg: Any, params: PyTree, x: torch.Tensor) -> torch.Tensor:
    x = norm(cfg.norm, params["final_norm"], x, cfg.norm_eps)
    if cfg.tie_embeddings:
        return x @ params["embed"]["emb"].t().to(x.dtype)
    return dense(params["head"], x)


def _dots_policy(ctx, op, *args, **kwargs):
    """``remat="dots"``: keep matmul outputs, recompute the rest (the
    reference's ``checkpoint_dots``)."""
    dots = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
            torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default)
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in dots
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _stack_sweep(cfg: Any, params: PyTree, x: torch.Tensor, *,
                 positions: torch.Tensor, mode: str,
                 caches: Optional[PyTree] = None,
                 lengths: Optional[torch.Tensor] = None,
                 impl: Optional[str] = None,
                 kernels: Optional[Dict[str, Any]] = None,
                 rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Run the prefix and the periodic stack -> (x, in ``train`` mode the
    sum of the MoE layers' aux losses in f32, else None: serving has no
    use for it).  In ``train`` mode each period is rematerialised as
    ``cfg.remat`` says (the prefix layers are not, as in the
    reference)."""
    prefix, period, _ = cfg.scan_plan()
    kw = dict(positions=positions, mode=mode, lengths=lengths, impl=impl,
              kernels=kernels, rope=rope)
    train = mode == "train"
    aux_total = (torch.zeros((), dtype=torch.float32, device=x.device)
                 if train else None)
    for i, spec in enumerate(prefix):
        c = None if caches is None else caches[f"prefix_{i}"]
        x, aux = layer_apply(cfg, spec, params[f"prefix_{i}"], x, cache=c,
                             **kw)
        if train and aux is not None:
            aux_total = aux_total + aux

    def period_body(p_period, c_period, x, aux_total):
        for j, spec in enumerate(period):
            c = None if c_period is None else c_period[f"l{j}"]
            x, aux = layer_apply(cfg, spec, p_period[f"l{j}"], x, cache=c,
                                 **kw)
            if train and aux is not None:
                aux_total = aux_total + aux
        return x, aux_total

    remat = train and cfg.remat != "none"
    policy = {} if cfg.remat != "dots" else {
        "context_fn": functools.partial(
            ckpt.create_selective_checkpoint_contexts, _dots_policy)}
    # the backward recomputes a period under the mesh and rules of its
    # forward, whatever is active when the gradient is taken
    mesh, rules = active_mesh(), active_rules()

    def remat_body(*a):
        with use_mesh(mesh, rules):
            return period_body(*a)

    for n, p_period in enumerate(params["stack"]):
        c_period = None
        if caches is not None:
            c_period = {f"l{j}": {key: t[n] for key, t in
                                  caches["stack"][f"l{j}"].items()}
                        for j in range(len(period))}
        if remat:
            x, aux_total = ckpt.checkpoint(remat_body, p_period, c_period,
                                           x, aux_total, use_reentrant=False,
                                           **policy)
        else:
            x, aux_total = period_body(p_period, c_period, x, aux_total)
    return x, aux_total


def apply_model(cfg: Any, params: PyTree, tokens: Optional[torch.Tensor], *,
                frontend_embeds: Optional[torch.Tensor] = None,
                impl: Optional[str] = None,
                kernels: Optional[Dict[str, Any]] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward, with gradients.  tokens [B, S] -> (logits
    [B, S', V], the MoE layers' summed aux loss [] f32).  S' = P + S with
    a VLM's ``frontend_embeds [B, P, D]``; for audio the frames
    ``[B, S, D]`` are the input and ``tokens`` is not read.  Inference
    callers take their own ``torch.no_grad()``."""
    x = _embed_in(cfg, params, tokens, frontend_embeds)
    positions = torch.arange(x.shape[1], dtype=torch.int32,
                             device=x.device)
    x, aux = _stack_sweep(cfg, params, x, positions=positions, mode="train",
                          impl=impl, kernels=kernels)
    return _head_out(cfg, params, x), aux


def loss_fn(cfg: Any, params: PyTree, batch: Dict[str, torch.Tensor], *,
            impl: Optional[str] = None,
            kernels: Optional[Dict[str, Any]] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross entropy + ``aux_loss_coef`` x the MoE aux loss
    (+ ``mtp_loss_coef`` x the MTP loss) -> (loss, metrics).  ``batch``:
    ``tokens``, ``labels`` [B, S], optional ``mask`` [B, S] and
    ``frontend`` (a VLM's patch embeddings, whose rows are cut from the
    logits, or the audio frames)."""
    logits, aux = apply_model(cfg, params, batch["tokens"],
                              frontend_embeds=batch.get("frontend"),
                              impl=impl, kernels=kernels)
    if cfg.family == "vlm" and "frontend" in batch:
        logits = logits[:, batch["frontend"].shape[1]:, :]
    xent = softmax_xent(logits, batch["labels"], batch.get("mask"))
    loss = xent + cfg.aux_loss_coef * aux
    metrics = {"xent": xent, "aux": aux}
    if cfg.mtp_depth:
        mtp = _mtp_loss(cfg, params, batch)
        loss = loss + cfg.mtp_loss_coef * mtp
        metrics["mtp"] = mtp
    metrics["loss"] = loss
    return loss, metrics


def _mtp_loss(cfg: Any, params: PyTree, batch: Dict[str, torch.Tensor]
              ) -> torch.Tensor:
    """DeepSeek-V3's multi-token prediction as the reference simplifies
    it (depth 1): each token's embedding joined with the next one's, one
    extra layer, predict t + 2."""
    tokens = batch["tokens"]
    x = embed(params["embed"], tokens, cfg.dtype)
    nxt = torch.roll(x, -1, dims=1)
    h = dense(params["mtp_proj"], torch.cat([x, nxt], dim=-1))
    positions = torch.arange(h.shape[1], dtype=torch.int32, device=h.device)
    spec = LayerSpec("attn" if cfg.family != "ssm" else "mamba", "dense")
    h, _ = layer_apply(cfg, spec, params["mtp_layer"], h,
                       positions=positions, mode="train")
    h = norm(cfg.norm, params["mtp_norm"], h, cfg.norm_eps)
    mtp_logits = _head_out(cfg, params, h)
    labels2 = torch.roll(batch["labels"], -1, dims=1)
    mask = torch.ones(labels2.shape, dtype=torch.float32,
                      device=labels2.device)
    mask[:, -2:] = 0.0
    return softmax_xent(mtp_logits, labels2, mask)


# the reference's logical dims: of a dense or expert-stack weight by its
# parent's name (a dense bias takes the weight's output dim), and of the
# other leaves by their own name
_W_DIMS = {
    "wq": ("embed", "q_proj"), "wk": ("embed", "kv_proj"),
    "wv": ("embed", "kv_proj"), "wo": ("q_proj", "embed"),
    "gate": ("embed", "mlp"), "up": ("embed", "mlp"), "down": ("mlp", "embed"),
    "fc1": ("embed", "mlp"), "fc2": ("mlp", "embed"),
    "router": ("embed", "router"), "shared_gate": ("embed", "mlp"),
    "shared_up": ("embed", "mlp"), "shared_down": ("mlp", "embed"),
    "w_gate": ("experts", "embed", "moe_mlp"),
    "w_up": ("experts", "embed", "moe_mlp"),
    "w_down": ("experts", "moe_mlp", "embed"),
    "in_proj": ("embed", "ssm_in"), "out_proj": ("ssm_inner", "embed"),
    "w_dq": ("embed", "q_lora"), "w_uq": ("q_lora", "q_proj"),
    "w_dkv": ("embed", "kv_lora"), "w_uk": ("kv_lora", "q_proj"),
    "w_uv": ("kv_lora", "q_proj"),
    "head": ("embed", "vocab"), "mtp_proj": ("embed", "embed_out"),
}
_LEAF_DIMS = {
    "emb": ("vocab", "embed"), "g": ("embed",), "b": ("embed",),
    "conv_w": ("conv_k", "ssm_conv_ch"), "conv_b": ("ssm_conv_ch",),
    "A_log": ("ssm_heads",), "D": ("ssm_heads",), "dt_bias": ("ssm_heads",),
    "norm_g": ("ssm_inner",),
}


def _dims(tree: PyTree, parent: str = "") -> PyTree:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _dims(v, k)
        elif parent in _W_DIMS:
            w = _W_DIMS[parent]
            out[k] = w if k == "w" else (w[-1],)
        else:
            out[k] = _LEAF_DIMS[k]
    return out


def abstract_init(cfg: Any) -> Tuple[PyTree, PyTree]:
    """(params on the ``meta`` device: the shapes and dtypes of
    :func:`init_model`'s, nothing allocated, nothing drawn; the
    reference's logical dims of each leaf, ``"stack"`` as one nest with a
    leading ``"layers"`` dim)."""
    params = init_model(torch.Generator(), cfg, device="meta")
    dims = _dims({k: v for k, v in params.items() if k != "stack"})
    dims["stack"] = tree_map(lambda t: ("layers",) + t,
                             _dims(params["stack"][0]),
                             is_leaf=lambda t: isinstance(t, tuple))
    return params, dims


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------
def layer_cache_init(cfg: Any, spec: Any, batch: int, max_seq: int,
                     device: torch.device) -> PyTree:
    if spec.mixer == "mamba":
        return ssm_cache_init(cfg, batch, device=device)
    if spec.mixer == "mla":
        return mla_cache_init(cfg, batch, max_seq, device=device)
    return attn_cache_init(cfg, batch, max_seq, device=device)


def init_cache(cfg: Any, batch: int, max_seq: int, *,
               device: DeviceLike = None) -> PyTree:
    dev = resolve_device(device)
    prefix, period, n_periods = cfg.scan_plan()
    caches: Dict[str, Any] = {
        f"prefix_{i}": layer_cache_init(cfg, spec, batch, max_seq, dev)
        for i, spec in enumerate(prefix)}
    caches["stack"] = {
        f"l{j}": {key: torch.stack([t] * n_periods) for key, t in
                  layer_cache_init(cfg, spec, batch, max_seq, dev).items()}
        for j, spec in enumerate(period)}
    return caches


def cache_batch_axes(cfg: Any, caches: PyTree) -> PyTree:
    """Nest (matching ``caches``) of the batch-dim index per leaf: 0 for
    prefix-layer caches, 1 for stacked caches (dim 0 is the period)."""
    def axes(t, a):
        if isinstance(t, dict):
            return {k: axes(v, a) for k, v in t.items()}
        return a
    return {k: axes(v, 1 if k == "stack" else 0) for k, v in caches.items()}


def slot_view(cfg: Any, caches: PyTree, slot: int) -> PyTree:
    """Views of ``caches`` holding sequence ``slot`` only (batch dim 1):
    what is written to them lands in ``caches``."""
    def view(t, a):
        if isinstance(t, dict):
            return {k: view(v, a[k]) for k, v in t.items()}
        return t.narrow(a, slot, 1)
    return view(caches, cache_batch_axes(cfg, caches))


@torch.no_grad()
def prefill(cfg: Any, params: PyTree, tokens: torch.Tensor, caches: PyTree,
            *, frontend_embeds: Optional[torch.Tensor] = None,
            impl: Optional[str] = None,
            kernels: Optional[Dict[str, Any]] = None
            ) -> Tuple[torch.Tensor, PyTree]:
    """Fill rows [0, S') of the cache in place for the prompt (S' = P + S
    with a VLM's patch embeddings ``frontend_embeds [B, P, D]`` ahead of
    the tokens); return (last-position logits [B, 1, V], caches)."""
    x = _embed_in(cfg, params, tokens, frontend_embeds)
    positions = torch.arange(x.shape[1], dtype=torch.int32,
                             device=x.device)
    x, _ = _stack_sweep(cfg, params, x, positions=positions,
                        mode="prefill", caches=caches, impl=impl,
                        kernels=kernels)
    return _head_out(cfg, params, x[:, -1:, :]), caches


@torch.no_grad()
def decode_step(cfg: Any, params: PyTree, tokens: torch.Tensor,
                caches: PyTree, lengths: Union[int, torch.Tensor], *,
                kernels: Optional[Dict[str, Any]] = None
                ) -> Tuple[torch.Tensor, PyTree]:
    """One token for every sequence.  tokens [B, 1]; ``lengths`` is each
    sequence's cache fill, ``[B]`` or one int for all.  Writes the cache
    in place; returns (logits [B, 1, V], caches).  An MoE layer routes
    each sequence's token as if it were alone, as the reference's engine
    does by mapping decode over the sequences: no expert drops one
    (``moe.decode_capacity``).  With the ``"decode_attention"`` hook the
    step's RoPE cos and sin are computed here once for every layer."""
    b = tokens.shape[0]
    lengths = torch.as_tensor(lengths, dtype=torch.int32,
                              device=tokens.device).expand(b).contiguous()
    rope = None
    if kernels and "decode_attention" in kernels:
        rope = rope_cos_sin(lengths, cfg.head_dim, cfg.rope_theta)
    x = embed(params["embed"], tokens, cfg.dtype)
    x, _ = _stack_sweep(cfg, params, x, positions=lengths[:, None],
                        mode="decode", caches=caches, lengths=lengths,
                        kernels=kernels, rope=rope)
    return _head_out(cfg, params, x), caches
