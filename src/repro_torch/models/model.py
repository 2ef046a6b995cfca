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
(``mtp_layer``, ``mtp_proj``, ``mtp_norm``) as the reference does, so
that its trees carry over; the MTP loss that uses them comes with the
training slice (ROADMAP.md).

Entry points: :func:`init_model`, :func:`apply_model` (full-sequence
logits), and for serving :func:`init_cache` / :func:`prefill` /
:func:`decode_step`.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import torch

from ..configs.base import LayerSpec
from ..device import DeviceLike, resolve_device
from .attention import attn_apply, attn_cache_init, attn_decode, attn_init
from .common import (PyTree, dense, dense_init, embed, embed_init, gelu,
                     norm, norm_init, swiglu)
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
                kernels: Optional[Dict[str, Any]] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One layer -> (x, the MoE layer's aux loss or None).  In
    ``prefill`` and ``decode`` mode ``cache`` (this layer's ``{k, v}``
    [B,Smax,Hkv,hd], ``{ckv, krope}`` or ``{conv, h}``) is written in
    place."""
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
        y, _ = attn_decode(cfg, p["mixer"], h, cache, lengths)
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
    the reference, for the training slice's loss."""
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


def _stack_sweep(cfg: Any, params: PyTree, x: torch.Tensor, *,
                 positions: torch.Tensor, mode: str,
                 caches: Optional[PyTree] = None,
                 lengths: Optional[torch.Tensor] = None,
                 impl: Optional[str] = None,
                 kernels: Optional[Dict[str, Any]] = None) -> torch.Tensor:
    """Run the prefix and the periodic stack.  The layers' MoE aux losses
    are dropped: every entry point here is inference (the training slice
    sums them, as the reference's ``_stack_sweep`` does)."""
    prefix, period, _ = cfg.scan_plan()
    kw = dict(positions=positions, mode=mode, lengths=lengths, impl=impl,
              kernels=kernels)
    for i, spec in enumerate(prefix):
        c = None if caches is None else caches[f"prefix_{i}"]
        x, _ = layer_apply(cfg, spec, params[f"prefix_{i}"], x, cache=c,
                           **kw)
    for n, p_period in enumerate(params["stack"]):
        for j, spec in enumerate(period):
            c = None
            if caches is not None:
                c = {key: t[n] for key, t in caches["stack"][f"l{j}"].items()}
            x, _ = layer_apply(cfg, spec, p_period[f"l{j}"], x, cache=c,
                               **kw)
    return x


@torch.no_grad()
def apply_model(cfg: Any, params: PyTree, tokens: Optional[torch.Tensor], *,
                frontend_embeds: Optional[torch.Tensor] = None,
                impl: Optional[str] = None,
                kernels: Optional[Dict[str, Any]] = None) -> torch.Tensor:
    """Full-sequence forward.  tokens [B, S] -> logits [B, S', V] (S' =
    P + S with a VLM's ``frontend_embeds [B, P, D]``; for audio the
    frames ``[B, S, D]`` are the input and ``tokens`` is not read).  The
    reference returns ``(logits, aux)``; the MoE aux loss is a training
    quantity, so it stays out of this inference entry point until the
    training slice (the twins check it at ``moe_apply``, and
    ``layer_apply`` returns it)."""
    x = _embed_in(cfg, params, tokens, frontend_embeds)
    positions = torch.arange(x.shape[1], dtype=torch.int32,
                             device=x.device)
    x = _stack_sweep(cfg, params, x, positions=positions, mode="train",
                     impl=impl, kernels=kernels)
    return _head_out(cfg, params, x)


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
    x = _stack_sweep(cfg, params, x, positions=positions, mode="prefill",
                     caches=caches, impl=impl, kernels=kernels)
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
    (``moe.decode_capacity``)."""
    b = tokens.shape[0]
    lengths = torch.as_tensor(lengths, dtype=torch.int32,
                              device=tokens.device).expand(b).contiguous()
    x = embed(params["embed"], tokens, cfg.dtype)
    x = _stack_sweep(cfg, params, x, positions=lengths[:, None],
                     mode="decode", caches=caches, lengths=lengths,
                     kernels=kernels)
    return _head_out(cfg, params, x), caches
