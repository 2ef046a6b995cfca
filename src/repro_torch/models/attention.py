"""Grouped-query attention (GQA) with RoPE: train, prefill and decode.

The port of ``repro/models/attention.py`` for one card.  The
full-sequence path (:func:`attn_apply`) takes the ``kernel_fn`` hook
first (the flash kernel of :func:`repro_torch.kernels.model_kernels`;
training passes none, as the reference's does); without one it runs
``attention_full`` for ``s <= q_block`` and otherwise the chunked
online-softmax path.  Decode (:func:`attn_decode`) stays
plain PyTorch, as the reference computes it outside any kernel, and
takes one cache length per sequence so that slots at different fill
levels share one batch.

The chunked path keeps the reference's custom VJP as
:class:`_Flash`, a ``torch.autograd.Function``: the forward saves only
``(q, k, v, out, lse)`` and the backward recomputes each block's scores,
so training holds O(S) residuals per layer instead of every block's
probabilities.  ``attention_full`` stays plain autograd, as in the
reference.  The reference's sharding constraints are dropped (there is
no mesh on one card), and so is the sequence-sharded decode (it comes
with ``parallel/``).

Decode writes the new key/value row into the cache in place and returns
the same cache: the cache is the engine's largest buffer, and the
reference's functional update would copy it every token.
"""
from __future__ import annotations

import math
from typing import Any, Optional, Tuple

import torch

from .common import (PyTree, apply_rope, dense, dense_init, norm, norm_init,
                     rope_cos_sin)

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def attn_init(gen: torch.Generator, cfg: Any, device: torch.device
              ) -> PyTree:
    hd = cfg.head_dim
    kw = dict(dtype=cfg.param_dtype, device=device)
    p = {
        "wq": dense_init(gen, cfg.d_model, cfg.n_heads * hd,
                         bias=cfg.qkv_bias, **kw),
        "wk": dense_init(gen, cfg.d_model, cfg.n_kv_heads * hd,
                         bias=cfg.qkv_bias, **kw),
        "wv": dense_init(gen, cfg.d_model, cfg.n_kv_heads * hd,
                         bias=cfg.qkv_bias, **kw),
        "wo": dense_init(gen, cfg.n_heads * hd, cfg.d_model,
                         scale=1.0 / math.sqrt(cfg.n_heads * hd), **kw),
    }
    if cfg.qk_norm:
        p["qnorm"] = norm_init("rms", hd, **kw)
        p["knorm"] = norm_init("rms", hd, **kw)
    return p


# ---------------------------------------------------------------------------
# masking
# ---------------------------------------------------------------------------
def _mask_bias(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
               window: Optional[int],
               k_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[..., Q, K] additive bias in f32.  ``q_pos [..., Q]`` may carry a
    leading batch dim (one position per sequence in decode)."""
    qp = q_pos[..., :, None]
    kp = k_pos[..., None, :]
    ok = torch.ones(torch.broadcast_shapes(qp.shape, kp.shape),
                    dtype=torch.bool, device=q_pos.device)
    if causal:
        ok = ok & (qp >= kp)
    if window is not None:
        ok = ok & (qp - kp < window)
    if k_valid is not None:
        ok = ok & k_valid[..., None, :]
    zero = torch.zeros((), dtype=torch.float32, device=q_pos.device)
    return torch.where(ok, zero, torch.full_like(zero, NEG_INF))


# ---------------------------------------------------------------------------
# reference full attention (q [B,Q,Hq,Dk], k/v [B,K,Hkv,D*])
# ---------------------------------------------------------------------------
def _gqa_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """-> [B, Hkv, G, Q, K] grouped scores (f32 products and sums)."""
    b, qlen, hq, d = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, qlen, hkv, hq // hkv, d)
    return torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float())


def _gqa_out(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """p [B,Hkv,G,Q,K] (in v's dtype), v [B,K,Hkv,Dv] -> [B,Q,Hq,Dv]."""
    b, hkv, g, qlen, _ = p.shape
    out = torch.einsum("bhgqk,bkhd->bqhgd", p.float(), v.float())
    return out.to(v.dtype).reshape(b, qlen, hkv * g, v.shape[-1])


def attention_full(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   scale: float, causal: bool, window: Optional[int],
                   q_pos: torch.Tensor, k_pos: torch.Tensor,
                   k_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Scores ``[B,Hkv,G,Q,K]``; a mask built from ``[B, Q]`` positions
    broadcasts over the head dims."""
    s = _gqa_scores(q, k) * scale
    bias = _mask_bias(q_pos, k_pos, causal, window, k_valid)
    if bias.dim() == 3:                    # [B, Q, K] -> [B, 1, 1, Q, K]
        bias = bias[:, None, None]
    s = s + bias
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return _gqa_out(p, v)


# ---------------------------------------------------------------------------
# chunked online-softmax attention with a custom backward (the reference's
# ``_flash``).  Grouped layout: q [B,Hkv,G,S,Dk], k/v [B,Hkv,S,D*].
# ---------------------------------------------------------------------------
def _acc(t: torch.Tensor) -> torch.dtype:
    """The dtype the blocks are summed in: f32, or f64 for f64 inputs
    (``gradcheck``)."""
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def _flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               scale: float, causal: bool, window: Optional[int], bq: int,
               bk: int, n_keys: Optional[int] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (out [B,Hkv,G,S,Dv] in v's dtype, lse = m + log(l) [B,Hkv,G,S]
    in the blocks' dtype).  Keys at ``n_keys`` and beyond (a padded tail)
    are masked."""
    b, hkv, g, sq, dk = q.shape
    sk, dv = k.shape[2], v.shape[-1]
    nq, nk = sq // bq, sk // bk
    dev, f = q.device, _acc(q)
    # every q chunk at once (the reference vmaps over them)
    qb = q.reshape(b, hkv, g, nq, bq, dk).to(f)
    q_pos = torch.arange(sq, device=dev).reshape(nq, bq)
    acc = torch.zeros((b, hkv, g, nq, bq, dv), dtype=f, device=dev)
    m = torch.full((b, hkv, g, nq, bq), NEG_INF, dtype=f, device=dev)
    l = torch.zeros((b, hkv, g, nq, bq), dtype=f, device=dev)
    for kj in range(nk):
        kblk = k[:, :, kj * bk:(kj + 1) * bk]
        vblk = v[:, :, kj * bk:(kj + 1) * bk]
        k_pos = kj * bk + torch.arange(bk, device=dev)
        k_valid = None if n_keys is None else k_pos < n_keys
        s = torch.einsum("bhgnqd,bhkd->bhgnqk", qb, kblk.to(f)) * scale
        s = s + _mask_bias(q_pos, k_pos, causal, window, k_valid)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        pv = torch.einsum("bhgnqk,bhkd->bhgnqd", p.to(v.dtype).to(f),
                          vblk.to(f)).to(v.dtype)
        acc = acc * alpha[..., None] + pv
        m = m_new
    l_safe = torch.clamp(l, min=1e-30)
    out = (acc / l_safe[..., None]).to(v.dtype)
    lse = m + torch.log(l_safe)
    return out.reshape(b, hkv, g, sq, dv), lse.reshape(b, hkv, g, sq)


def _flash_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
               scale: float, causal: bool, window: Optional[int], bq: int,
               bk: int, n_keys: Optional[int]
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The reference's single-pass backward, every q chunk at once:
    ``Di = sum(dout * out)``, then per KV block ``p = exp(s - lse)``,
    ``dp = dout . v``, ``ds = p (dp - Di) scale``, and dq, dk, dv summed
    over the blocks.  A padded key gets p = 0; a padded query row gets
    ``dout = 0`` from the slice that drops it, so ``ds = 0`` there."""
    b, hkv, g, sq, dk = q.shape
    sk, dv = k.shape[2], v.shape[-1]
    nq, nk = sq // bq, sk // bk
    dev, f = q.device, _acc(q)
    qb = q.reshape(b, hkv, g, nq, bq, dk).to(f)
    dob = dout.reshape(b, hkv, g, nq, bq, dv).to(f)
    lseb = lse.reshape(b, hkv, g, nq, bq)
    di = (dob * out.reshape(b, hkv, g, nq, bq, dv).to(f)).sum(-1)
    q_pos = torch.arange(sq, device=dev).reshape(nq, bq)
    dq = torch.zeros((b, hkv, g, nq, bq, dk), dtype=f, device=dev)
    dks, dvs = [], []
    for kj in range(nk):
        kblk = k[:, :, kj * bk:(kj + 1) * bk].to(f)
        vblk = v[:, :, kj * bk:(kj + 1) * bk].to(f)
        k_pos = kj * bk + torch.arange(bk, device=dev)
        k_valid = None if n_keys is None else k_pos < n_keys
        s = torch.einsum("bhgnqd,bhkd->bhgnqk", qb, kblk) * scale
        s = s + _mask_bias(q_pos, k_pos, causal, window, k_valid)
        p = torch.exp(s - lseb[..., None])
        dp = torch.einsum("bhgnqd,bhkd->bhgnqk", dob, vblk)
        ds = p * (dp - di[..., None]) * scale
        dq = dq + torch.einsum("bhgnqk,bhkd->bhgnqd", ds, kblk)
        dvs.append(torch.einsum("bhgnqk,bhgnqd->bhkd", p, dob))
        dks.append(torch.einsum("bhgnqk,bhgnqd->bhkd", ds, qb))
    return (dq.reshape(b, hkv, g, sq, dk).to(q.dtype),
            torch.cat(dks, dim=2).to(k.dtype),
            torch.cat(dvs, dim=2).to(v.dtype))


class _Flash(torch.autograd.Function):
    """The chunked attention with the reference's custom VJP: the forward
    saves ``(q, k, v, out, lse)``, the backward recomputes the blocks."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, window, bq, bk, n_keys):
        out, lse = _flash_fwd(q, k, v, scale, causal, window, bq, bk,
                              n_keys)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (scale, causal, window, bq, bk, n_keys)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd(q, k, v, out, lse, dout, *ctx.args)
        return dq, dk, dv, None, None, None, None, None, None


def attention_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      scale: float, causal: bool, window: Optional[int],
                      q_block: int, k_block: int) -> torch.Tensor:
    """Model layout.  q [B,S,Hq,Dk], k/v [B,S,Hkv,D*] (positions are
    arange(S)) -> [B,S,Hq,Dv].

    The reference takes blocks of gcd(S, block) rows, which for an odd S
    are single rows: one step of its compiled scan each, but here one
    Python step of ~20 launches each.  The port keeps blocks of
    min(S, block) rows instead, pads S to a multiple of them and masks
    the padded keys: the same function, summed over other blocks."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    bq, bk = min(s, q_block), min(s, k_block)
    step = math.lcm(bq, bk)
    sp = -(-s // step) * step
    if sp > s:
        pad = lambda t: torch.nn.functional.pad(t, (0, 0, 0, 0, 0, sp - s))
        q, k, v = pad(q), pad(k), pad(v)
    qg = q.reshape(b, sp, hkv, g, d).permute(0, 2, 3, 1, 4)
    kg = k.transpose(1, 2)
    vg = v.transpose(1, 2)
    out = _Flash.apply(qg, kg, vg, scale, causal, window, bq, bk,
                       s if sp > s else None)
    out = out.permute(0, 3, 1, 2, 4).reshape(b, sp, hq, v.shape[-1])
    return out[:, :s]


# ---------------------------------------------------------------------------
# layer application
# ---------------------------------------------------------------------------
def _project_qkv(cfg: Any, p: PyTree, x: torch.Tensor,
                 positions: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x [B,S,D]; positions [S] or [B,S]."""
    b, s, _ = x.shape
    hd = cfg.head_dim
    q = dense(p["wq"], x).reshape(b, s, cfg.n_heads, hd)
    k = dense(p["wk"], x).reshape(b, s, cfg.n_kv_heads, hd)
    v = dense(p["wv"], x).reshape(b, s, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = norm("rms", p["qnorm"], q, cfg.norm_eps)
        k = norm("rms", p["knorm"], k, cfg.norm_eps)
    cos, sin = rope_cos_sin(positions, hd, cfg.rope_theta)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def attn_apply(cfg: Any, p: PyTree, x: torch.Tensor, *,
               positions: torch.Tensor, impl: str = "chunked",
               kernel_fn: Any = None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full-sequence (prefill) attention.  x [B,S,D] -> (y [B,S,D], and
    the roped k and v [B,S,Hkv,hd] that prefill writes to the cache; the
    reference computes them a second time for that)."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(cfg, p, x, positions)
    scale = 1.0 / math.sqrt(cfg.head_dim)
    if kernel_fn is not None:
        out = kernel_fn(q, k, v, causal=cfg.causal, scale=scale)
    elif impl == "full" or s <= cfg.q_block:
        out = attention_full(q, k, v, scale=scale, causal=cfg.causal,
                             window=cfg.sliding_window, q_pos=positions,
                             k_pos=positions)
    else:
        out = attention_chunked(q, k, v, scale=scale, causal=cfg.causal,
                                window=cfg.sliding_window,
                                q_block=cfg.q_block, k_block=cfg.q_block)
    y = dense(p["wo"], out.reshape(b, s, cfg.n_heads * cfg.head_dim))
    return y, k, v


# ---------------------------------------------------------------------------
# decode with KV cache
# ---------------------------------------------------------------------------
def attn_cache_init(cfg: Any, batch: int, max_seq: int,
                    dtype: Optional[torch.dtype] = None,
                    device: torch.device = torch.device("cpu")) -> PyTree:
    dtype = dtype or cfg.dtype
    shape = (batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def attn_decode(cfg: Any, p: PyTree, x: torch.Tensor, cache: PyTree,
                lengths: torch.Tensor) -> Tuple[torch.Tensor, PyTree]:
    """One decode step.  x [B,1,D]; cache k/v [B,Smax,Hkv,hd]; lengths
    [B] (tokens already in each sequence's cache).  Writes row
    ``lengths[i]`` of sequence i in place; returns (y [B,1,D], cache)."""
    b = x.shape[0]
    positions = lengths.to(torch.int32)[:, None]            # [B, 1]
    q, k_new, v_new = _project_qkv(cfg, p, x, positions)
    k, v = cache["k"], cache["v"]
    smax = k.shape[1]
    rows = torch.arange(b, device=x.device)
    # the reference's dynamic_update_slice clamps the start into range
    at = torch.clamp(lengths.long(), 0, smax - 1)
    k[rows, at] = k_new[:, 0].to(k.dtype)
    v[rows, at] = v_new[:, 0].to(v.dtype)
    k_pos = torch.arange(smax, dtype=torch.int32, device=x.device)
    k_valid = k_pos[None, :] <= lengths[:, None]            # [B, Smax]
    scale = 1.0 / math.sqrt(cfg.head_dim)
    out = attention_full(q, k.to(x.dtype), v.to(x.dtype), scale=scale,
                         causal=False, window=cfg.sliding_window,
                         q_pos=positions, k_pos=k_pos, k_valid=k_valid)
    y = dense(p["wo"], out.reshape(b, 1, cfg.n_heads * cfg.head_dim))
    return y, cache
