"""Grouped-query attention (GQA) with RoPE: train, prefill and decode.

The port of ``repro/models/attention.py`` for one card.  The
full-sequence path (:func:`attn_apply`) takes the ``kernel_fn`` hook
first (the flash kernel of :func:`repro_torch.kernels.model_kernels`;
training passes none, as the reference's does); without one it runs
``attention_full`` for ``s <= q_block`` and otherwise the chunked
online-softmax path (``impl="chunked"``, the default, or
``"chunked_causal_skip"``: the lower-triangular schedule that never
computes a block above the diagonal, :func:`_flash_causal_skip`).
Decode (:func:`attn_decode`) stays
plain PyTorch, as the reference computes it outside any kernel, and
takes one cache length per sequence so that slots at different fill
levels share one batch.  Under a mesh whose rules shard the cache's
sequence dim over ``model`` (``launch.steps.decode_rules``) decode is
context-parallel (:func:`attn_decode_sharded`): the cache is viewed as
``[n_ranks, ...]`` shards of its sequence, each rank writes its own row
and computes a partial softmax, and the partials are combined
flash-decoding style.

The chunked path keeps the reference's custom VJP as
:class:`_Flash`, a ``torch.autograd.Function``: the forward saves only
``(q, k, v, out, lse)`` and the backward recomputes each block's scores,
so training holds O(S) residuals per layer instead of every block's
probabilities.  ``attention_full`` stays plain autograd, as in the
reference.  The reference's sharding constraints change layout, not
values, so the port has none (``parallel/``); its chunked attention
keeps whole ``q_block`` blocks under a mesh too, where the reference's
take the size :func:`_pick_chunks` gives.

Decode writes the new key/value row into the cache in place and returns
the same cache: the cache is the engine's largest buffer, and the
reference's functional update would copy it every token.
"""
from __future__ import annotations

import math
from typing import Any, Optional, Tuple

import torch

from ..core import ranks
from ..parallel.sharding import active_mesh, active_rules
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
                      q_block: int, k_block: int,
                      causal_skip: bool = False) -> torch.Tensor:
    """Model layout.  q [B,S,Hq,Dk], k/v [B,S,Hkv,D*] (positions are
    arange(S)) -> [B,S,Hq,Dv].

    The reference takes blocks of gcd(S, block) rows, which for an odd S
    are single rows: one step of its compiled scan each, but here one
    Python step of ~20 launches each.  The port keeps blocks of
    min(S, block) rows instead, pads S to a multiple of them and masks
    the padded keys: the same function, summed over other blocks.

    ``causal_skip`` (with ``causal`` and no ``window``, as in the
    reference) takes :func:`_flash_causal_skip`, the lower-triangular
    schedule, in place of :class:`_Flash`."""
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
    if causal_skip and causal and window is None:
        out = _flash_causal_skip(qg, kg, vg, scale, bq, bk)
    else:
        out = _Flash.apply(qg, kg, vg, scale, causal, window, bq, bk,
                           s if sp > s else None)
    out = out.permute(0, 3, 1, 2, 4).reshape(b, sp, hq, v.shape[-1])
    return out[:, :s]


def _flash_causal_skip(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       scale: float, bq: int, bk: int) -> torch.Tensor:
    """The reference's unrolled lower-triangular schedule: q block ``qi``
    meets key blocks ``0 .. min(qi, nk - 1)`` and no block above the
    diagonal is computed.  Grouped layout q [B,Hkv,G,S,Dk], k/v
    [B,Hkv,S,D*] -> [B,Hkv,G,S,Dv].  Its gradient comes through plain
    autograd, as the reference's comes through plain autodiff (it is not
    :class:`_Flash`): the residuals are every visited block's, a
    triangle of them.

    The loop bound is the reference's, ``range(min(qi + 1, nk))``, which
    covers the causal keys only when ``bq == bk`` (what ``attn_apply``
    and ``mla_apply`` pass); with ``bk < bq`` it would drop keys below
    the diagonal.  It is followed as it is.  A padded tail needs no key
    mask here: a padded key lies after every real query, so the causal
    mask already hides it, and the padded query rows are cut off."""
    b, hkv, g, sq, dk = q.shape
    sk, dv = k.shape[2], v.shape[-1]
    nq, nk = sq // bq, sk // bk
    dev, f = q.device, _acc(q)
    outs = []
    for qi in range(nq):
        qblk = q[:, :, :, qi * bq:(qi + 1) * bq].to(f)
        q_pos = qi * bq + torch.arange(bq, device=dev)
        acc = torch.zeros((b, hkv, g, bq, dv), dtype=f, device=dev)
        m = torch.full((b, hkv, g, bq), NEG_INF, dtype=f, device=dev)
        l = torch.zeros((b, hkv, g, bq), dtype=f, device=dev)
        for kj in range(min(qi + 1, nk)):
            kblk = k[:, :, kj * bk:(kj + 1) * bk]
            vblk = v[:, :, kj * bk:(kj + 1) * bk]
            k_pos = kj * bk + torch.arange(bk, device=dev)
            s = torch.einsum("bhgqd,bhkd->bhgqk", qblk, kblk.to(f)) * scale
            s = s + _mask_bias(q_pos, k_pos, True, None)
            m_new = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * alpha + p.sum(dim=-1)
            pv = torch.einsum("bhgqk,bhkd->bhgqd", p.to(v.dtype).to(f),
                              vblk.to(f)).to(v.dtype)
            acc = acc * alpha[..., None] + pv
            m = m_new
        outs.append((acc / torch.clamp(l, min=1e-30)[..., None])
                    .to(v.dtype))
    return torch.cat(outs, dim=3)


def _tp_size() -> int:
    mesh = active_mesh()
    if mesh is None or "model" not in mesh.axis_names:
        return 1
    return int(mesh.shape["model"])


def _pick_chunks(s: int, block: int, tp: int) -> Tuple[int, int]:
    """The reference's block choice under a mesh: (n_chunks, block) such
    that n_chunks divides s, is a multiple of tp (so the chunk stack
    shards over ``model``), and the block is closest to the requested
    one; gcd blocking when no tp-aligned divisor exists.  The port's
    chunked attention keeps its padded ``q_block`` blocks instead (the
    same function, summed over other blocks)."""
    best = None
    d = 1
    while d * d <= s:
        if s % d == 0:
            for nq in (d, s // d):
                if nq % tp == 0 and s // nq >= 1:
                    # log-distance: 4 and 16384 are both "far" from 256
                    score = abs(math.log2(s / nq) - math.log2(block))
                    if best is None or score < best[0]:
                        best = (score, nq)
        d += 1
    if best is not None:
        nq = best[1]
        return nq, s // nq
    bq = max(1, math.gcd(s, block))
    return s // bq, bq


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
                                q_block=cfg.q_block, k_block=cfg.q_block,
                                causal_skip=(impl == "chunked_causal_skip"))
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


def attn_cache_dims() -> PyTree:
    return {"k": ("cache_batch", "cache_seq", "kv_heads", "head"),
            "v": ("cache_batch", "cache_seq", "kv_heads", "head")}


def seq_sharded_decode(smax: int) -> bool:
    """True when decode runs with the cache sharded along its sequence dim
    over ``model`` (context-parallel decode: set by
    ``launch.steps.decode_rules`` for configs whose KV-head count cannot
    shard the model axis, and always for MLA's head-less latent cache)."""
    mesh = active_mesh()
    if mesh is None or "model" not in mesh.axis_names:
        return False
    if mesh.shape["model"] <= 1 or smax % mesh.shape["model"]:
        return False
    return "model" in active_rules().get("cache_seq", ())


def _dp_prefix(mesh: Any, b: int) -> Optional[Tuple[str, ...]]:
    """The data axes that split a batch of ``b``: the longest prefix of
    (pod, data) whose product divides it."""
    axes = []
    prod = 1
    for a in ("pod", "data"):
        if a in mesh.shape and b % (prod * mesh.shape[a]) == 0:
            axes.append(a)
            prod *= mesh.shape[a]
        else:
            break
    return tuple(axes) if axes else None


def _seq_shards(buf: torch.Tensor, n: int) -> torch.Tensor:
    """``[B, Smax, ...]`` -> the view ``[n, B, Smax / n, ...]``: rank r's
    shard of every sequence (no copy)."""
    b, smax = buf.shape[:2]
    return buf.view((b, n, smax // n) + tuple(buf.shape[2:])).transpose(0, 1)


def _local_row_update(buf: torch.Tensor, row: torch.Tensor,
                      off: torch.Tensor, in_range: torch.Tensor) -> None:
    """Write sequence i's ``row[i]`` at local offset ``off[r, i]`` of rank
    r's shard iff ``in_range[r, i]``, in place: one row per rank and
    sequence (a full-buffer select would rewrite the cache every token).
    buf ``[n, B, S_loc, ...]`` (a view of the cache), row ``[B, ...]``,
    off / in_range ``[n, B]``."""
    n, b, s_loc = buf.shape[:3]
    r_idx = torch.arange(n, device=buf.device)[:, None].expand(n, b)
    b_idx = torch.arange(b, device=buf.device)[None, :].expand(n, b)
    at = off.clamp(0, s_loc - 1)
    cur = buf[r_idx, b_idx, at]                              # [n, B, ...]
    keep = in_range.reshape((n, b) + (1,) * (cur.dim() - 2))
    buf[r_idx, b_idx, at] = torch.where(keep, row.to(buf.dtype)[None], cur)


def _shard_offsets(lengths: torch.Tensor, n: int, s_loc: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(the global positions of each rank's rows [n, S_loc], each
    sequence's new row's offset in each rank's shard [n, B], whether it
    falls in that shard [n, B])."""
    start = torch.arange(n, device=lengths.device)[:, None] * s_loc
    off = lengths.long()[None, :] - start
    pos = start + torch.arange(s_loc, device=lengths.device)[None, :]
    return pos, off, (off >= 0) & (off < s_loc)


def _flash_decode_combine(acc: torch.Tensor, m: torch.Tensor,
                          l: torch.Tensor) -> torch.Tensor:
    """Flash-decoding softmax combine across the sequence shards: the
    rank-stacked partials acc ``[n, ..., dv]``, m / l ``[n, ...]`` (the
    reference's pmax / psum over the bound axis, whose result every rank
    of it holds)."""
    m_g = m.amax(0)
    corr = torch.exp(m - m_g)
    l_g = (l * corr).sum(0)
    acc_g = (acc * corr[..., None]).sum(0)
    return ranks.replicated(acc_g / torch.clamp(l_g, min=1e-30)[..., None])


def attn_decode_sharded(cfg: Any, q: torch.Tensor, k_new: torch.Tensor,
                        v_new: torch.Tensor, cache: PyTree,
                        lengths: torch.Tensor) -> Tuple[torch.Tensor, PyTree]:
    """Context-parallel decode: the cache stays sharded along its
    sequence over ``model``.  Each rank writes the rows that fall in its
    shard and computes a partial softmax over it; the partials are
    combined flash-decoding style.  q [B,1,Hq,hd], k_new / v_new
    [B,1,Hkv,hd], lengths [B] -> (out [B,1,Hq,hd], the cache written in
    place).  As in the reference's sharded decode, no window applies."""
    n = active_mesh().shape["model"]
    b, _, hq, hd = q.shape
    scale = 1.0 / math.sqrt(cfg.head_dim)
    with ranks.bind_axis("model", n):
        ck, cv = _seq_shards(cache["k"], n), _seq_shards(cache["v"], n)
        hkv = ck.shape[3]
        pos, off, in_range = _shard_offsets(lengths, n, ck.shape[2])
        _local_row_update(ck, k_new[:, 0], off, in_range)
        _local_row_update(cv, v_new[:, 0], off, in_range)
        qg = q.reshape(b, 1, hkv, hq // hkv, hd).float()
        s = torch.einsum("bqhgd,nbkhd->nbhgqk", qg, ck.float()) * scale
        valid = pos[:, None, :] <= lengths[None, :, None]    # [n, B, S_loc]
        s = s.masked_fill(~valid[:, :, None, None, None, :], NEG_INF)
        m = s.amax(-1)
        p = torch.exp(s - m[..., None])
        acc = torch.einsum("nbhgqk,nbkhd->nbhgqd",
                           p.to(cv.dtype).float(), cv.float())
        out = _flash_decode_combine(acc, m, p.sum(-1))       # [B,Hkv,G,1,dv]
    y = out.permute(0, 3, 1, 2, 4).reshape(b, 1, hq, out.shape[-1])
    return y.to(q.dtype), cache


def attn_decode(cfg: Any, p: PyTree, x: torch.Tensor, cache: PyTree,
                lengths: torch.Tensor) -> Tuple[torch.Tensor, PyTree]:
    """One decode step.  x [B,1,D]; cache k/v [B,Smax,Hkv,hd]; lengths
    [B] (tokens already in each sequence's cache).  Writes row
    ``lengths[i]`` of sequence i in place; returns (y [B,1,D], cache)."""
    b = x.shape[0]
    positions = lengths.to(torch.int32)[:, None]            # [B, 1]
    q, k_new, v_new = _project_qkv(cfg, p, x, positions)
    if seq_sharded_decode(cache["k"].shape[1]):
        out, cache = attn_decode_sharded(cfg, q, k_new, v_new, cache,
                                         lengths)
        y = dense(p["wo"], out.reshape(b, 1, cfg.n_heads * cfg.head_dim))
        return y, cache
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
