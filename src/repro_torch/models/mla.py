"""Multi-head Latent Attention (DeepSeek-V2/V3).

The port of ``repro/models/mla.py`` for one card.  Queries and
keys/values are projected through low-rank latents:

  q:   x -> w_dq [d, q_lora] -> rmsnorm -> w_uq [q_lora, H*(nope+rope)]
  kv:  x -> w_dkv [d, kv_lora + rope]   (k_rope is *shared* across heads)
       c_kv -> rmsnorm -> w_ukv [kv_lora, H*(nope+v)]

RoPE is applied only to the rope sub-dimensions.  The full-sequence path
(:func:`mla_apply`, prefill) up-projects keys and values and runs the
port's plain attention (``attention_full`` / ``attention_chunked``): the
reference gives MLA no flash hook, and its head dim (nope + rope = 192
for V3) is above the flash kernel's 128.  Decode (:func:`mla_decode`)
uses the **absorbed** formulation: ``w_uk`` is folded into the query and
``w_uv`` into the output so attention runs directly against the cached
latent, ``{ckv [B,Smax,kv_lora], krope [B,Smax,rope]}`` (576 values a
token for V3 instead of 32768).  The two compute the same function and
sum in different orders.

As in :mod:`.attention`, decode takes one cache length per sequence and
writes the new latent row into the cache in place.  Under a mesh whose
rules shard the cache's sequence over ``model`` the absorbed decode is
context-parallel (:func:`_mla_decode_sharded`, as
:func:`.attention.attn_decode_sharded`).  The reference's
tensor-parallel constraints change layout, not values, and have no
counterpart here.
"""
from __future__ import annotations

import math
from typing import Any, Tuple

import torch

from ..core import ranks
from ..parallel.sharding import active_mesh
from .attention import (NEG_INF, _flash_decode_combine, _local_row_update,
                        _seq_shards, _shard_offsets, attention_chunked,
                        attention_full, seq_sharded_decode)
from .common import PyTree, dense, dense_init, norm, norm_init, rope_cos_sin


def _rope_interleaved(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
                      ) -> torch.Tensor:
    """x [..., S, H, D] (D even), cos/sin [..., S, D/2]."""
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    c = cos[..., :, None, :]
    s = sin[..., :, None, :]
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c],
                     dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def mla_init(gen: torch.Generator, cfg: Any, device: torch.device) -> PyTree:
    H = cfg.n_heads
    qk = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    kw = dict(dtype=cfg.param_dtype, device=device)
    return {
        "w_dq": dense_init(gen, cfg.d_model, cfg.q_lora_rank, **kw),
        "qnorm": norm_init("rms", cfg.q_lora_rank, **kw),
        "w_uq": dense_init(gen, cfg.q_lora_rank, H * qk, **kw),
        "w_dkv": dense_init(gen, cfg.d_model,
                            cfg.kv_lora_rank + cfg.qk_rope_head_dim, **kw),
        "kvnorm": norm_init("rms", cfg.kv_lora_rank, **kw),
        "w_uk": dense_init(gen, cfg.kv_lora_rank, H * cfg.qk_nope_head_dim,
                           **kw),
        "w_uv": dense_init(gen, cfg.kv_lora_rank, H * cfg.v_head_dim, **kw),
        "wo": dense_init(gen, H * cfg.v_head_dim, cfg.d_model,
                         scale=1.0 / math.sqrt(H * cfg.v_head_dim), **kw),
    }


def _queries(cfg: Any, p: PyTree, x: torch.Tensor, positions: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions [S] or [B,S] -> (q_nope [B,S,H,nope], q_rope
    [B,S,H,rope])."""
    b, s, _ = x.shape
    H = cfg.n_heads
    qk = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    cq = norm("rms", p["qnorm"], dense(p["w_dq"], x), cfg.norm_eps)
    q = dense(p["w_uq"], cq).reshape(b, s, H, qk)
    q_nope = q[..., :cfg.qk_nope_head_dim]
    q_rope = q[..., cfg.qk_nope_head_dim:]
    cos, sin = rope_cos_sin(positions, cfg.qk_rope_head_dim, cfg.rope_theta)
    return q_nope, _rope_interleaved(q_rope, cos, sin)


def _latents(cfg: Any, p: PyTree, x: torch.Tensor, positions: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (c_kv [B,S,kv_lora] normed, k_rope [B,S,rope] roped)."""
    ckv_full = dense(p["w_dkv"], x)
    c_kv = norm("rms", p["kvnorm"], ckv_full[..., :cfg.kv_lora_rank],
                cfg.norm_eps)
    k_rope = ckv_full[..., cfg.kv_lora_rank:]
    cos, sin = rope_cos_sin(positions, cfg.qk_rope_head_dim, cfg.rope_theta)
    k_rope = _rope_interleaved(k_rope[..., None, :], cos, sin)[..., 0, :]
    return c_kv, k_rope


# ---------------------------------------------------------------------------
# full-sequence (prefill): up-project then standard attention
# ---------------------------------------------------------------------------
def mla_apply(cfg: Any, p: PyTree, x: torch.Tensor, *,
              positions: torch.Tensor, impl: str = "chunked"
              ) -> torch.Tensor:
    b, s, _ = x.shape
    H = cfg.n_heads
    q_nope, q_rope = _queries(cfg, p, x, positions)
    c_kv, k_rope = _latents(cfg, p, x, positions)
    k_nope = dense(p["w_uk"], c_kv).reshape(b, s, H, cfg.qk_nope_head_dim)
    v = dense(p["w_uv"], c_kv).reshape(b, s, H, cfg.v_head_dim)
    scale = 1.0 / math.sqrt(cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)
    # scores = nope + the rope part shared by every head
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[..., None, :].expand(
        b, s, H, cfg.qk_rope_head_dim)], dim=-1)
    if impl == "full" or s <= cfg.q_block:
        out = attention_full(q, k, v, scale=scale, causal=cfg.causal,
                             window=None, q_pos=positions, k_pos=positions)
    else:
        out = attention_chunked(q, k, v, scale=scale, causal=cfg.causal,
                                window=None, q_block=cfg.q_block,
                                k_block=cfg.q_block)
    return dense(p["wo"], out.reshape(b, s, H * cfg.v_head_dim))


# ---------------------------------------------------------------------------
# decode: absorbed matmuls against the latent cache
# ---------------------------------------------------------------------------
def mla_cache_init(cfg: Any, batch: int, max_seq: int,
                   dtype: torch.dtype = None,
                   device: torch.device = torch.device("cpu")) -> PyTree:
    dtype = dtype or cfg.dtype
    return {"ckv": torch.zeros((batch, max_seq, cfg.kv_lora_rank),
                               dtype=dtype, device=device),
            "krope": torch.zeros((batch, max_seq, cfg.qk_rope_head_dim),
                                 dtype=dtype, device=device)}


def mla_cache_dims() -> PyTree:
    return {"ckv": ("cache_batch", "cache_seq", "kv_lora"),
            "krope": ("cache_batch", "cache_seq", "head")}


def mla_decode(cfg: Any, p: PyTree, x: torch.Tensor, cache: PyTree,
               lengths: torch.Tensor) -> Tuple[torch.Tensor, PyTree]:
    """One decode step with the absorbed formulation.  x [B,1,D]; lengths
    [B] (tokens already in each sequence's cache); writes row
    ``lengths[i]`` of sequence i in place.

    scores = q_nope @ w_uk^T @ ckv  +  q_rope @ k_rope
    out    = (attn @ ckv) @ w_uv
    """
    b = x.shape[0]
    H = cfg.n_heads
    positions = lengths.to(torch.int32)[:, None]            # [B, 1]
    q_nope, q_rope = _queries(cfg, p, x, positions)          # [B,1,H,*]
    c_new, kr_new = _latents(cfg, p, x, positions)           # [B,1,*]
    if seq_sharded_decode(cache["ckv"].shape[1]):
        return _mla_decode_sharded(cfg, p, x, q_nope, q_rope, c_new, kr_new,
                                   cache, lengths)
    ckv, krope = cache["ckv"], cache["krope"]
    smax = ckv.shape[1]
    rows = torch.arange(b, device=x.device)
    # the reference's dynamic_update_slice clamps the start into range
    at = torch.clamp(lengths.long(), 0, smax - 1)
    ckv[rows, at] = c_new[:, 0].to(ckv.dtype)
    krope[rows, at] = kr_new[:, 0].to(krope.dtype)

    # absorb w_uk into the query: q_lat [B,1,H,kv_lora]
    wuk = p["w_uk"]["w"].reshape(cfg.kv_lora_rank, H, cfg.qk_nope_head_dim)
    q_lat = torch.einsum("bqhd,lhd->bqhl", q_nope, wuk.to(x.dtype))
    s_nope = torch.einsum("bqhl,bkl->bhqk", q_lat.float(), ckv.float())
    s_rope = torch.einsum("bqhd,bkd->bhqk", q_rope.float(), krope.float())
    scale = 1.0 / math.sqrt(cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)
    s = (s_nope + s_rope) * scale                            # [B,H,1,Smax]
    k_valid = (torch.arange(smax, device=x.device)[None, :]
               <= lengths[:, None])                          # [B, Smax]
    s = s.masked_fill(~k_valid[:, None, None, :], NEG_INF)
    pattn = torch.softmax(s, dim=-1).to(x.dtype)
    o_lat = torch.einsum("bhqk,bkl->bqhl", pattn.float(),
                         ckv.float()).to(x.dtype)
    wuv = p["w_uv"]["w"].reshape(cfg.kv_lora_rank, H, cfg.v_head_dim)
    out = torch.einsum("bqhl,lhd->bqhd", o_lat, wuv.to(x.dtype))
    y = dense(p["wo"], out.reshape(b, 1, H * cfg.v_head_dim))
    return y, cache


def _mla_decode_sharded(cfg: Any, p: PyTree, x: torch.Tensor,
                        q_nope: torch.Tensor, q_rope: torch.Tensor,
                        c_new: torch.Tensor, kr_new: torch.Tensor,
                        cache: PyTree, lengths: torch.Tensor
                        ) -> Tuple[torch.Tensor, PyTree]:
    """Context-parallel absorbed decode: the latent cache stays sharded
    along its sequence over ``model``; each rank writes the rows in its
    shard and computes a partial softmax, combined flash-decoding style
    (see :func:`.attention.attn_decode_sharded`).  Returns (y [B,1,D],
    the cache written in place)."""
    n = active_mesh().shape["model"]
    b = x.shape[0]
    H = cfg.n_heads
    wuk = p["w_uk"]["w"].reshape(cfg.kv_lora_rank, H, cfg.qk_nope_head_dim)
    q_lat = torch.einsum("bqhd,lhd->bqhl", q_nope, wuk.to(x.dtype))
    scale = 1.0 / math.sqrt(cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)
    with ranks.bind_axis("model", n):
        ckv = _seq_shards(cache["ckv"], n)                   # [n,B,Sl,L]
        krope = _seq_shards(cache["krope"], n)
        pos, off, in_range = _shard_offsets(lengths, n, ckv.shape[2])
        _local_row_update(ckv, c_new[:, 0], off, in_range)
        _local_row_update(krope, kr_new[:, 0], off, in_range)
        s_nope = torch.einsum("bqhl,nbkl->nbhqk", q_lat.float(), ckv.float())
        s_rope = torch.einsum("bqhd,nbkd->nbhqk", q_rope.float(),
                              krope.float())
        s = (s_nope + s_rope) * scale                        # [n,B,H,1,Sl]
        valid = pos[:, None, :] <= lengths[None, :, None]    # [n, B, Sl]
        s = s.masked_fill(~valid[:, :, None, None, :], NEG_INF)
        m = s.amax(-1)
        pr = torch.exp(s - m[..., None])
        acc = torch.einsum("nbhqk,nbkl->nbhql", pr.to(ckv.dtype).float(),
                           ckv.float())
        o_lat = _flash_decode_combine(acc, m, pr.sum(-1))    # [B,H,1,L]
    o_lat = o_lat.transpose(1, 2).to(x.dtype)                # [B,1,H,L]
    wuv = p["w_uv"]["w"].reshape(cfg.kv_lora_rank, H, cfg.v_head_dim)
    out = torch.einsum("bqhl,lhd->bqhd", o_lat, wuv.to(x.dtype))
    y = dense(p["wo"], out.reshape(b, 1, H * cfg.v_head_dim))
    return y, cache
