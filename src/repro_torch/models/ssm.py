"""Mamba-2 (SSD, state-space duality) mixer.

The port of ``repro/models/ssm.py``.  Prefill uses the chunked SSD
algorithm (:func:`ssd_chunked`): the within-chunk quadratic term, the
inter-chunk state recurrence as a Python loop over chunks, and the
carried state's offset.  All decay arithmetic is in f32; the decays are
``exp`` of non-positive sums.  With a ``kernel_fn`` hook (the SSD-scan
kernel of :func:`repro_torch.kernels.model_kernels`) :func:`ssm_apply`
takes the kernel instead.

Decode (:func:`ssm_decode`) carries ``conv [B, k-1, conv_ch]`` and
``h [B, H, N, P]`` and costs O(1) per token.  It stays plain PyTorch, as
the reference computes it outside any kernel, and, like the attention
layers' decode, it updates the cache in place.

The reference's sharding constraints are dropped: one card has no mesh.
"""
from __future__ import annotations

import math
from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels.ssd_scan import ssd_scan_plain
from .common import PyTree, _normal, dense, dense_init, rmsnorm


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def ssm_init(gen: torch.Generator, cfg: Any, device: torch.device
             ) -> PyTree:
    D, di = cfg.d_model, cfg.ssm_d_inner
    G, N, H = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    conv_ch = di + 2 * G * N
    kw = dict(dtype=cfg.param_dtype, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "in_proj": dense_init(gen, D, 2 * di + 2 * G * N + H, **kw),
        "out_proj": dense_init(gen, di, D, scale=1.0 / math.sqrt(di), **kw),
        "conv_w": _normal(gen, (cfg.ssm_conv, conv_ch),
                          1.0 / math.sqrt(cfg.ssm_conv), cfg.param_dtype,
                          device),
        "conv_b": torch.zeros((conv_ch,), **kw),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, **f32)),
        "D": torch.ones((H,), **f32),
        "dt_bias": torch.log(torch.exp(torch.linspace(1e-3, 0.1, H, **f32))
                             - 1.0),
        "norm_g": torch.ones((di,), **kw),
    }


# ---------------------------------------------------------------------------
# pieces
# ---------------------------------------------------------------------------
def _split_proj(cfg: Any, zxbcdt: torch.Tensor):
    di, G, N, H = (cfg.ssm_d_inner, cfg.ssm_groups, cfg.ssm_state,
                   cfg.ssm_heads)
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di: 2 * di + 2 * G * N]
    dt = zxbcdt[..., 2 * di + 2 * G * N:]
    return z, xbc, dt, (di, G, N, H)


def _causal_conv(p: PyTree, xbc: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over S.  xbc [B, S, C].  The reference's
    shifted sum in x's dtype (``F.conv1d`` sums in another order, and in
    f32 goes through cuDNN, in TF32 unless that is switched off), then
    SiLU in f32."""
    k, s = p["conv_w"].shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = pad[:, 0: s, :] * p["conv_w"][0].to(xbc.dtype)
    for i in range(1, k):
        out = out + pad[:, i: i + s, :] * p["conv_w"][i].to(xbc.dtype)
    return F.silu((out + p["conv_b"].to(xbc.dtype)).float()).to(xbc.dtype)


def _heads(cfg: Any, xbc: torch.Tensor):
    """Split the conv output into x [B,S,H,P] and B/C [B,S,H,N], each
    group's B/C repeated over its H // G heads as the reference's
    ``jnp.repeat`` does.  All three are views of ``xbc`` where they can
    be: with one group (mamba2-130m) B/C have stride 0 over the heads,
    and the SSD-scan kernel reads them so, without copies."""
    di, G, N, H = (cfg.ssm_d_inner, cfg.ssm_groups, cfg.ssm_state,
                   cfg.ssm_heads)
    b, s, _ = xbc.shape
    x = xbc[..., :di].reshape(b, s, H, cfg.ssm_head_dim)

    def per_head(t: torch.Tensor) -> torch.Tensor:
        return (t.reshape(b, s, G, 1, N).expand(b, s, G, H // G, N)
                .reshape(b, s, H, N))

    return (x, per_head(xbc[..., di: di + G * N]),
            per_head(xbc[..., di + G * N:]))


# ---------------------------------------------------------------------------
# chunked SSD (full sequence)
# ---------------------------------------------------------------------------
def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, chunk: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B,S,H,P]; dt [B,S,H] (post-softplus); A [H] (negative); B/C
    [B,S,H,N].  Returns (y [B,S,H,P], h_final [B,H,N,P]).

    The chunk is halved until it divides S, as the reference does (down
    to one-row chunks for a prime S), so that both sum alike; then the
    three phases run as the kernel's plain version runs them.  (The
    reference's ``h0`` argument, which no caller passes, is dropped.)"""
    s = x.shape[1]
    cs = min(chunk, s)
    while s % cs:
        cs //= 2
    return ssd_scan_plain(x, dt, A, Bm, Cm, chunk=cs)


def ssm_apply(cfg: Any, p: PyTree, x: torch.Tensor, *,
              return_cache: bool = False, kernel_fn: Any = None
              ) -> Tuple[torch.Tensor, Optional[PyTree]]:
    """Full-sequence mixer.  x [B,S,D] -> [B,S,D], and with
    ``return_cache`` the decode cache (final state and conv tail: the
    prefill path)."""
    b, s, _ = x.shape
    z, xbc_raw, dt_raw, (di, G, N, H) = _split_proj(
        cfg, dense(p["in_proj"], x))
    xh, Bm, Cm = _heads(cfg, _causal_conv(p, xbc_raw))
    # F.softplus returns x itself above its threshold of 20, where
    # jax.nn.softplus adds log1p(exp(-x)): under 2e-9, below float32's
    # resolution of such values
    dt = F.softplus(dt_raw.float() + p["dt_bias"])          # [B,S,H]
    A = -torch.exp(p["A_log"])
    if kernel_fn is not None:
        y, h_final = kernel_fn(xh, dt, A, Bm, Cm, chunk=cfg.ssm_chunk)
    else:
        y, h_final = ssd_chunked(xh, dt, A, Bm, Cm, cfg.ssm_chunk)
    y = y + xh * p["D"][:, None].to(x.dtype)
    y = y.reshape(b, s, di)
    y = y * F.silu(z.float()).to(x.dtype)
    out = dense(p["out_proj"], rmsnorm({"g": p["norm_g"]}, y, cfg.norm_eps))
    if not return_cache:
        return out, None
    k = cfg.ssm_conv
    tail = (xbc_raw[:, -(k - 1):, :] if s >= k - 1
            else F.pad(xbc_raw, (0, 0, k - 1 - s, 0)))
    return out, {"conv": tail.to(cfg.dtype), "h": h_final}


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------
def ssm_cache_init(cfg: Any, batch: int, *, device: torch.device
                   ) -> PyTree:
    """``conv`` in ``cfg.dtype``, ``h`` in f32.  (The reference's
    ``dtype`` argument, which no caller passes, is dropped.)"""
    conv_ch = cfg.ssm_d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_ch),
                            dtype=cfg.dtype, device=device),
        "h": torch.zeros((batch, cfg.ssm_heads, cfg.ssm_state,
                          cfg.ssm_head_dim), dtype=torch.float32,
                         device=device),
    }


def ssm_cache_dims() -> PyTree:
    return {"conv": ("cache_batch", "conv_k", "ssm_conv_ch"),
            "h": ("cache_batch", "ssm_heads", "state", "head")}


def ssm_decode(cfg: Any, p: PyTree, x: torch.Tensor, cache: PyTree
               ) -> Tuple[torch.Tensor, PyTree]:
    """One token.  x [B,1,D] -> (y [B,1,D], cache), the cache's ``conv``
    and ``h`` updated in place."""
    b = x.shape[0]
    z, xbc_raw, dt_raw, (di, G, N, H) = _split_proj(
        cfg, dense(p["in_proj"], x))
    # conv over the cached window
    win = torch.cat([cache["conv"].to(x.dtype), xbc_raw], dim=1)
    k = p["conv_w"].shape[0]
    out = win[:, 0, :] * p["conv_w"][0].to(x.dtype)
    for i in range(1, k):
        out = out + win[:, i, :] * p["conv_w"][i].to(x.dtype)
    xbc = F.silu((out + p["conv_b"].to(x.dtype)).float()).to(x.dtype)
    xh, Bm, Cm = _heads(cfg, xbc[:, None, :])               # [B,1,H,*]
    dt = F.softplus(dt_raw.float() + p["dt_bias"])[:, 0]    # [B,H]
    A = -torch.exp(p["A_log"])
    f32 = torch.float32
    h = cache["h"] * torch.exp(dt * A)[..., None, None]
    h = h + torch.einsum("bh,bhn,bhp->bhnp", dt, Bm[:, 0].to(f32),
                         xh[:, 0].to(f32))
    y = torch.einsum("bhn,bhnp->bhp", Cm[:, 0].to(f32), h)
    y = y.to(x.dtype) + xh[:, 0] * p["D"][:, None].to(x.dtype)
    y = y.reshape(b, 1, di)
    y = y * F.silu(z.float()).to(x.dtype)
    y = rmsnorm({"g": p["norm_g"]}, y, cfg.norm_eps)
    cache["conv"].copy_(win[:, 1:, :])
    cache["h"].copy_(h)
    return dense(p["out_proj"], y), cache
