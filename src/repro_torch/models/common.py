"""Shared model building blocks (plain functions on tensors).

The port of ``repro/models/common.py``.  Params are nested dicts of
tensors in the reference's layout: ``dense`` is ``x @ w`` with
``w [d_in, d_out]``, so weights cross over without transposes.  Init
draws from the same distributions as the reference with an explicit
``torch.Generator`` (the streams differ from ``jax.random``'s; tests
carry the reference's params over through numpy instead).  The casts
sit where the reference puts them: rmsnorm, RoPE and the SiLU of SwiGLU
run in float32.  The reference's logical sharding ``dims`` are not
kept: the port runs on one card.
"""
from __future__ import annotations

import math
from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F

PyTree = Any


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------
def _normal(gen: torch.Generator, shape: Tuple[int, ...], std: float,
            dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """N(0, std^2) in float32 on the generator's device, cast, moved."""
    x = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32) * std
    return x.to(device=device, dtype=dtype)


def dense_init(gen: torch.Generator, d_in: int, d_out: int, *,
               bias: bool = False, scale: Optional[float] = None,
               dtype: torch.dtype = torch.float32,
               device: torch.device = torch.device("cpu")) -> PyTree:
    scale = (1.0 / math.sqrt(d_in)) if scale is None else scale
    p = {"w": _normal(gen, (d_in, d_out), scale, dtype, device)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return p


def dense(p: PyTree, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def embed_init(gen: torch.Generator, vocab: int, d: int, *,
               dtype: torch.dtype = torch.float32,
               device: torch.device = torch.device("cpu")) -> PyTree:
    return {"emb": _normal(gen, (vocab, d), 0.02, dtype, device)}


def embed(p: PyTree, tokens: torch.Tensor, dtype: torch.dtype
          ) -> torch.Tensor:
    return p["emb"][tokens].to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------
def rmsnorm_init(d: int, dtype: torch.dtype = torch.float32,
                 device: torch.device = torch.device("cpu")) -> PyTree:
    return {"g": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(p: PyTree, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    n = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (n * p["g"].float()).to(x.dtype)


def layernorm_init(d: int, dtype: torch.dtype = torch.float32,
                   device: torch.device = torch.device("cpu")) -> PyTree:
    return {"g": torch.ones((d,), dtype=dtype, device=device),
            "b": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm(p: PyTree, x: torch.Tensor, eps: float = 1e-5
              ) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    n = (xf - mu) * torch.rsqrt(var + eps)
    return (n * p["g"].float() + p["b"].float()).to(x.dtype)


def norm_init(kind: str, d: int, dtype: torch.dtype = torch.float32,
              device: torch.device = torch.device("cpu")) -> PyTree:
    return (rmsnorm_init(d, dtype, device) if kind == "rms"
            else layernorm_init(d, dtype, device))


def norm(kind: str, p: PyTree, x: torch.Tensor, eps: float) -> torch.Tensor:
    return rmsnorm(p, x, eps) if kind == "rms" else layernorm(p, x, eps)


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float,
               device: torch.device = torch.device("cpu")) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions [*S] -> cos, sin [*S, head_dim//2] (float32)."""
    ang = (positions.float()[..., None]
           * rope_freqs(head_dim, theta, positions.device))
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x [..., S, H, D]; cos/sin [..., S, D/2] (broadcast over heads)."""
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    c = cos[..., :, None, :]
    s = sin[..., :, None, :]
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c],
                     dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------
def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return F.silu(gate.float()).to(gate.dtype) * up


def gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x.float(), approximate="tanh").to(x.dtype)


# ---------------------------------------------------------------------------
# tree utilities
# ---------------------------------------------------------------------------
def param_count(params: PyTree) -> int:
    return sum(t.numel() for t in tree_leaves(params))


def param_bytes(params: PyTree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(params))


def tree_leaves(tree: PyTree):
    """Tensors of a nest of dicts and lists, in key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            yield from tree_leaves(t)
    else:
        yield tree
