"""Shared model building blocks (plain functions on tensors).

The port of ``repro/models/common.py``.  Params are nested dicts of
tensors in the reference's layout: ``dense`` is ``x @ w`` with
``w [d_in, d_out]``, so weights cross over without transposes.  Init
draws from the same distributions as the reference with an explicit
``torch.Generator`` (the streams differ from ``jax.random``'s; tests
carry the reference's params over through numpy instead).  The casts
sit where the reference puts them: rmsnorm, RoPE and the SiLU of SwiGLU
run in float32.  The init functions return params only: the
reference's logical sharding ``dims`` are rebuilt from the leaf names
where they are asked for (``model.abstract_init``).

Params, optimizer state and checkpoints are nests of dicts, lists and
dataclasses with tensors at the leaves.  :func:`keyed_leaves` names each
leaf as ``jax.tree_util.keystr`` names it in the reference's tree, which
stacks the periodic body along a leading ``[n_periods]`` dim where the
port keeps a list of per-period nests.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch
import torch.nn.functional as F

PyTree = Any


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------
def _normal(gen: torch.Generator, shape: Tuple[int, ...], std: float,
            dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """N(0, std^2) in float32 on the generator's device, cast, moved.
    On the ``meta`` device nothing is drawn (``model.abstract_init``)."""
    if device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
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
# losses
# ---------------------------------------------------------------------------
def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean token cross-entropy; logits [..., V] reduced in f32."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = lse - ll
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)


# ---------------------------------------------------------------------------
# tree utilities
# ---------------------------------------------------------------------------
def merge(*pairs: Tuple[str, Tuple[PyTree, PyTree]]
          ) -> Tuple[Dict[str, PyTree], Dict[str, PyTree]]:
    """merge(("attn", (p, d)), ("mlp", (p, d))) -> ({...}, {...})"""
    params: Dict[str, PyTree] = {}
    dims: Dict[str, PyTree] = {}
    for name, (p, d) in pairs:
        params[name] = p
        dims[name] = d
    return params, dims


def param_count(params: PyTree) -> int:
    return sum(t.numel() for t in tree_leaves(params))


def param_bytes(params: PyTree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(params))


def tree_leaves(tree: PyTree):
    """Tensors of a nest of dicts, lists and dataclasses, in key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            yield from tree_leaves(t)
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            yield from tree_leaves(getattr(tree, f.name))
    else:
        yield tree


def tree_map(fn: Callable[..., Any], tree: PyTree, *rest: PyTree,
             is_leaf: Optional[Callable[[Any], bool]] = None) -> PyTree:
    """``fn`` over the leaves of ``tree`` (a nest of dicts and lists) and
    the matching leaves of ``rest`` (nests of the same structure), in
    :func:`tree_leaves`' order; ``is_leaf`` stops the descent at a
    sub-nest."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest),
                            is_leaf=is_leaf) for k in sorted(tree)}
    if isinstance(tree, list):
        return [tree_map(fn, t, *(r[i] for r in rest), is_leaf=is_leaf)
                for i, t in enumerate(tree)]
    return fn(tree, *rest)


def tree_unflatten(like: PyTree, leaves: List[Any]) -> PyTree:
    """The nest of ``like`` with ``leaves`` (in :func:`tree_leaves`'
    order) at its leaves."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def keyed_leaves(tree: PyTree, prefix: str = ""
                 ) -> Iterator[Tuple[str, Any]]:
    """(name, leaf) for each leaf of the reference's layout of ``tree``.
    ``name`` is ``jax.tree_util.keystr`` of the leaf in the reference's
    tree: dict keys in sorted order as ``['key']``, a dataclass's fields
    (``AdamWState``: step, m, v) by position as ``[<flat index i>]``, the
    way JAX names the children of a node registered without keys.  A
    list of nests of one structure (``params["stack"]``, one nest per
    period) is one nest in the reference, each leaf stacked along a
    leading dim: its ``leaf`` is the list of the periods' tensors."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from keyed_leaves(tree[k], f"{prefix}[{k!r}]")
    elif isinstance(tree, list):
        per = [list(keyed_leaves(t, prefix)) for t in tree]
        for i, (name, _) in enumerate(per[0] if per else []):
            yield name, [p[i][1] for p in per]
    elif dataclasses.is_dataclass(tree):
        for i, f in enumerate(dataclasses.fields(tree)):
            yield from keyed_leaves(getattr(tree, f.name),
                                    f"{prefix}[<flat index {i}>]")
    else:
        yield prefix, tree
