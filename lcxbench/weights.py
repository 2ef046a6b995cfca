"""Random weights of a configuration, drawn from the seed on the device.

The nest is the layout the program reads and the plain references read
too: ``embed.emb [V, d]``; ``prefix_<i>`` for the leading dense layers of
an expert model; ``stack``, a list with one ``{"l0": layer}`` per layer
after them; ``final_norm.g``; ``head.w [d, V]``.  A layer is ``norm1``,
``mixer`` (GQA: ``wq wk wv wo``; MLA: ``w_dq qnorm w_uq w_dkv kvnorm w_uk
w_uv wo``), ``norm2`` and ``ffn`` (dense: ``gate up down``; experts:
``router`` in float32, ``w_gate w_up w_down`` stacked ``[E, ...]``,
``shared_gate shared_up shared_down``).  A dense weight is ``{"w": [d_in,
d_out]}`` applied as ``x @ w``.

The draw: every normal weight of the served dtype lies in one flat
buffer, filled by ``normal_`` from one generator on the device in chunks
of 2^30 values, and scaled by its standard deviation (1 / sqrt(d_in); the
embedding 0.02) one run of equal deviations at a time; the leaves are
views of it.  Norm gains are ones.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import torch

CHUNK = 1 << 30

Leaf = Tuple[Tuple[Any, ...], Tuple[int, ...], str, float]


def _dense(path, d_in, d_out) -> Leaf:
    return (path + ("w",), (d_in, d_out), "normal", 1.0 / math.sqrt(d_in))


def _norm(path, d) -> Leaf:
    return (path + ("g",), (d,), "ones", 1.0)


def _mixer(cfg: Dict, p) -> List[Leaf]:
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    if cfg.get("kv_lora_rank"):
        ql, kl = cfg["q_lora_rank"], cfg["kv_lora_rank"]
        nope, rope = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
        v = cfg["v_head_dim"]
        return [_dense(p + ("w_dq",), d, ql), _norm(p + ("qnorm",), ql),
                _dense(p + ("w_uq",), ql, h * (nope + rope)),
                _dense(p + ("w_dkv",), d, kl + rope),
                _norm(p + ("kvnorm",), kl),
                _dense(p + ("w_uk",), kl, h * nope),
                _dense(p + ("w_uv",), kl, h * v),
                _dense(p + ("wo",), h * v, d)]
    hd = cfg.get("head_dim") or d // h
    hkv = cfg["num_key_value_heads"]
    return [_dense(p + ("wq",), d, h * hd), _dense(p + ("wk",), d, hkv * hd),
            _dense(p + ("wv",), d, hkv * hd), _dense(p + ("wo",), h * hd, d)]


def _ffn(cfg: Dict, p, moe: bool) -> List[Leaf]:
    d = cfg["hidden_size"]
    if not moe:
        f = cfg["intermediate_size"]
        return [_dense(p + ("gate",), d, f), _dense(p + ("up",), d, f),
                _dense(p + ("down",), f, d)]
    e, f = cfg["n_routed_experts"], cfg["moe_intermediate_size"]
    fs = cfg.get("n_shared_experts", 0) * f
    out = [(p + ("router", "w"), (d, e), "router", 1.0 / math.sqrt(d)),
           (p + ("w_gate", "w"), (e, d, f), "normal", 1.0 / math.sqrt(d)),
           (p + ("w_up", "w"), (e, d, f), "normal", 1.0 / math.sqrt(d)),
           (p + ("w_down", "w"), (e, f, d), "normal", 1.0 / math.sqrt(f))]
    if fs:
        out += [_dense(p + ("shared_gate",), d, fs),
                _dense(p + ("shared_up",), d, fs),
                _dense(p + ("shared_down",), fs, d)]
    return out


def leaves(cfg: Dict) -> List[Leaf]:
    """(path, shape, kind, std) of every weight; kind is ``normal`` (the
    served dtype), ``router`` (float32 normal) or ``ones``."""
    d, v = cfg["hidden_size"], cfg["vocab_size"]
    out: List[Leaf] = [(("embed", "emb"), (v, d), "normal", 0.02)]
    moe = bool(cfg.get("n_routed_experts"))
    k = cfg.get("first_k_dense_replace", 0) if moe else 0
    for i in range(cfg["num_hidden_layers"]):
        p = (f"prefix_{i}",) if i < k else ("stack", i - k, "l0")
        out += [_norm(p + ("norm1",), d)] + _mixer(cfg, p + ("mixer",))
        out += [_norm(p + ("norm2",), d)] + _ffn(cfg, p + ("ffn",),
                                                 moe and i >= k)
    out += [_norm(("final_norm",), d), _dense(("head",), d, v)]
    return out


def _put(tree: Dict, path, value) -> None:
    node = tree
    for key, nxt in zip(path[:-1], path[1:]):
        if isinstance(key, int):
            while len(node) <= key:
                node.append({})
            node = node[key]
        else:
            node = node.setdefault(key, [] if isinstance(nxt, int) else {})
    node[path[-1]] = value


def _flat(specs, dtype, device, gen) -> List[torch.Tensor]:
    """Views of one buffer, normal draws scaled per run of equal std."""
    n = sum(math.prod(s) for _, s, _, _ in specs)
    buf = torch.empty(n, dtype=dtype, device=device)
    for i in range(0, n, CHUNK):
        buf[i:i + CHUNK].normal_(0.0, 1.0, generator=gen)
    views, at, run_at, run_std = [], 0, 0, None
    for _, shape, _, std in specs:
        if std != run_std:
            if run_std is not None:
                buf[run_at:at].mul_(run_std)
            run_at, run_std = at, std
        size = math.prod(shape)
        views.append(buf[at:at + size].view(shape))
        at += size
    if run_std is not None:
        buf[run_at:at].mul_(run_std)
    return views


def draw(cfg: Dict, seed: int, device, dtype: torch.dtype) -> Dict:
    """The weights of ``cfg`` from ``seed``, on ``device``, normal weights
    in ``dtype``."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed % 2 ** 63)
    specs = leaves(cfg)
    params: Dict = {}
    normal = sorted((s for s in specs if s[2] == "normal"),
                    key=lambda s: s[3])
    for spec, t in zip(normal, _flat(normal, dtype, device, gen)):
        _put(params, spec[0], t)
    router = [s for s in specs if s[2] == "router"]
    for spec, t in zip(router, _flat(router, torch.float32, device, gen)):
        _put(params, spec[0], t)
    for path, shape, kind, _ in specs:
        if kind == "ones":
            _put(params, path, torch.ones(shape, dtype=dtype, device=device))
    return params


def flatten(tree, prefix=()) -> Dict[Tuple, torch.Tensor]:
    """{path: tensor} of a nest of dicts and lists."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten(v, prefix + (k,)))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            out.update(flatten(v, prefix + (i,)))
    else:
        out[prefix] = tree
    return out
