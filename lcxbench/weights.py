"""Random weights of a configuration, drawn from the seed on the device.

The nest is the layout the program reads and the plain references read
too, as the configuration's family lays it out (``families.of(cfg).leaves``;
``families/decoder.py`` describes its own).  A dense weight is ``{"w":
[d_in, d_out]}`` applied as ``x @ w``; a norm gain is ``{"g": [d]}``.

A leaf is ``(path, shape, kind, std)``.  ``kind`` is ``normal`` (the
served dtype), ``float32`` (float32 normal: a router, an SSM's decay) or
``ones`` (the served dtype).  The draw: every normal
weight of the served dtype lies in one flat buffer, filled by ``normal_``
from one generator on the device in chunks of 2^30 values, and scaled by
its standard deviation one run of equal deviations at a time; the leaves
are views of it; then the float32 ones alike from the same generator.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import torch

from . import families

CHUNK = 1 << 30

Leaf = Tuple[Tuple[Any, ...], Tuple[int, ...], str, float]


def dense(path, d_in, d_out) -> Leaf:
    """A dense weight ``[d_in, d_out]``, its deviation 1 / sqrt(d_in)."""
    return (path + ("w",), (d_in, d_out), "normal", 1.0 / math.sqrt(d_in))


def norm(path, d) -> Leaf:
    """A norm gain of ones."""
    return (path + ("g",), (d,), "ones", 1.0)


def leaves(cfg: Dict) -> List[Leaf]:
    """(path, shape, kind, std) of every weight of ``cfg``'s family."""
    return families.of(cfg).leaves(cfg)


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
    f32 = [s for s in specs if s[2] == "float32"]
    for spec, t in zip(f32, _flat(f32, torch.float32, device, gen)):
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
