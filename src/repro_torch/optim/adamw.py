"""AdamW, the cosine schedule and global-norm clipping.

The port of ``repro/optim/adamw.py`` on one card.  The moments are kept
in ``opt_dtype`` (``cfg.opt_dtype``: f32 for fidelity, bf16 to fit large
models), the arithmetic is in f32, and the parameters are updated in
place.  The step count and the learning rate stay on the device as 0-d
tensors, so a train step never waits for the card.  The state nests
mirror the parameters' (``params["stack"]`` a list of per-period nests);
``checkpoint.store`` writes them in the reference's layout.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, List, Tuple

import torch

from ..models.common import PyTree, tree_leaves, tree_map


@dataclasses.dataclass
class AdamWState:
    step: torch.Tensor          # [] int32
    m: PyTree
    v: PyTree


def adamw_init(params: PyTree, dtype: torch.dtype = torch.float32
               ) -> AdamWState:
    zeros = lambda p: torch.zeros(p.shape, dtype=dtype,  # noqa: E731
                                  device=p.device)
    dev = next(tree_leaves(params)).device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      m=tree_map(zeros, params), v=tree_map(zeros, params))


def global_norm(tree: PyTree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


def clip_by_global_norm(grads: PyTree, max_norm: float
                        ) -> Tuple[PyTree, torch.Tensor]:
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), norm


def cosine_schedule(base_lr: float, warmup: int, total: int,
                    min_ratio: float = 0.1
                    ) -> Callable[[torch.Tensor], torch.Tensor]:
    def lr(step: torch.Tensor) -> torch.Tensor:
        step = step.float()
        warm = base_lr * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0,
                           1.0)
        cos = base_lr * (min_ratio + (1 - min_ratio)
                         * 0.5 * (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup, warm, cos)
    return lr


# the elements of a leaf that one pass of the update reads: its f32
# temporaries (about seven) then stay near 0.5 GB whatever the leaf's
# size, where a whole leaf's took ~26 GB for DeepSeek-V3's 926 M-element
# embedding and ran an 80 GB card out of memory.  The reference's update is
# one fused elementwise pass per leaf, which keeps no such temporaries
UPDATE_CHUNK = 1 << 24


def _chunks(t: torch.Tensor, rows: int) -> Tuple[torch.Tensor, ...]:
    """Views of ``t``'s blocks of ``rows`` rows along dim 0 (a 0-d ``t``
    whole)."""
    return t.split(rows) if t.dim() else (t,)


@torch.no_grad()
def adamw_update(params: PyTree, grads: PyTree, state: AdamWState, *,
                 lr: torch.Tensor, b1: float = 0.9, b2: float = 0.95,
                 eps: float = 1e-8, weight_decay: float = 0.1
                 ) -> Tuple[PyTree, AdamWState]:
    """One AdamW step: ``params`` and the moments are written in place
    and returned, with the new step count.  Each leaf is updated in blocks
    of rows of at most ``UPDATE_CHUNK`` elements (one row where a row is
    larger): the arithmetic is elementwise, so the result is the same."""
    step = state.step + 1
    bc1 = 1.0 - torch.pow(b1, step.float())
    bc2 = 1.0 - torch.pow(b2, step.float())
    leaves: List[Any] = [tree_leaves(t) for t in
                         (params, grads, state.m, state.v)]
    for tensors in zip(*leaves):
        p = tensors[0]
        rows = max(1, UPDATE_CHUNK * p.shape[0] // max(p.numel(), 1)) \
            if p.dim() else 1
        for p, g, m, v in zip(*(_chunks(t, rows) for t in tensors)):
            gf = g.float()
            m32 = m.float() * b1 + gf * (1 - b1)
            v32 = v.float() * b2 + torch.square(gf) * (1 - b2)
            mhat = m32 / bc1
            vhat = v32 / bc2
            delta = mhat / (torch.sqrt(vhat) + eps) + weight_decay * p.float()
            p.copy_(p.float() - lr * delta)
            m.copy_(m32)
            v.copy_(v32)
    return params, AdamWState(step=step, m=state.m, v=state.v)
