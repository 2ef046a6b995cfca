"""Model flops, the trainer's yardstick of useful work.

The port of ``active_params`` and ``model_flops`` from
``repro/analysis/roofline.py``, with the reference's counting rule as it
is: embeddings are left out of the 6·N·D convention, and of the routed
experts only top-k of E count as active.  Leaves are named as the
reference names them (``models.common.keyed_leaves``), so a params nest
on the ``meta`` device (``models.abstract_init``) counts as the
reference's ``jax.eval_shape`` proto does.  The rest of the module (HLO
collectives, the roofline report) waits for the tooling slice.
"""
from __future__ import annotations

from typing import Any, Tuple

from ..models.common import keyed_leaves


def active_params(cfg: Any, params_proto: Any) -> Tuple[int, int]:
    """(total, active-per-token) parameter counts, embeddings excluded
    from the 6ND convention."""
    total = 0
    active = 0
    for name, leaf in keyed_leaves(params_proto):
        parts = leaf if isinstance(leaf, list) else [leaf]
        n = sum(t.numel() for t in parts)
        total += n
        if "embed" in name or "head" in name and "['head']" in name:
            continue
        if "ffn" in name and ("w_gate" in name or "w_up" in name
                              or "w_down" in name):
            # routed experts: only top-k of E active
            if cfg.n_experts:
                active += n * cfg.n_experts_per_tok // cfg.n_experts
            else:
                active += n
        else:
            active += n
    return total, active


def model_flops(cfg: Any, params_proto: Any, kind: str, seq_len: int,
                global_batch: int) -> float:
    """6·N_active·D for train, 2·N_active·D for inference (global)."""
    _, n_active = active_params(cfg, params_proto)
    if kind == "train":
        tokens = seq_len * global_batch
        return 6.0 * n_active * tokens
    if kind == "prefill":
        tokens = seq_len * global_batch
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * global_batch
