"""Pipeline parallelism as a model execution mode (the port of
``repro/parallel/pp.py``).

The periodic stack is split over the ``pipe`` mesh axis (each stage owns
``n_periods / pipe`` periods) and run with the GPipe micro-batch schedule
built on LCX puts (:func:`repro_torch.parallel.pipeline.gpipe`).  Other
mesh axes carry no traffic in the region and change no value (the
reference's region replicates the activations over them), so they are
left unstacked.

Autograd through the schedule is GPipe training: the backward runs
through every tick's stage calls and the puts' permutations in reverse,
so ``torch.autograd.grad`` of :func:`pp_loss` is a pipeline-parallel
train step with no extra machinery.  Nothing on that path detaches: a
put's payload is the permuted activation itself (``ranks.permute``), a
completion hands it to the next tick as it is, and no executor step
writes into a tensor that autograd saved.

Restrictions (asserted, as in the reference): no prefix layers,
``n_periods % pipe == 0``, and no ``lcx`` MoE inside a stage.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ..models.common import PyTree, softmax_xent
from ..models.model import _embed_in, _head_out, layer_apply
from .pipeline import gpipe


def pp_apply_model(cfg: Any, params: PyTree, tokens: torch.Tensor, *,
                   mesh: Any, n_micro: int = 8,
                   impl: Optional[str] = None) -> torch.Tensor:
    """Pipeline-parallel forward.  tokens [B, S] -> logits [B, S, V]."""
    prefix, period, n_periods = cfg.scan_plan()
    assert not prefix, "PP demo requires a prefix-free layer plan"
    pipe = mesh.shape["pipe"]
    assert n_periods % pipe == 0, (n_periods, pipe)
    assert cfg.n_experts == 0 or cfg.moe_backend != "lcx", \
        "PP stages cannot nest the expert-parallel MoE; use " \
        "moe_backend='sort'"

    x = _embed_in(cfg, params, tokens, None)
    b, s, d = x.shape
    assert b % n_micro == 0, (b, n_micro)
    positions = torch.arange(s, dtype=torch.int32, device=x.device)
    micro = x.reshape(n_micro, b // n_micro, s, d)
    per_stage = n_periods // pipe
    stack = params["stack"]

    def stage_fn(stage, xm):
        # ``stage`` is this stage's index: its periods are a slice of the
        # port's list of periods, used in place with no stacked copy
        first = int(stage) * per_stage
        for p_period in stack[first:first + per_stage]:
            for j, spec in enumerate(period):
                xm, _ = layer_apply(cfg, spec, p_period[f"l{j}"], xm,
                                    positions=positions, mode="train",
                                    impl=impl)
        return xm

    out = gpipe(stage_fn, torch.arange(pipe), micro, axis="pipe")
    return _head_out(cfg, params, out[0].reshape(b, s, d))


def pp_loss(cfg: Any, params: PyTree, batch: Dict[str, torch.Tensor], *,
            mesh: Any, n_micro: int = 8) -> torch.Tensor:
    logits = pp_apply_model(cfg, params, batch["tokens"], mesh=mesh,
                            n_micro=n_micro)
    return softmax_xent(logits, batch["labels"])
