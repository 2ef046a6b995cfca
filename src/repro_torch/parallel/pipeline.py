"""Pipeline parallelism as an AMT task graph over LCX (GPipe schedule),
the port of ``repro/parallel/pipeline.py``.

The paper's AMT communication pattern, many fine-grained asynchronous
point-to-point transfers with explicit completion, is the inter-stage
traffic of a pipeline.  The GPipe schedule is a
:class:`repro_torch.amt.TaskGraph`: every tick of the schedule is a task
(the stage x micro-batch cells computed that tick), and every
inter-stage activation transfer is an edge realised as an LCX ``put``
whose completion resumes the suspended tick through the executor's
completion queue.

Rank-stacked (``parallel/__init__.py``): the stages are the ranks of the
``pipe`` axis, bound with ``ranks.bind_axis`` for the schedule.
``stage_params``' leaves are ``[n_stages, ...]``; ``stage_fn`` keeps
the reference's per-rank signature ``stage_fn(params_of_one_stage, x)``
and runs once per stage and tick.  A tick's put carries every stage's
activation ``[n_stages, mb, ...]`` one stage on (``Perm.shift(1)``).
The result is ``[n_stages, M, mb, ...]``: the last stage's outputs on
every rank, as the reference's ``psum(outputs * mask)`` broadcasts them.

Bubble cells (stage r at tick t with t - r outside [0, M)) compute on
garbage in the reference and are masked out; what they produce reaches
only other bubble cells, so here they are not computed and put zeros.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional

import torch

from ..core import ranks
from ..models.common import tree_leaves, tree_map


def stage_slice(params_stacked: Any, rank: int = 0) -> Any:
    """Stage ``rank``'s params: index dim 0 of every leaf (the reference
    drops the leading ``[1]`` that its ``shard_map`` leaves each rank)."""
    return tree_map(lambda t: t[rank], params_stacked)


def _tick_cells(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                stage_params: Any, microbatches: torch.Tensor,
                incoming: torch.Tensor, t: int) -> torch.Tensor:
    """Every stage's activation at tick ``t`` -> ``[n, mb, ...]``."""
    n, M = incoming.shape[0], microbatches.shape[0]
    first = microbatches[min(t, M - 1)]
    ys = []
    for r in range(n):
        if 0 <= t - r < M:
            x_in = first if r == 0 else incoming[r]
            ys.append(stage_fn(stage_slice(stage_params, r), x_in))
        else:                               # bubble: never read
            ys.append(torch.zeros_like(first))
    return torch.stack(ys)


def _broadcast_last(outputs: List[Optional[torch.Tensor]], n: int
                    ) -> torch.Tensor:
    out = torch.stack(outputs)              # [M, mb, ...]
    return out.unsqueeze(0).expand((n,) + tuple(out.shape))


def gpipe(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
          stage_params: Any, microbatches: torch.Tensor, *,
          axis: str = "pipe", use_lcx: bool = True,
          runtime: Optional[Any] = None,
          device: Optional[Any] = None,
          failover: bool = False,
          heartbeat: Optional[Any] = None) -> torch.Tensor:
    """GPipe forward.  ``microbatches`` ``[M, mb, ...]`` (stage 0 injects
    them); ``stage_params`` leaves ``[n_stages, ...]``.  Returns
    ``[n_stages, M, mb, ...]``, the last stage's outputs on every rank.

    Schedule: M + n_stages - 1 ticks; stage r works on micro-batch t - r
    at tick t.  ``use_lcx=True`` drives it through an AMT executor (tick
    tasks chained by LCX-put edges) on a private ``Runtime(name="gpipe")``
    unless ``runtime`` / ``device`` are given; ``use_lcx=False`` is the
    native schedule (a loop over ticks, shifts by ``ranks.permute``).

    Stage r is slot r of the stacked dim: the reference's ``rank=``
    override of ``axis_index`` (a workaround for its compiler) has no
    counterpart.  ``failover=True`` (or an injected ``heartbeat``
    monitor) provisions a warm standby device on the pipe axis and
    attaches a ``HeartbeatMonitor(on_dead="failover")`` to the runtime: a
    stage device declared dead mid-schedule migrates its endpoints and
    in-flight activation transfers onto the standby, and the executor
    re-dispatches the affected tick tasks.
    """
    n = int(next(iter(tree_leaves(stage_params))).shape[0])
    with ranks.bind_axis(axis, n):
        if not use_lcx:
            return _gpipe_native(stage_fn, stage_params, microbatches, n)
        return _gpipe_taskgraph(stage_fn, stage_params, microbatches, n,
                                axis=axis, runtime=runtime, device=device,
                                failover=failover, heartbeat=heartbeat)


def _gpipe_taskgraph(stage_fn, stage_params, microbatches, n: int, *,
                     axis: str, runtime: Optional[Any],
                     device: Optional[Any], failover: bool,
                     heartbeat: Optional[Any]) -> torch.Tensor:
    from .. import core as lcx
    from ..amt import Executor

    M = microbatches.shape[0]
    # Library-interop pattern: the pipeline owns a private runtime and an
    # isolated device on the pipe axis unless the caller injects theirs —
    # inter-stage traffic never routes through the global default runtime.
    if runtime is None:
        runtime = device.runtime if device is not None else None
    if runtime is None:
        runtime = lcx.Runtime(name="gpipe")
    dev = device if device is not None else runtime.device(axis=axis)
    if failover or heartbeat is not None:
        from ..runtime.fault import HeartbeatMonitor
        # warm standby on the same axis: the migration target when the
        # heartbeat declares a stage device dead mid-schedule
        runtime.device(axis=axis)
        if heartbeat is None:
            heartbeat = HeartbeatMonitor(on_dead="failover")
        heartbeat.attach(runtime)
    ex = Executor(device=dev, runtime=runtime, name="gpipe")
    # the activations arriving from the predecessor stages, and the last
    # stage's outputs
    cells = {"incoming": torch.zeros((n,) + tuple(microbatches.shape[1:]),
                                     dtype=microbatches.dtype,
                                     device=microbatches.device)}
    outputs: List[Optional[torch.Tensor]] = [None] * M

    def make_tick(t: int):
        def tick(ctx):
            y = _tick_cells(stage_fn, stage_params, microbatches,
                            cells["incoming"], t)
            if t >= n - 1:
                outputs[t - (n - 1)] = y[n - 1]
            # edge to the next tick: put the activations one stage on and
            # suspend until the predecessor's put lands here
            ctx.put(y, lcx.Perm.shift(1))
            return ctx.suspend(
                lambda ev: cells.__setitem__("incoming", ev.payload))

        return tick

    prev = None
    for t in range(M + n - 1):
        prev = ex.spawn(make_tick(t), deps=(prev,) if prev else (),
                        priority=-t, name=f"tick{t}")
    ex.run()
    return _broadcast_last(outputs, n)


def _gpipe_native(stage_fn, stage_params, microbatches, n: int
                  ) -> torch.Tensor:
    """Reference schedule: a loop over ticks, shifts by a permutation of
    the stage dim (no LCX, no executor)."""
    M = microbatches.shape[0]
    shift = [(i, (i + 1) % n) for i in range(n)]
    incoming = torch.zeros((n,) + tuple(microbatches.shape[1:]),
                           dtype=microbatches.dtype,
                           device=microbatches.device)
    outputs: List[Optional[torch.Tensor]] = [None] * M
    for t in range(M + n - 1):
        y = _tick_cells(stage_fn, stage_params, microbatches, incoming, t)
        if t >= n - 1:
            outputs[t - (n - 1)] = y[n - 1]
        incoming = ranks.permute(y, shift)
    return _broadcast_last(outputs, n)
