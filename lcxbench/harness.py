"""One run of one cell: set-up, the measured window, the metrics, the check.

Set-up (counted in ``setup_s``): the program's configuration for the
cell's configuration file, its weights drawn on the card from the seed,
``ServingEngine`` with ``model_kernels`` and one cache for ``n_slots``
sequences of the mix's longest prompt and output, and a warm-up through
that engine of the shapes the mix uses (its longest and shortest prompt,
decode ticks with every slot live).  Then the window (``serve.Window``),
then the readers of the cell's metrics (``readers``), then the check
(``check``) once the peak memory is read and the engine is freed.

The last line on standard output is the result; the lines before it on
standard error end with each number compared beside its limit.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import sys
import time
from typing import Dict, List, Optional, Tuple

from . import bench, check, families, isolation, model, readers, weights
from .bench import Cell
from .serve import Window
from .traffic import Traffic, max_seq

TRACE_AT = 0.5       # the profiled sub-window starts mid-window


@dataclasses.dataclass
class Run:
    """What the metric readers read."""
    cell: Cell
    window: Window
    setup_s: float
    profile: Optional[object] = None
    memory_peak_bytes: int = 0

    @property
    def cfg(self) -> Dict:
        return self.cell.cfg


def _sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def warm_up(engine, mix: Dict, vocab: int) -> None:
    """Every slot live for two decode ticks, after prefills of the mix's
    longest prompt and of its shortest in the other slots."""
    import numpy as np
    from repro_torch.serving import Request
    lens = [mix["prompt"]["max"]] + [mix["prompt"]["min"]] * (
        int(mix["n_slots"]) - 1)
    rng = np.random.default_rng(0)
    for i, n in enumerate(lens):
        engine.submit(Request(rid=-1 - i, max_new_tokens=3,
                              prompt=rng.integers(0, vocab, n).astype(
                                  np.int32)))
    engine.run_until_drained()


def build(cell: Cell, seed: int, device: str, mix: Optional[Dict] = None):
    """(engine, weights, kernels) of ``cell`` under ``mix`` (the cell's
    own by default), warmed up: what set-up makes."""
    from repro_torch.kernels import model_kernels
    from repro_torch.serving import ServeConfig, ServingEngine
    cfg, mix = cell.cfg, mix or cell.mix
    if max_seq(mix) > cfg["max_position_embeddings"]:
        raise ValueError(f"{cell.name}: a slot of {max_seq(mix)} positions "
                         f"passes the model's {cfg['max_position_embeddings']}")
    port_cfg = model.port_config(cfg)
    model.check_kinds(cfg, port_cfg)
    params = weights.draw(cfg, seed, device, port_cfg.param_dtype)
    model.check_layout(port_cfg, params)
    kernels = model_kernels(port_cfg)
    engine = ServingEngine(port_cfg, params, ServeConfig(
        n_slots=int(mix["n_slots"]), max_seq=max_seq(mix), temperature=0.0,
        max_new_tokens=mix["output"]["max"]), kernels=kernels, device=device)
    warm_up(engine, mix, cfg["vocab_size"])
    return engine, params, kernels


def run(cell: Cell, seed: int, seconds: float, trace: bool, device: str,
        t_start: float, control: bool = False,
        clock=time.perf_counter, sleep=time.sleep) -> Tuple[Dict, List[str]]:
    """(the result, the lines that name each number compared).  With
    ``control`` the check also reads the control on the same sample
    (``check.gaps``) and judges it in the program's place, under
    ``result["control"]``.  ``clock`` and ``sleep`` are the window's (a
    test passes its own)."""
    import torch
    from .routes import RouteLog
    from .tracing import Tracer

    cfg, mix = cell.cfg, cell.mix
    engine, params, kernels = build(cell, seed, device)
    routes = RouteLog(engine).install() \
        if families.of(cfg).routed_experts(cfg) else None
    tracer = None
    if trace:
        tracer = Tracer(engine, kernels, TRACE_AT * seconds,
                        int(mix["trace_ticks"]), sleep).install()
    traffic = Traffic(mix, seed, seconds, cfg["vocab_size"])
    _sync(device)
    setup_s = time.perf_counter() - t_start
    if routes:
        routes.on = True
    window = Window(engine, traffic, seconds, tracer, clock=clock,
                    sleep=tracer.sleep if tracer else sleep).run()
    _sync(device)

    cuda = torch.device(device).type == "cuda"
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": 1,
           "memory_peak_bytes": torch.cuda.max_memory_allocated()
           if cuda else 0}
    profile = tracer.read() if tracer else None
    if tracer:
        tracer.uninstall()
        if profile is not None:
            dev["busy_s"] = profile.busy_us() / 1e6
            dev["window_s"] = profile.window_us / 1e6
    r = Run(cell, window, setup_s, profile, dev["memory_peak_bytes"])
    metrics = {}
    for m in cell.metrics(trace):
        v = readers.reader(m["name"])(r)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    breakdown = tracer.breakdown() if tracer else None

    # the check, with the engine and its cache freed
    finished, failed = window.finished(), len(window.failed())
    due = window.due_in_window()
    attempted = len(due)
    late = sorted((d.submitted - d.req.due) * 1e3 for d in due)
    gen_line = (f"generator: {attempted} requests due in the window, "
                f"submitted late by {late[len(late) // 2]:.3f} ms (median),"
                f" {late[-1]:.3f} ms (most)" if late else "generator: none")
    reqs = check.sample(finished, seed, cell.limits["served_tokens"])
    chosen = None
    if routes:
        routes.uninstall()
        chosen = routes.sets(q.rid for q in reqs)
    del engine, window, r, tracer, profile, due, routes
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    readings = check.gaps(cfg, params, reqs, device, control=control,
                          routes=chosen,
                          route_margin=cell.limits.get("route_margin", 0.0),
                          positions=control)
    readings["failed"] = failed
    checks = check.judge(cell.limits, readings)

    result = {"correct": all(c["ok"] for c in checks.values()),
              "attempted": attempted, "failed": failed, "metrics": metrics,
              "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    if control:
        verdict = check.judge(cell.limits, readings, side="control")
        result["control"] = {
            "readings": {k: v for k, v in readings.items()
                         if k.startswith(("program", "control", "widest",
                                          "clear", "positions"))},
            "correct": all(c["ok"] for c in verdict.values()),
            "checks": {k: {"value": c["value"], "limit": c["limit"]}
                       for k, c in verdict.items()}}
    result["checks"] = {k: {"value": c["value"], "limit": c["limit"]}
                        for k, c in checks.items()}
    lines = [gen_line,
             f"reference: {len(reqs)} requests, {readings['tokens']} served "
             f"tokens in {readings['seconds']:.1f} s; widest gap "
             f"{readings['program']}, mean {readings['program_mean']}, "
             f"not the first choice {readings['program_miss']}; expert sets "
             f"differ at {readings['program_sets_differ']} of positions, "
             f"chosen experts not the reference's "
             f"{readings['program_experts_missed']}, widest gap where the "
             f"sets agree {readings['program_agreed']}, where the routing "
             f"is clear ({readings['clear_share']} of positions) "
             f"{readings['program_clear']}"]
    lines += [f"check {k}: {c['value']} (limit {c['limit']}) "
              f"{'ok' if c['ok'] else 'FAILED'}" for k, c in checks.items()]
    return result, lines


def parse(argv: List[str]) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv: List[str], t_start: float) -> int:
    args = parse(argv)
    c = bench.cell(args.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < c.chips:
        print(f"lcxbench: cell {c.name} needs {c.chips} CUDA device(s); "
              f"available: {torch.cuda.is_available()}, count "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result, lines = run(c, args.seed, args.seconds, bool(args.trace),
                        "cuda", t_start)
    found = isolation.loaded()
    if found:
        print(f"lcxbench: the run loaded {found}; it may load no JAX",
              file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
