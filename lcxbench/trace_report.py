"""The program's own trace in one run of a cell, read further than the
cell's metrics: what a tick spends its time on, what the spans' counters
say and, with ``--trace 1``, the card's idle time by program span and the
launches of each dispatch.

    python3 lcxbench/trace_report.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The set-up, the window and the profiled sub-window are the harness's
(``harness.build``, ``tracing.Tracer``, ``serve.Window``): one seed gives
the same requests as a benchmark run.  There is no correctness check.
Prints one JSON line (``--out`` writes it to a file as well):

- ``trace``: the spans opened, kept in the ring and dropped;
- ``span_ms``: each span's mean in ms and count over the window's
  unprofiled ticks (``program_trace.host_ticks``), as the metrics read;
- ``load``: requests queued at a tick's start and slots live at its end
  (``engine.tick``), slots a decode tick ran (``engine.decode``),
  requests finished a decode tick (``decode.bookkeeping``);
- ``queue_wait_ms``: mean and p95 of an admission's start less its
  request's ``submitted_at`` (``engine.admit``'s ``rid``);
- ``prefill_us_per_token``: dispatch and sync over the prompt tokens
  (``prefill.dispatch``'s ``prompt``);
- ``amt``: tasks run and progress calls a ``run()`` (``amt.run``), and,
  by thirds of the window, the executor's self time beside the tasks its
  graph holds (``graph_tasks``);
- ``metrics``: the cell's readers on this run (``setup_s`` left out);
- with ``--trace 1``: ``window_s`` and ``busy_s`` of the profiled
  sub-window, ``idle_by_span`` (``program_trace.idle_by_span``) and
  ``launches``: for prefills and decode ticks, the mean and count of the
  kernels that started on the card between the dispatch span's start and
  the end of its sync.  A dispatch of more launches than the card's
  launch queue holds waits inside its span for the card (``PERF.md``,
  section 5);
- ``breakdown``: the harness's (``tracing.Tracer.breakdown``), whose idle
  time by the harness's spans sits beside ``idle_by_span``.

Needs the card.
"""
import argparse
import bisect
import json
import os
import sys
import time
from typing import Dict, List, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PHASES = (("prefill", "prefill.dispatch", "prefill.sync"),
          ("decode", "decode.dispatch", "decode.sync"))


def _mean(v: List[float]) -> Optional[float]:
    return sum(v) / len(v) if v else None


def _p95(v: List[float]) -> Optional[float]:
    v = sorted(v)
    return v[min(len(v) - 1, int(0.95 * len(v)))] if v else None


def run_cell(cell, seed: int, seconds: float, trace: bool, device: str,
             clock=time.perf_counter, sleep=time.sleep):
    """A ``harness.Run`` of ``cell``: its set-up, window and, with
    ``trace``, profiled sub-window, as ``harness.run`` makes them; and
    the harness's breakdown of the sub-window (``Tracer.breakdown``: the
    idle time by the harness's own spans), None without a trace."""
    import torch
    from lcxbench import harness
    from lcxbench.serve import Window
    from lcxbench.tracing import Tracer
    from lcxbench.traffic import Traffic
    engine, _, kernels = harness.build(cell, seed, device)
    tracer = Tracer(engine, kernels, harness.TRACE_AT * seconds,
                    int(cell.mix["trace_ticks"]), sleep).install() \
        if trace else None
    window = Window(engine, Traffic(cell.mix, seed, seconds,
                                    cell.cfg["vocab_size"]), seconds,
                    tracer, clock=clock,
                    sleep=tracer.sleep if tracer else sleep).run()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    profile = breakdown = None
    if tracer:
        profile = tracer.read()
        tracer.uninstall()
        breakdown = tracer.breakdown()
    return harness.Run(cell, window, 0.0, profile), breakdown


def launches(run) -> Optional[Dict[str, List]]:
    """Mean and count of the kernels each profiled prefill and decode
    tick started on the card, from its dispatch's start to its sync's
    end (``program_trace.on_card``)."""
    from lcxbench import program_trace
    spans = program_trace.on_card(run)
    if spans is None:
        return None
    starts = sorted(s for _, s, _ in run.profile.kernels)
    out = {}
    for label, dispatch, sync in PHASES:
        d = [s for n, s, _ in spans if n == dispatch]
        e = [t for n, _, t in spans if n == sync]
        n = [bisect.bisect_left(starts, b) - bisect.bisect_left(starts, a)
             for a, b in zip(d, e)]
        out[label] = [_mean(n), len(n)]
    return out


def report(run) -> Dict:
    """What the program's trace of ``run`` holds; see the module's
    docstring."""
    from lcxbench import program_trace, readers
    cell = run.cell
    names = [m["name"] for m in cell.end_to_end + cell.per_layer
             if m["name"] != "setup_s"]
    out: Dict = {"metrics": {n: readers.reader(n)(run) for n in names}}
    trace = getattr(run.window.engine, "trace", None)
    out["trace"] = None if trace is None else {
        "opened": trace.opened, "kept": len(trace.records),
        "dropped": trace.dropped}
    pairs = program_trace.host_ticks(run)
    if pairs is None:
        return out
    by_name: Dict[str, List] = {}
    for _, spans in pairs:
        for s in spans:
            by_name.setdefault(s.name, []).append(s)

    def named(n):
        return by_name.get(n, [])

    def attr(n, a):
        return [s.attrs[a] for s in named(n)]

    out["ticks"] = len(pairs)
    out["span_ms"] = {n: [_mean([s.ns / 1e6 for s in v]), len(v)]
                      for n, v in by_name.items()}
    queued = attr("engine.tick", "queued")
    out["load"] = {
        "queued_at_start": [_mean(queued), max(queued, default=None)],
        "live_at_end": _mean(attr("engine.tick", "live")),
        "decode_live": _mean(attr("engine.decode", "live")),
        "finished_a_decode": _mean(attr("decode.bookkeeping",
                                        "finished"))}
    reqs = {r.ereq.rid: r.ereq for r in run.window.records.values()}
    waits = [(a.start / 1e9 - reqs[a.attrs["rid"]].submitted_at) * 1e3
             for a in named("engine.admit") if a.attrs["rid"] in reqs]
    out["queue_wait_ms"] = [_mean(waits), _p95(waits)]
    tokens = sum(attr("prefill.dispatch", "prompt"))
    out["prefill_us_per_token"] = {
        n.split(".")[1]: sum(s.ns for s in named(n)) / 1e3 / tokens
        for n in ("prefill.dispatch", "prefill.sync")} if tokens else None
    tasks = {}
    for s in named("amt.task"):
        tasks[s.parent] = tasks.get(s.parent, 0) + s.ns
    amt_runs = named("amt.run")
    third = -(-len(amt_runs) // 3)
    out["amt"] = {
        "tasks_run": _mean(attr("amt.run", "tasks_run")),
        "progress_calls": _mean(attr("amt.run", "progress_calls")),
        "self_ms_and_graph_tasks_by_third": [
            [_mean([(s.ns - tasks.get(s.id, 0)) / 1e6 for s in part]),
             _mean([s.attrs["graph_tasks"] for s in part])]
            for part in (amt_runs[k:k + third]
                         for k in range(0, len(amt_runs), third))]
        if third else []}
    p = run.profile
    if p is not None:
        out["window_s"] = p.window_us / 1e6
        out["busy_s"] = p.busy_us() / 1e6
        out["idle_by_span"] = program_trace.idle_by_span(run)
        out["launches"] = launches(run)
    return out


def main(argv: List[str]) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=1)
    p.add_argument("--out", help="a file to write the JSON line to as well")
    a = p.parse_args(argv)
    from lcxbench import env
    env.setup(ROOT)
    from lcxbench import bench
    run, breakdown = run_cell(bench.cell(a.workload), a.seed, a.seconds,
                              bool(a.trace), "cuda")
    line = json.dumps({"workload": a.workload, "seed": a.seed,
                       **report(run), "breakdown": breakdown})
    print(line, flush=True)
    if a.out:
        with open(a.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    # the checkout's root and the program's sources, not this directory
    sys.path[0:1] = [ROOT, os.path.join(ROOT, "src")]
    sys.exit(main(sys.argv[1:]))
