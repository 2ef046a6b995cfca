"""The port's in-memory trace (``repro_torch.trace``) and its spans in the
serving engine and the AMT executor: nesting and parent ids, the ring's
dropped count, the disabled trace, request ids on admissions, the
engine's ``timings`` as the exact sums of their phases, the executor's
spans with and without a trace, and no profiler call anywhere in the
port."""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.core as lcx  # noqa: E402
from repro_torch.amt import Executor  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.models import init_model  # noqa: E402
from repro_torch.serving import (Request, ServeConfig,  # noqa: E402
                                 ServingEngine)
from repro_torch.trace import NULL_SPAN, Trace  # noqa: E402

PORT = Path(__file__).resolve().parents[1] / "src" / "repro_torch"
# tests/test_torch_serving.py's dense model, in float32
DENSE = dict(name="d", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
             d_ff=128, vocab=211, q_block=8, dtype=torch.float32,
             param_dtype=torch.float32)
PHASES = {"engine.decode": ("decode.prepare", "decode.dispatch",
                            "decode.sync"),
          "engine.admit": ("prefill.dispatch", "prefill.sync")}


@pytest.fixture(scope="module")
def dense():
    cfg = ModelConfig(**DENSE)
    return cfg, init_model(torch.Generator().manual_seed(0), cfg,
                           device="cpu")


def _serve(dense, n=3, **engine_kw):
    cfg, params = dense
    eng = ServingEngine(cfg, params, ServeConfig(n_slots=2, max_seq=32,
                                                 max_new_tokens=3),
                        device="cpu", **engine_kw)
    for i in range(n):
        eng.submit(Request(rid=i, prompt=np.arange(3 + i, dtype=np.int32)))
    eng.run_until_drained()
    return eng


def _children(trace, span):
    return [r for r in trace.records if r.parent == span.id]


def test_spans_nest_with_parent_ids_and_counters():
    tr = Trace()
    with tr.span("outer", rid=7) as outer:
        with tr.span("inner") as inner:
            tr.add("phase", 10, 25, n=3)
        outer.set(done=1)
    phase, got_inner, got_outer = tr.records
    assert (got_inner, got_outer) == (inner, outer)
    assert [r.name for r in tr.records] == ["phase", "inner", "outer"]
    assert (outer.id, inner.id, phase.id) == (0, 1, 2) and tr.opened == 3
    assert outer.parent is None and inner.parent == outer.id \
        and phase.parent == inner.id
    assert outer.attrs == {"rid": 7, "done": 1} and phase.attrs == {"n": 3}
    assert phase.ns == 15 and outer.start <= inner.start <= inner.end \
        <= outer.end
    with tr.span("after") as after:
        pass
    assert after.parent is None and tr.dropped == 0


def test_ring_overflow_is_counted_in_dropped():
    tr = Trace(capacity=3)
    for i in range(5):
        with tr.span("s", i=i):
            pass
    assert [r.attrs["i"] for r in tr.records] == [2, 3, 4]
    assert tr.dropped == 2 and tr.opened == 5


def test_disabled_trace_records_nothing(dense):
    tr = Trace(enabled=False)
    with tr.span("a", rid=1) as a:
        a.set(x=1)
        tr.add("b", 0, 1)
    assert a is NULL_SPAN and tr.span("c") is NULL_SPAN
    assert not tr.records and tr.opened == 0 and tr.dropped == 0
    eng = _serve(dense, trace=False)
    assert not eng.trace.enabled and not eng.trace.records
    assert eng._executor.trace is None
    assert eng.timings["prefill_ms"] and eng.timings["decode_ms"]


def test_admissions_carry_request_ids_and_queue_wait(dense):
    eng = _serve(dense, n=3)
    admits = [r for r in eng.trace.records if r.name == "engine.admit"]
    assert sorted(r.attrs["rid"] for r in admits) == [0, 1, 2]
    reqs = {r.rid: r for r in eng.finished}
    for a in admits:
        wait_s = a.start / 1e9 - reqs[a.attrs["rid"]].submitted_at
        assert wait_s >= 0.0
        kids = _children(eng.trace, a)
        assert [k.name for k in kids] == list(PHASES["engine.admit"])
        assert kids[0].attrs == {
            "prompt": len(reqs[a.attrs["rid"]].prompt)}


@pytest.mark.parametrize("use_executor", [True, False])
def test_timings_are_the_exact_sums_of_their_phases(dense, use_executor):
    eng = _serve(dense, n=5, use_executor=use_executor)
    for parent, key in (("engine.decode", "decode_ms"),
                        ("engine.admit", "prefill_ms")):
        sums = []
        for p in (r for r in eng.trace.records if r.name == parent):
            kids = {k.name: k for k in _children(eng.trace, p)}
            ph = [kids[n] for n in PHASES[parent]]
            assert all(a.end == b.start for a, b in zip(ph, ph[1:]))
            sums.append(sum(k.ns for k in ph) / 1e6)
        assert sums == eng.timings[key] and sums, key
    decodes = [r for r in eng.trace.records if r.name == "engine.decode"]
    book = [r for r in eng.trace.records if r.name == "decode.bookkeeping"]
    assert len(book) == len(decodes) == eng.stats["ticks"]
    assert sum(d.attrs["live"] for d in decodes) + eng.stats["prefills"] \
        == eng.stats["decoded_tokens"]
    assert sum(b.attrs["finished"] for b in book) <= len(eng.finished)


def test_tick_spans_nest_engine_executor_and_tasks(dense):
    eng = _serve(dense, n=3)
    tr = eng.trace
    ticks = [r for r in tr.records if r.name == "engine.tick"]
    # each tick here has a live slot, so each decodes
    assert len(ticks) == len([r for r in tr.records if r.name
                              == "amt.run"]) == eng.stats["ticks"]
    assert all(t.parent is None for t in ticks)
    assert ticks[0].attrs["queued"] == 3 and ticks[-1].attrs["live"] == 0
    by_id = {r.id: r for r in tr.records}
    for r in tr.records:
        if r.name == "amt.run":
            assert by_id[r.parent].name == "engine.tick"
            assert r.attrs["tasks_run"] >= 1 \
                and r.attrs["progress_calls"] >= 1
        elif r.name == "amt.task":
            assert by_id[r.parent].name == "amt.run"
        elif r.name in ("engine.admit", "engine.decode"):
            assert by_id[r.parent].name == "amt.task"
    graph = [r.attrs["graph_tasks"] for r in tr.records
             if r.name == "amt.run"]
    # the executor keeps every task it ever ran: the graph only grows
    assert graph == sorted(graph) and graph[-1] == len(eng._executor.graph)


def test_task_spans_carry_the_graphs_task_names(dense):
    """The names ``test_engine_runs_ticks_as_executor_tasks`` reads from
    the executor's retained graph are on its ``amt.task`` spans."""
    eng = _serve(dense, n=3)
    spans = [r.attrs["task"] for r in eng.trace.records
             if r.name == "amt.task"]
    tasks = [t.name for t in eng._executor.graph.tasks.values()]
    assert sorted(spans) == sorted(tasks)
    assert {n for n in spans if n.startswith("prefill:")} == \
        {"prefill:0", "prefill:1", "prefill:2"}
    assert spans.count("decode") >= eng.stats["ticks"]


def test_executor_records_spans_only_with_a_trace():
    rt = lcx.Runtime(name="trace-test")
    plain = Executor(runtime=rt)
    plain.spawn(lambda ctx: 1, name="a")
    plain.run()
    assert plain.trace is None

    tr = Trace()
    ex = Executor(runtime=rt, trace=tr)
    a = ex.spawn(lambda ctx: 1, name="a")
    ex.spawn(lambda ctx: a.result + 1, deps=(a,), name="b")
    stats = ex.run()
    *tasks, run = tr.records
    assert run.name == "amt.run" and run.parent is None
    assert [(t.name, t.attrs["task"], t.parent) for t in tasks] == [
        ("amt.task", "a", run.id), ("amt.task", "b", run.id)]
    assert run.attrs == {"tasks_run": 2,
                         "progress_calls": stats["progress_calls"],
                         "graph_tasks": 2}


def test_no_profiler_call_in_the_port():
    """The program records its spans without ``torch.profiler``: a
    ``record_function`` annotation would count as a kernel in the
    benchmark's device busy time."""
    pat = re.compile(r"torch\.profiler|autograd\.profiler|record_function"
                     r"|import profiler")
    found = [f"{p.relative_to(PORT)}:{i}"
             for p in sorted(PORT.rglob("*.py"))
             for i, line in enumerate(p.read_text().splitlines(), 1)
             if pat.search(line)]
    assert found == []
