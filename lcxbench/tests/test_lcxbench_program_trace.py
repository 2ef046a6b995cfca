"""The readers of the program's own spans (``program_trace.py``): a whole
traced run on the CPU reports the eight host-span metrics, agreeing with
the engine's timings, and an untraced run none; the tick pairing gives
nothing once the trace's ring dropped a span of the window's ticks; the
card-clock placement puts a known idle gap under ``decode.dispatch``;
``trace_report.py`` reads every span and counter of a traced run and
counts the launches of each dispatch on the card's clock."""
import json
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

from lcxbench import harness, program_trace  # noqa: E402
from lcxbench.readers import reader  # noqa: E402
from lcxbench.serve import Tick  # noqa: E402
from lcxbench.tests import smoke  # noqa: E402
from lcxbench.tracing import Profile  # noqa: E402
from repro_torch.trace import Trace  # noqa: E402

SPAN_METRICS = ["model.decode_dispatch_ms",
                "model.decode_dispatch_ms.closed", "device.decode_wait_ms",
                "device.decode_wait_ms.closed", "model.prefill_dispatch_ms",
                "device.prefill_wait_ms", "amt.self_ms", "amt.self_ms.closed"]
CARD_METRICS = ["device.idle_share.dispatch",
                "device.idle_share.dispatch.closed"]


def _bench_entries():
    b = json.loads((smoke.bench.ROOT / "BENCHMARK.json").read_text())
    return {m["name"]: m for m in b["per_layer"]}


def test_entries_name_their_sources():
    entries = _bench_entries()
    assert {n for n in SPAN_METRICS if entries[n]["source"]
            == "program_span"} == set(SPAN_METRICS)
    assert all(entries[n]["source"] == "device_trace" for n in CARD_METRICS)


@pytest.mark.parametrize("config", ["internlm2-20b", "deepseek-v3-5l"])
def test_traced_run_reports_the_span_metrics(config):
    host = ["engine.prefill_ms", "engine.decode_tick_ms"]
    cell = smoke.cell(config, "open",
                      trace_metrics=SPAN_METRICS + CARD_METRICS + host)
    clock = smoke.StepClock()
    res, lines = harness.run(cell, 5, 0.3, True, "cpu", 0.0, clock=clock,
                             sleep=clock.sleep)
    assert res["correct"] is True, lines
    m = {k: v["value"] for k, v in res["metrics"].items()}
    # no card, no profile: the two device-trace shares are left out
    assert set(m) == set(SPAN_METRICS + host)
    assert all(v > 0 for v in m.values()), m
    # the same ticks: each timing is the mean of its phases' sums
    assert m["model.prefill_dispatch_ms"] + m["device.prefill_wait_ms"] \
        == pytest.approx(m["engine.prefill_ms"], rel=1e-9)
    assert m["model.decode_dispatch_ms"] + m["device.decode_wait_ms"] \
        < m["engine.decode_tick_ms"]
    assert m["amt.self_ms.closed"] == m["amt.self_ms"]

    clock = smoke.StepClock()
    res, _ = harness.run(cell, 5, 0.3, False, "cpu", 0.0, clock=clock,
                         sleep=clock.sleep)
    assert not set(res["metrics"]) & set(SPAN_METRICS + CARD_METRICS)


def _tick(tr, t0_ns, profiled=False, start=0.0):
    """One tick's spans, as the engine records them, from ``t0_ns``; the
    decode dispatch runs 20-60 us into the tick."""
    us = 1000
    with tr.span("engine.tick", tick=1, queued=0) as head:
        pass
    with tr.span("engine.decode", live=1) as dec:
        tr.add("decode.prepare", t0_ns + 5 * us, t0_ns + 20 * us)
        tr.add("decode.dispatch", t0_ns + 20 * us, t0_ns + 60 * us)
        tr.add("decode.sync", t0_ns + 60 * us, t0_ns + 90 * us)
    dec.parent = head.id
    dec.start, dec.end = t0_ns + 2 * us, t0_ns + 95 * us
    head.start, head.end = t0_ns, t0_ns + 100 * us
    return Tick(start, start + 1e-4, [], [0.085], [], [4], profiled)


def _run(tr, ticks, profile=None):
    window = SimpleNamespace(engine=SimpleNamespace(trace=tr), ticks=ticks,
                             close=10.0)
    return SimpleNamespace(window=window, profile=profile)


def test_pairing_gives_nothing_once_a_window_span_was_dropped():
    # two warm-up ticks, then the window's three: 5 spans a tick
    full = Trace(capacity=64)
    for k in range(2):
        _tick(full, 10 ** 9 + k * 10 ** 6)
    ticks = [_tick(full, 2 * 10 ** 9 + k * 10 ** 6) for k in range(3)]
    pairs = program_trace.window_spans(_run(full, ticks))
    assert [len(s) for _, s in pairs] == [5, 5, 5]
    assert program_trace.mean_span(_run(full, ticks),
                                   "decode.dispatch") == 0.04

    # the ring lost only warm-up spans: the window is whole
    warm_lost = Trace(capacity=15)
    for k in range(2):
        _tick(warm_lost, 10 ** 9 + k * 10 ** 6)
    ticks = [_tick(warm_lost, 2 * 10 ** 9 + k * 10 ** 6) for k in range(3)]
    assert warm_lost.dropped == 10
    assert program_trace.window_spans(_run(warm_lost, ticks)) is not None

    # and here one span of the window's first tick too
    lost = Trace(capacity=14)
    for k in range(2):
        _tick(lost, 10 ** 9 + k * 10 ** 6)
    ticks = [_tick(lost, 2 * 10 ** 9 + k * 10 ** 6) for k in range(3)]
    run = _run(lost, ticks)
    assert program_trace.window_spans(run) is None
    assert program_trace.mean_span(run, "decode.dispatch") is None
    assert reader("model.decode_dispatch_ms")(run) is None

    # an engine that records no spans (the parent's) reads nothing
    bare = SimpleNamespace(window=SimpleNamespace(
        engine=SimpleNamespace(), ticks=ticks, close=10.0), profile=None)
    assert reader("amt.self_ms")(bare) is None


def test_card_clock_places_an_idle_gap_under_decode_dispatch():
    """One profiled tick whose ``engine.tick`` (100 us on the host) the
    harness's ``amt tick`` span holds at 10-110 us on the card's clock:
    the decode dispatch lands at 30-70 us.  Kernels run 0-30 and 50-120
    us of a 200 us sub-window, so 20 of its idle 100 us fall inside the
    dispatch and the rest after the tick."""
    tr = Trace()
    _tick(tr, 10 ** 9)
    ticks = [_tick(tr, 2 * 10 ** 9, profiled=True)]
    ticks.insert(0, Tick(0.0, 1e-4, [], [0.085], [], [4], False))
    profile = Profile(200.0, [("k", 0.0, 30.0), ("k", 50.0, 120.0)],
                      [("amt tick", 10.0, 110.0)], [])
    run = _run(tr, ticks, profile)
    spans = {n: (s, e) for n, s, e in program_trace.on_card(run)}
    assert spans["engine.tick"] == pytest.approx((10.0, 110.0))
    assert spans["decode.dispatch"] == pytest.approx((30.0, 70.0))
    assert reader("device.idle_share.dispatch")(run) == pytest.approx(10.0)
    assert reader("device.idle_share.dispatch.closed")(run) == \
        pytest.approx(10.0)
    idle = program_trace.idle_by_span(run)
    assert idle == pytest.approx({"decode.dispatch": 20e-6,
                                  "harness": 80e-6})


def test_self_time_is_the_run_less_its_tasks():
    tr = Trace()
    with tr.span("engine.tick") as head:
        with tr.span("amt.run") as run_span:
            tr.add("amt.task", 0, 30 * 10 ** 6, task="prefill:0")
            tr.add("amt.task", 0, 50 * 10 ** 6, task="decode")
    head.start, head.end = 0, 110 * 10 ** 6
    run_span.start, run_span.end = 0, 100 * 10 ** 6
    run = _run(tr, [Tick(0.0, 0.11, [30.0], [50.0], [8], [8], False)])
    assert reader("amt.self_ms")(run) == pytest.approx(20.0)


@pytest.mark.parametrize("config", ["internlm2-20b", "deepseek-v3-5l"])
def test_trace_report_reads_every_span_and_counter(config):
    """``trace_report.py`` on a whole traced CPU run: its span means are
    the metrics' readings, and each counter gives a reading."""
    from lcxbench import trace_report
    cell = smoke.cell(config, "open")
    clock = smoke.StepClock()
    run, breakdown = trace_report.run_cell(cell, 5, 0.3, True, "cpu",
                                           clock=clock, sleep=clock.sleep)
    rep = json.loads(json.dumps(trace_report.report(run)))
    assert rep["trace"]["dropped"] == 0 and rep["ticks"] > 0
    assert set(rep["span_ms"]) == {
        "engine.tick", "amt.run", "amt.task", "engine.admit",
        "prefill.dispatch", "prefill.sync", "engine.decode",
        "decode.prepare", "decode.dispatch", "decode.sync",
        "decode.bookkeeping"}
    m = rep["metrics"]
    for metric, span in (("model.decode_dispatch_ms", "decode.dispatch"),
                         ("device.prefill_wait_ms", "prefill.sync")):
        assert rep["span_ms"][span][0] == pytest.approx(m[metric])
    load = rep["load"]
    assert load["queued_at_start"][1] >= load["queued_at_start"][0] >= 0
    assert 0 < load["decode_live"] <= cell.mix["n_slots"]
    assert 0 <= load["live_at_end"] <= cell.mix["n_slots"]
    assert load["finished_a_decode"] >= 0
    assert 0 <= rep["queue_wait_ms"][0] <= rep["queue_wait_ms"][1]
    assert rep["prefill_us_per_token"]["dispatch"] > 0
    amt = rep["amt"]
    assert amt["tasks_run"] >= 1 and amt["progress_calls"] >= 1
    graph = [g for _, g in amt["self_ms_and_graph_tasks_by_third"]]
    # the executor's graph keeps every task: it grows over the window
    assert len(graph) == 3 and graph == sorted(graph)
    assert all(s > 0 for s, _ in amt["self_ms_and_graph_tasks_by_third"])
    # no card, no profile
    assert "launches" not in rep and breakdown is None


def test_trace_report_counts_the_launches_of_each_dispatch():
    """The profiled tick of the card-clock test: its decode dispatch
    (30-70 us) and sync (70-100 us) hold the kernel that starts at 50
    us, and not the one at 0 or at 105."""
    from lcxbench import trace_report
    tr = Trace()
    _tick(tr, 10 ** 9)
    ticks = [Tick(0.0, 1e-4, [], [0.085], [], [4], False),
             _tick(tr, 2 * 10 ** 9, profiled=True)]
    profile = Profile(200.0, [("k", 0.0, 30.0), ("k", 50.0, 60.0),
                              ("k", 105.0, 120.0)],
                      [("amt tick", 10.0, 110.0)], [])
    assert trace_report.launches(_run(tr, ticks, profile)) == {
        "prefill": [None, 0], "decode": [1.0, 1]}
