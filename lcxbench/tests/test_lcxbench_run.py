"""A whole run on the CPU at smoke size, past the harness's look for a
card: the last line's keys, the traced run's readers, and the check
coming out false for each fault a serving cell can have."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lcxbench import harness  # noqa: E402
from lcxbench.tests import smoke  # noqa: E402

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def _run(cell, trace=False, seed=3, seconds=0.3):
    clock = smoke.StepClock()
    res, lines = harness.run(cell, seed, seconds, trace, "cpu", 0.0,
                             clock=clock, sleep=clock.sleep)
    json.dumps(res, allow_nan=False)
    return res, lines


def test_last_line_keys_and_end_to_end_metrics():
    cell = smoke.cell("deepseek-v3-5l", "open")
    res, lines = _run(cell)
    assert list(res) == KEYS and res["correct"] is True
    # a reading of the card's memory has nothing to read on the CPU
    assert set(res["metrics"]) == {m["name"] for m in cell.end_to_end
                                   if m["name"] != "memory_peak_gib"}
    assert all(set(v) == {"value", "unit"} for v in res["metrics"].values())
    assert set(res["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["checks"]) == {"failed_requests", "tokens_compared",
                                  "logit_gap_max_clear", "logit_gap_mean",
                                  "expert_miss_share"}
    assert lines[0].startswith("generator: ")
    assert lines[1].startswith("reference: ")
    assert [ln.split(":")[0] for ln in lines[2:]] == [
        f"check {k}" for k in res["checks"]]


def test_traced_run_reads_the_host_metrics():
    host = ["engine.prefill_ms", "engine.decode_tick_ms",
            "amt.tick_overhead_ms", "model.mfu.prefill", "model.mfu.decode"]
    cell = smoke.cell("internlm2-20b", "closed", trace_metrics=host)
    res, _ = _run(cell, trace=True)
    assert res["correct"] is True
    assert set(res["metrics"]) == set(host)
    assert 0 < res["metrics"]["model.mfu.decode"]["value"] < 100


def test_memory_peak_reads_the_device_peak_and_nothing_without_one():
    from types import SimpleNamespace
    from lcxbench.readers import reader
    read = reader("memory_peak_gib")
    assert read(SimpleNamespace(memory_peak_bytes=47336140800)) == \
        pytest.approx(47336140800 / 2 ** 30, rel=1e-12)
    assert read(SimpleNamespace(memory_peak_bytes=0)) is None


def test_closed_output_rate_per_layer_is_the_windows_rate():
    """Tokens delivered up to the close over the window; the per-layer
    name reads the same number."""
    from types import SimpleNamespace
    from lcxbench.readers import reader
    recs = {0: SimpleNamespace(times=[0.5, 1.0, 2.5]),
            1: SimpleNamespace(times=[1.5])}
    run = SimpleNamespace(window=SimpleNamespace(close=2.0, records=recs))
    assert reader("output_tokens_per_s")(run) == pytest.approx(1.5)
    assert reader("engine.output_tokens_per_s.closed")(run) == \
        pytest.approx(1.5)


def _served_wrong(monkeypatch, fault):
    from repro_torch.serving import engine as eng
    sample, decode = eng.sample_token, eng.decode_step
    if fault == "token altered":
        def wrong(logits, temperature, gen):
            return (sample(logits, temperature, gen) + 1) % logits.shape[-1]
        monkeypatch.setattr(eng, "sample_token", wrong)
    elif fault == "state unchanged":
        def stale(cfg, params, tokens, caches, lengths, **kw):
            copy = {k: v for k, v in caches.items()}
            copy = torch.utils._pytree.tree_map(torch.clone, copy)
            return decode(cfg, params, tokens, copy, lengths, **kw)
        monkeypatch.setattr(eng, "decode_step", stale)
    elif fault == "experts altered":
        from repro_torch.models import moe
        route = moe.route

        def shifted(cfg, router_p, x):
            ids, w, aux = route(cfg, router_p, x)
            return (ids + 1) % cfg.n_experts, w, aux
        monkeypatch.setattr(moe, "route", shifted)
    elif fault == "half the batch":
        def half(cfg, params, tokens, caches, lengths, **kw):
            lg, c = decode(cfg, params, tokens, caches, lengths, **kw)
            lg = lg.clone()
            lg[lg.shape[0] // 2:] = 0.0
            return lg, c
        monkeypatch.setattr(eng, "decode_step", half)


GAPS = {"internlm2-20b": ("logit_gap_max",),
        "deepseek-v3-5l": ("logit_gap_max_clear", "logit_gap_mean",
                           "expert_miss_share")}


@pytest.mark.parametrize("config", sorted(GAPS))
@pytest.mark.parametrize("fault", ["token altered", "state unchanged",
                                   "half the batch"])
def test_a_broken_path_is_not_correct(monkeypatch, config, fault):
    """Each fault a serving cell can have fails one of the numbers the
    cell's limits file names: for DeepSeek-V3 the widest gap where the
    routing is clear, the mean gap or the share of chosen experts the
    reference did not choose."""
    _served_wrong(monkeypatch, fault)
    res, lines = _run(smoke.cell(config, "closed"))
    assert res["correct"] is False, lines
    failed = [ln.split(":")[0][len("check "):] for ln in lines
              if ln.startswith("check ") and ln.endswith("FAILED")]
    assert failed and set(failed) <= set(GAPS[config]), lines


def test_altered_experts_are_not_correct(monkeypatch):
    """A router that hands each token the wrong experts fails the share
    of chosen experts that the reference did not choose."""
    _served_wrong(monkeypatch, "experts altered")
    res, lines = _run(smoke.cell("deepseek-v3-5l", "closed"))
    assert res["correct"] is False, lines
    assert res["checks"]["expert_miss_share"]["value"] > 0.3, lines


def test_sound_run_agrees_on_every_expert_set():
    res, lines = _run(smoke.cell("deepseek-v3-5l", "closed"))
    assert res["correct"] is True, lines
    assert res["checks"]["expert_miss_share"]["value"] == 0.0, lines


@pytest.mark.parametrize("config", sorted(GAPS))
def test_control_in_the_programs_place_is_not_correct(config):
    """At smoke size in bfloat16, a whole run with the control read: the
    program passes the limits that the control, judged in its place as
    ``calibrate.py`` judges it, fails."""
    cell = smoke.cell(config, "closed", limit=0.1, clients=4,
                      output={"dist": "loguniform", "min": 16, "max": 32})
    cell.cfg["torch_dtype"] = "bfloat16"
    cell.limits["served_tokens"] = 64
    clock = smoke.StepClock()
    res, lines = harness.run(cell, 2, 0.3, False, "cpu", 0.0, control=True,
                             clock=clock, sleep=clock.sleep)
    assert res["correct"] is True, lines
    assert res["control"]["correct"] is False, res["control"]


def test_command_without_a_card_exits_nonzero_and_prints_no_result():
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[2]
    out = subprocess.run(
        [sys.executable, "lcxbench/run.py", "--workload", "dsv3-chat",
         "--seed", str(2 ** 31 + 3), "--seconds", "1", "--trace", "0"],
        cwd=root, capture_output=True, text=True, timeout=300)
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    assert out.returncode != 0 and out.stdout == ""
    assert "needs 1 CUDA device" in out.stderr
