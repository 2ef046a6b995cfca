"""Twins of tests/test_amt.py: the same task graph on the JAX package's
AMT executor and on the port's gives the same run order, results and
``stats``.  Multi-rank graphs run the reference under
``jax.vmap(axis_name="x")`` and the port on rank-stacked ``[4]``
tensors."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.amt as jamt  # noqa: E402
import repro.core as jlcx  # noqa: E402

import repro_torch.amt as tamt  # noqa: E402
import repro_torch.core as tlcx  # noqa: E402

N = 4
SIDES = {
    "jax": (jlcx, jamt, lambda v: jnp.float32(v)),
    "torch": (tlcx, tamt, lambda v: torch.tensor(float(v))),
}


def _twin(scenario):
    """Run ``scenario(lcx, amt, scalar)`` on both sides; equal outcomes."""
    out = {}
    for side, (lcx, amt, scalar) in SIDES.items():
        lcx.init()
        out[side] = scenario(lcx, amt, scalar)
    assert out["torch"] == out["jax"], out
    return out["jax"]


def test_diamond_order_and_results_twin():
    def scenario(lcx, amt, _):
        ex = amt.Executor()
        order = []
        a = ex.spawn(lambda ctx: order.append("a") or 1, name="a")
        b = ex.spawn(lambda ctx: order.append("b") or a.result + 10,
                     deps=(a,), name="b", priority=1)
        c = ex.spawn(lambda ctx: order.append("c") or a.result + 20,
                     deps=(a,), name="c")
        d = ex.spawn(lambda ctx: order.append("d") or b.result + c.result,
                     deps=(b, c), name="d")
        stats = ex.run()
        return order, d.result, [t.state.name for t in (a, b, c, d)], stats
    order, result, _, _ = _twin(scenario)
    assert order == ["a", "b", "c", "d"] and result == 32


def test_priorities_and_continuations_twin():
    def scenario(lcx, amt, _):
        ex = amt.Executor()
        order, seen = [], []
        for name, prio in (("low", -1), ("hi", 5), ("mid", 2)):
            ex.spawn(lambda ctx, n=name: order.append(n), priority=prio,
                     name=name)
        a = ex.spawn(lambda ctx: 7, name="a")
        a.on_done(lambda r: seen.append(r))
        doubled = a.then(lambda r: r * 2)
        stats = ex.run()
        return order, seen, doubled.result, stats
    order, seen, doubled, _ = _twin(scenario)
    assert order == ["hi", "mid", "low"] and seen == [7] and doubled == 14


def test_deadlock_and_cycle_detection_twin():
    def scenario(lcx, amt, _):
        ex = amt.Executor()
        ex.promise(name="never-resolved")
        try:
            ex.run()
            deadlock = None
        except RuntimeError as e:
            deadlock = "deadlock" in str(e)
        g = amt.TaskGraph()
        a = g.add(lambda ctx: None, name="a")
        b = g.add(lambda ctx: None, deps=(a,), name="b")
        b.dependents.append(a)
        a.deps.append(b)
        a.n_waiting += 1
        try:
            g.validate_acyclic()
            cycle = None
        except ValueError:
            cycle = "cycle"
        return deadlock, cycle
    assert _twin(scenario) == (True, "cycle")


def _puts(n_tasks, n_puts, **ex_kw):
    def scenario(lcx, amt, scalar):
        ex = amt.Executor(**ex_kw)

        def maker(i):
            def fn(ctx):
                for j in range(n_puts):
                    ctx.put(scalar(i * n_puts + j), None, tag=j)
                return ctx.suspend(
                    lambda evs: sum(float(e.payload) for e in evs)
                    if isinstance(evs, list) else float(evs.payload),
                    n_events=n_puts)
            return fn

        tasks = [ex.spawn(maker(i), name=f"p{i}") for i in range(n_tasks)]
        stats = ex.run()
        return [t.result for t in tasks], stats, ex._progress_interval
    return scenario


@pytest.mark.parametrize("kw", [
    dict(progress_every=1),                           # interleaved progress
    dict(max_inflight=2, progress_every=1000),        # backpressure
    dict(progress_every=1, adaptive_progress=False),
], ids=["interleaved", "backpressure", "fixed_cadence"])
def test_loopback_comm_tasks_twin(kw):
    results, stats, _ = _twin(_puts(5, 3, **kw))
    assert results == [float(sum(range(3 * i, 3 * i + 3))) for i in range(5)]
    assert stats["events_retired"] == 15 and stats["tasks_resumed"] == 5


def test_adaptive_progress_backoff_twin():
    def scenario(lcx, amt, scalar):
        ex = amt.Executor(progress_every=1)
        for _ in range(6):
            ex.spawn(lambda ctx: None)
        ex.run()
        before = (dict(ex.stats), ex._progress_interval)

        def talker(ctx):
            ctx.put(scalar(1.0), None)
            return ctx.suspend(lambda ev: float(ev.payload))

        t = ex.spawn(talker)
        ex.run()
        return before, t.result, ex._progress_interval, dict(ex.stats)
    before, result, interval, _ = _twin(scenario)
    assert before[0]["progress_backoffs"] >= 1 and result == 1.0


def test_cq_overflow_retries_twin():
    def scenario(lcx, amt, scalar):
        ex = amt.Executor(cq=lcx.CompletionQueue(capacity=2),
                          progress_every=1000)

        def burst(ctx):
            for i in range(3):
                ctx.put(scalar(i), None, tag=i, max_retries=4)
            return ctx.suspend(lambda evs: len(evs), n_events=3)

        t = ex.spawn(burst)
        stats = ex.run()
        return t.result, ex.cq.overflows, stats
    result, overflows, _ = _twin(scenario)
    assert result == 3 and overflows >= 1


def test_watched_completion_objects_twin():
    def scenario(lcx, amt, scalar):
        ex = amt.Executor()
        sync = lcx.Synchronizer(threshold=2)
        cnt = lcx.CounterCompletion(target=3)

        def talker(ctx):
            for i in range(3):
                lcx.put_x(scalar(i)).remote_comp(sync).device(ex.device) \
                    .tag(i)()
                lcx.put_x(scalar(i)).remote_comp(cnt).device(ex.device) \
                    .tag(i)()
                ex._note_post()

        ex.spawn(talker)
        p1 = ex.watch(sync, k=lambda s: [float(e.payload)
                                         for e in s.wait(reset=True)])
        p2 = ex.watch(cnt, k=lambda c: c.count)
        stats = ex.run()
        return p1.result, p2.result, sync.ready(), stats
    events, count, ready, _ = _twin(scenario)
    assert len(events) == 2 and count == 3 and not ready


def _ranked_talker(n_events):
    def body(lcx, amt, x, out):
        lcx.init()
        ex = amt.Executor(device=lcx.Device(axis="x"), name="cq-test")

        def talker(ctx):
            for i in range(n_events):
                ctx.put(x + i, lcx.Perm.shift(1), tag=i)
            return ctx.suspend(
                lambda evs: sum(e.payload for e in evs)
                if isinstance(evs, list) else evs.payload,
                n_events=n_events)

        t = ex.spawn(talker, name="talker")
        out["stats"] = ex.run()
        out["dev"] = dict(ex.device.stats)
        return t.result
    return body


@pytest.mark.parametrize("n_events", [1, 3])
def test_ranked_comm_task_resumes_from_cq_twin(n_events):
    body = _ranked_talker(n_events)
    xs = np.arange(float(N), dtype=np.float32)
    jout, tout = {}, {}
    want = jax.vmap(lambda x: body(jlcx, jamt, x, jout), axis_name="x")(
        jnp.asarray(xs))
    with tlcx.ranks.bind_axis("x", N):
        got = body(tlcx, tamt, torch.from_numpy(xs), tout)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    v = np.roll(xs, 1)
    np.testing.assert_array_equal(got.numpy(),
                                  n_events * v + sum(range(n_events)))
    assert tout == jout
    assert jout["stats"]["tasks_resumed"] == 1
