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


# -- remote spawning (tests/test_amt.py, tests/test_faults.py) ---------------
@pytest.fixture
def clean_handlers():
    jamt.clear_task_handlers()
    tamt.clear_task_handlers()
    yield
    jamt.clear_task_handlers()
    tamt.clear_task_handlers()


def _ranked_spawn(name, reply, forget=False):
    """Rank r spawns ``name`` on rank r+1 with its value; returns the
    promise's value, or what the handler computed on the peer when
    ``reply`` is False.  ``forget`` clears the handler table after the
    spawn, as if the peer never registered it."""
    def body(lcx, amt, x, out):
        lcx.init()
        ex = amt.Executor(device=lcx.Device(axis="x"))
        sp = amt.RemoteSpawner(ex)
        promise = sp.spawn(name, x, lcx.Perm.shift(1), reply=reply)
        if forget:
            amt.clear_task_handlers()
        out["stats"] = ex.run()
        out["spawner"] = dict(sp.stats)
        out["dev"] = dict(ex.device.stats)
        if promise is None:
            (t,) = [t for t in ex.graph.tasks.values()
                    if t.name == f"remote:{name}"]
            return t.result
        if isinstance(promise.result, amt.RemoteFailure):
            out["failure"] = (promise.result.status, promise.result.ok,
                              promise.result.message)
            return x
        return promise.result
    return body


def _ranked_twin(body):
    xs = np.arange(float(N), dtype=np.float32)
    jout, tout = {}, {}
    want = jax.vmap(lambda x: body(jlcx, jamt, x, jout), axis_name="x")(
        jnp.asarray(xs))
    with tlcx.ranks.bind_axis("x", N):
        got = body(tlcx, tamt, torch.from_numpy(xs), tout)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tout == jout
    return got.numpy(), tout


def test_remote_spawn_roundtrips_result_between_neighbors_twin(
        clean_handlers):
    for amt in (jamt, tamt):
        amt.register_task_handler("affine", lambda v: v * 2.0 + 1.0)
    got, out = _ranked_twin(_ranked_spawn("affine", reply=True))
    np.testing.assert_array_equal(got, 2.0 * np.arange(N) + 1.0)
    assert out["dev"]["transfers"] == 2


def test_remote_spawn_no_reply_executes_on_peer_twin(clean_handlers):
    calls = []
    for amt in (jamt, tamt):
        amt.register_task_handler(
            "double", lambda v: calls.append(1) or v * 2.0)
    got, out = _ranked_twin(_ranked_spawn("double", reply=False))
    assert len(calls) == 2                 # one body per side
    assert out["stats"]["tasks_run"] == 1
    np.testing.assert_array_equal(got, 2.0 * np.array([3.0, 0.0, 1.0, 2.0]))


def test_ranked_unknown_handler_resolves_remote_failure_twin(
        clean_handlers):
    """The error reply travels back along the inverse ring: a dummy
    scalar per rank in the reference, a rank-stacked zeros(n) here."""
    for amt in (jamt, tamt):
        amt.register_task_handler("ghost", lambda p: p)
    _, out = _ranked_twin(_ranked_spawn("ghost", reply=True, forget=True))
    assert out["failure"][:2] == ("unknown_handler", False)
    assert out["spawner"]["unknown_handlers"] == 1


def test_remote_spawn_unknown_handler_raises_twin(clean_handlers):
    def scenario(lcx, amt, scalar):
        sp = amt.RemoteSpawner(amt.Executor())
        try:
            sp.spawn("nope", scalar(0), None)
        except KeyError as e:
            return "KeyError", str(e)
        return None
    assert _twin(scenario)[0] == "KeyError"


def test_remote_unknown_handler_resolves_remote_failure_twin(
        clean_handlers):
    def scenario(lcx, amt, scalar):
        amt.clear_task_handlers()
        ex = amt.Executor()
        sp = amt.RemoteSpawner(ex)
        amt.register_task_handler("ghost", lambda p: p)
        promise = sp.spawn("ghost", scalar(1.0), lcx.Perm.shift(0))
        amt.clear_task_handlers()
        stats = ex.run()
        res = promise.result
        return (type(res).__name__, res.status, res.ok, res.message,
                dict(sp.stats), stats)
    name, status, ok, _, sp_stats, _ = _twin(scenario)
    assert (name, status, ok) == ("RemoteFailure", "unknown_handler", False)
    assert sp_stats["unknown_handlers"] == 1


def test_remote_handler_exception_resolves_remote_failure_twin(
        clean_handlers):
    def scenario(lcx, amt, scalar):
        ex = amt.Executor()
        sp = amt.RemoteSpawner(ex)
        amt.register_task_handler("boom", lambda p: 1 / 0)
        amt.register_task_handler("double", lambda p: p * 2)
        p_bad = sp.spawn("boom", scalar(1.0), lcx.Perm.shift(0))
        p_ok = sp.spawn("double", scalar(3.0), lcx.Perm.shift(0))
        stats = ex.run()
        return (p_bad.result.status, p_bad.result.message,
                float(p_ok.result), dict(sp.stats), stats)
    status, message, ok, sp_stats, _ = _twin(scenario)
    assert status == "handler_error" and "ZeroDivisionError" in message
    assert ok == 6.0 and sp_stats["handler_errors"] == 1


def test_task_handler_decorator_registers_by_name(clean_handlers):
    @tamt.task_handler()
    def triple(v):
        return v * 3

    @tamt.task_handler("named")
    def other(v):
        return v

    tlcx.init()
    ex = tamt.Executor()
    sp = tamt.RemoteSpawner(ex)
    p1 = sp.spawn("triple", torch.tensor(2.0), tlcx.Perm.shift(0))
    p2 = sp.spawn("named", torch.tensor(5.0), tlcx.Perm.shift(0))
    ex.run()
    assert float(p1.result) == 6.0 and float(p2.result) == 5.0
