"""Twins of tests/test_failover.py and of the fault-runtime cases of
tests/test_faults.py and tests/test_runtime.py: each scenario runs on the
JAX package (``repro.core``, ``repro.runtime``, ``repro.amt``) and on the
port (``repro_torch.core``, ``repro_torch.runtime``, ``repro_torch.amt``)
and returns plain data — delivered payloads, heartbeat events, migration
reports, executor and failover stats — that must be equal.  Payloads are
scalars made from the same Python numbers, so they compare exactly.
(The gpipe case of tests/test_failover.py is in
tests/test_torch_pipeline.py.)"""
import dataclasses
import re
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.amt as jamt  # noqa: E402
import repro.core as jlcx  # noqa: E402
import repro.runtime.fault as jfault  # noqa: E402
from repro.core.attr import reset_global_attrs as jreset  # noqa: E402

import repro_torch.amt as tamt  # noqa: E402
import repro_torch.core as tlcx  # noqa: E402
import repro_torch.runtime as trt  # noqa: E402
from repro_torch.core.attr import reset_global_attrs as treset  # noqa: E402


def _side(lcx, amt, fault, scalar, zeros):
    return types.SimpleNamespace(
        lcx=lcx, amt=amt, Executor=amt.Executor, f32=scalar, zeros=zeros,
        HeartbeatMonitor=fault.HeartbeatMonitor,
        NodeFailure=fault.NodeFailure, FailureInjector=fault.FailureInjector,
        StragglerMonitor=fault.StragglerMonitor,
        fail_device=fault.fail_device,
        shrink_mesh_shape=fault.shrink_mesh_shape)


SIDES = {
    "jax": _side(jlcx, jamt, jfault, lambda v: jnp.float32(v),
                 lambda: jnp.zeros((), jnp.float32)),
    "torch": _side(tlcx, tamt, trt, lambda v: torch.tensor(float(v)),
                   lambda: torch.zeros(())),
}


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as e:          # the exception type is the outcome
        # the message without object addresses
        return ("raises", type(e).__name__, re.sub(r"@\w+", "", str(e)))


def _twin(scenario, raises=False):
    """``scenario(m)`` on both sides from fresh global state; equal
    outcomes, results unless ``raises``."""
    out = {}
    for side, m in SIDES.items():
        jreset()
        treset()
        out[side] = _outcome(lambda: scenario(m))
    jreset()
    treset()
    assert out["torch"] == out["jax"], out
    assert (out["jax"][0] == "raises") == raises, out
    return out["jax"][1] if not raises else out["jax"]


def _drain(m, rt, cq, want, max_ticks=400):
    for _ in range(max_ticks):
        m.lcx.progress()
        if len(cq) >= want and not rt.has_inflight():
            break
    return cq.pop_all()


def _fresh_pair(m):
    m.lcx.init()
    rt = m.lcx.runtime()
    return rt, rt.device(), rt.device()


def _dev_index(rt, dev):
    if dev is None:
        return None
    devs = rt.devices()
    return next((i for i, d in enumerate(devs) if d is dev), "other")


def _report(rt, rep):
    if rep is None:
        return None
    out = dataclasses.asdict(dataclasses.replace(rep, dead=None,
                                                 target=None))
    out.update(dead=_dev_index(rt, rep.dead),
               target=_dev_index(rt, rep.target))
    return out


def _events(rt, hb):
    """Heartbeat declarations as data: devices by their index in the
    runtime's device list."""
    return [{"tick": e["tick"], "policy": e["policy"],
             "device": _dev_index(rt, e["device"]),
             "target": _dev_index(rt, e.get("target")),
             "report": _report(rt, e.get("report")),
             "error": e.get("error")} for e in hb.events]


def _payloads(evs):
    return sorted(float(ev.payload) for ev in evs)


# -- tests/test_failover.py --------------------------------------------------
def test_kill_one_of_two_devices_mid_pingpong_twin():
    def scenario(m):
        rt, ping, pong = _fresh_pair(m)
        m.lcx.install_transport(m.lcx.FaultyTransport(seed=11, drop=0.1))
        hb = m.HeartbeatMonitor(threshold=2.0, patience=2, grace=3,
                                on_dead="failover").attach(rt)
        for _ in range(4):
            m.lcx.progress()
        cq = m.lcx.CompletionQueue()
        n = 24
        for i in range(n):
            dev = ping if i % 2 == 0 else pong
            m.lcx.put_x(m.f32(i)).remote_comp(cq).device(dev) \
                .tag(i).max_retries(32)()
        ping.freeze()
        evs = _drain(m, rt, cq, n)
        return (_payloads(evs), _events(rt, hb), ping.alive,
                _dev_index(rt, ping.migrated_to), ping.migrated_to.alive,
                dict(rt.failover_stats), rt.tick)
    got, events, alive, _, target_alive, stats, _ = _twin(scenario)
    assert got == [float(i) for i in range(24)]
    assert len(events) == 1 and events[0]["device"] == 1
    assert not alive and target_alive and stats["failovers"] == 1


def test_migrated_flag_set_on_replayed_deliveries_twin():
    def scenario(m):
        rt, a, b = _fresh_pair(m)
        cq = m.lcx.CompletionQueue()
        for i in range(4):
            m.lcx.put_x(m.f32(i)).remote_comp(cq).device(a).tag(i)()
        a.freeze()
        rep = rt.failover(a, target=b)
        evs = _drain(m, rt, cq, 4)
        return ([ev.migrated for ev in evs], _payloads(evs),
                _report(rt, rep))
    migrated, got, _ = _twin(scenario)
    assert migrated == [True] * 4 and got == [0.0, 1.0, 2.0, 3.0]


def test_unmatched_send_migrates_and_matches_on_target_twin():
    def scenario(m):
        rt, a, b = _fresh_pair(m)
        scq, rcq = m.lcx.CompletionQueue(), m.lcx.CompletionQueue()
        m.lcx.send_x(m.f32(42.0)).comp(scq).device(a).tag(9)()
        a.freeze()
        rep = rt.failover(a, target=b)
        m.lcx.recv_x(m.zeros()).comp(rcq).device(b).tag(9)()
        evs = _drain(m, rt, rcq, 1)
        return _report(rt, rep), float(evs[0].payload), evs[0].migrated
    rep, payload, migrated = _twin(scenario)
    assert rep["n_engine_ops"] == 1 and payload == 42.0 and migrated


def test_failover_picks_least_loaded_survivor_twin():
    def scenario(m):
        m.lcx.init()
        rt = m.lcx.runtime()
        a, busy, idle = rt.device(), rt.device(), rt.device()
        cq = m.lcx.CompletionQueue()
        for i in range(5):
            m.lcx.put_x(m.f32(i)).remote_comp(cq).device(busy).tag(i)()
        a.freeze()
        rep = rt.failover(a)
        return (rt.pending_for(busy), rt.pending_for(idle),
                _report(rt, rep), rep.target is busy, rep.target is a)
    pb, pi, _, is_busy, is_dead = _twin(scenario)
    assert pb > pi and not is_busy and not is_dead


def test_failover_without_survivor_raises_twin():
    def scenario(m):
        m.lcx.init(alloc_default_resources=False)
        rt = m.lcx.runtime()
        a = rt.device()
        a.freeze()
        rt.failover(a)
    out = _twin(scenario, raises=True)
    assert out[1] == "RuntimeError" and "no alive device" in out[2]


def test_resolve_resources_follows_migration_chain_twin():
    def scenario(m):
        rt, a, b = _fresh_pair(m)
        a.freeze()
        rt.failover(a, target=b)
        cq = m.lcx.CompletionQueue()
        m.lcx.put_x(m.f32(1.0)).remote_comp(cq).device(a).tag(0)()
        evs = _drain(m, rt, cq, 1)
        return a.resolve_migrated() is b, _payloads(evs)
    assert _twin(scenario) == (True, [1.0])


def _stalled_runtime(m, policy, **kw):
    m.lcx.init()
    rt = m.lcx.runtime()
    a, b = rt.device(), rt.device()
    hb = m.HeartbeatMonitor(threshold=2.0, patience=2, grace=3,
                            on_dead=policy, **kw).attach(rt)
    for _ in range(4):
        m.lcx.progress()
    cq = m.lcx.CompletionQueue()
    for i in range(3):
        m.lcx.put_x(m.f32(i)).remote_comp(cq).device(a).tag(i)()
    a.freeze()
    return rt, a, b, hb, cq


def test_heartbeat_policy_drain_surfaces_fatal_twin():
    def scenario(m):
        rt, a, _, hb, cq = _stalled_runtime(m, "drain")
        for _ in range(40):
            m.lcx.progress()
            if len(cq) >= 3:
                break
        evs = cq.pop_all()
        return (sorted({ev.status.name for ev in evs}), a.alive,
                a.migrated_to is None, _events(rt, hb))
    statuses, alive, unmigrated, events = _twin(scenario)
    assert statuses == ["FATAL"] and not alive and unmigrated
    assert events[0]["policy"] == "drain"


def test_heartbeat_policy_raise_twin():
    def scenario(m):
        rt, a, _, hb, cq = _stalled_runtime(m, "raise")
        try:
            for _ in range(40):
                m.lcx.progress()
        except m.NodeFailure as e:
            return (str(e).split(" on ")[0], e.lost_devices, a.alive,
                    rt.tick, _events(rt, hb))
        return None
    msg, lost, alive, _, _ = _twin(scenario)
    assert msg == "heartbeat lost" and lost == 1 and not alive


def test_heartbeat_ignores_healthy_jitter_twin():
    def scenario(m):
        m.lcx.init()
        rt = m.lcx.runtime()
        rt.device(), rt.device()
        hb = m.HeartbeatMonitor(threshold=2.0, patience=2,
                                grace=3).attach(rt)
        for _ in range(50):
            m.lcx.progress()
        return hb.events, rt.failover_stats["failovers"]
    assert _twin(scenario) == ([], 0)


def test_invalid_heartbeat_policy_rejected_twin():
    out = _twin(lambda m: m.HeartbeatMonitor(on_dead="shrug"), raises=True)
    assert out[1] == "ValueError" and "on_dead" in out[2]


def _worker(m, got, i):
    def run(ctx):
        ctx.put(m.f32(i), None, tag=i, max_retries=16)
        return ctx.suspend(lambda ev: got.append(float(ev.payload)))
    return run


def test_executor_drains_taskgraph_under_automatic_failover_twin():
    def scenario(m):
        m.lcx.init()
        rt = m.lcx.runtime()
        primary, standby = rt.device(), rt.device()
        hb = m.HeartbeatMonitor(threshold=2.0, patience=2, grace=3,
                                on_dead="failover").attach(rt)
        for _ in range(4):
            m.lcx.progress()
        ex = m.Executor(name="fo", runtime=rt, device=primary,
                        fail_fast=False)
        got = []
        for i in range(4):
            ex.spawn(_worker(m, got, i), priority=4, name=f"w{i}")
        ex.spawn(lambda ctx: primary.freeze(), priority=2, name="killer")
        for i in range(4, 8):
            ex.spawn(_worker(m, got, i), priority=0, name=f"w{i}")
        stats = ex.run()
        return (sorted(got), ex.dead_letter, dict(rt.failover_stats),
                primary.alive, ex.device is primary.resolve_migrated(),
                stats, _events(rt, hb))
    got, dead, fo, alive, rehomed, _, _ = _twin(scenario)
    assert got == [float(i) for i in range(8)] and dead == []
    assert fo["failovers"] == 1 and not alive and rehomed


def test_executor_redispatches_on_nonreplayable_migration_twin():
    def scenario(m):
        m.lcx.init()
        rt = m.lcx.runtime()
        primary = rt.device()
        rt.device(axis=None)
        ex = m.Executor(name="rd", runtime=rt, device=primary,
                        fail_fast=False)
        got = []

        def worker(i):
            def run(ctx):
                ctx.put(m.f32(i), None, tag=i)
                return ctx.suspend(lambda ev: got.append(float(ev.payload)))
            return run

        for i in range(4):
            ex.spawn(worker(i), name=f"w{i}")

        def killer(ctx):
            primary.freeze()
            rt.failover(primary, replay=False)

        ex.spawn(killer, priority=-5, name="killer")
        stats = ex.run()
        return sorted(got), stats, ex.dead_letter, dict(rt.failover_stats)
    got, stats, dead, _ = _twin(scenario)
    assert got == [0.0, 1.0, 2.0, 3.0]
    assert stats["tasks_redispatched"] == 4 and dead == []


def test_executor_backpressure_is_per_device_twin():
    def scenario(m):
        m.lcx.init()
        rt = m.lcx.runtime()
        mine, neighbour = rt.device(), rt.device()
        ncq = m.lcx.CompletionQueue()
        for i in range(32):
            m.lcx.put_x(m.f32(i)).remote_comp(ncq).device(neighbour) \
                .tag(i)()
        ex = m.Executor(name="bp", runtime=rt, device=mine, max_inflight=8)
        got = []

        def worker(i):
            def run(ctx):
                ctx.put(m.f32(i), None, tag=i)
                return ctx.suspend(lambda ev: got.append(float(ev.payload)))
            return run

        for i in range(4):
            ex.spawn(worker(i), name=f"w{i}")
        stats = ex.run()
        return sorted(got), stats
    got, stats = _twin(scenario)
    assert got == [0.0, 1.0, 2.0, 3.0] and stats["backpressure_stalls"] == 0


def test_cancel_across_migration_twin():
    def scenario(m):
        rt, a, b = _fresh_pair(m)
        scq = m.lcx.CompletionQueue()
        h = m.lcx.send_x(m.f32(1.0)).comp(scq).device(a).tag(5)()
        a.freeze()
        rt.failover(a, target=b)
        op = h.posted
        eng, op.engine = op.engine, None
        refused = h.cancel()
        op.engine = eng
        cancelled = h.cancel()
        evs = scq.pop_all()
        rcq = m.lcx.CompletionQueue()
        m.lcx.recv_x(m.zeros()).comp(rcq).device(b).tag(5).timeout(8)()
        for _ in range(12):
            m.lcx.progress()
            if len(rcq):
                break
        return (refused, cancelled, h.status, evs[-1].status.name,
                rcq.pop_all()[0].status.name)
    assert _twin(scenario) == (False, True, "cancelled", "CANCELLED",
                               "TIMEOUT")


def test_max_retries_budget_preserved_across_migration_twin():
    def scenario(m):
        rt, a, b = _fresh_pair(m)
        m.lcx.install_transport(m.lcx.FaultyTransport(seed=3, drop=1.0))
        cq = m.lcx.CompletionQueue()
        h = m.lcx.put_x(m.f32(7.0)).remote_comp(cq).device(a) \
            .max_retries(6)()
        for _ in range(3):
            m.lcx.progress()
        burned = h.posted.retries
        a.freeze()
        rt.failover(a, target=b)
        kept = h.posted.retries
        for _ in range(300):
            m.lcx.progress()
            if len(cq):
                break
        return burned, kept, cq.pop_all()[0].status.name, h.posted.retries
    burned, kept, status, final = _twin(scenario)
    assert burned > 0 and kept == burned and status == "FATAL" and final == 6


def test_dedup_window_evicts_at_boundary_twin():
    def scenario(m):
        rt = m.lcx.Runtime(name="w", alloc_default_resources=False,
                           dedup_window=4)
        for seq in range(1, 6):
            rt.note_delivered(seq)
        return [rt.was_delivered(s) for s in (1, 2, 3, 4, 5, 99)]
    assert _twin(scenario) == [False, True, True, True, True, False]


def test_replayed_migrated_delivery_suppressed_twin():
    def scenario(m):
        rt, a, b = _fresh_pair(m)
        scq, rcq = m.lcx.CompletionQueue(), m.lcx.CompletionQueue()
        hs = m.lcx.send_x(m.f32(3.0)).comp(scq).device(a).tag(1)()
        hr = m.lcx.recv_x(m.zeros()).comp(rcq).device(a).tag(1)()
        first = len(_drain(m, rt, rcq, 1))
        scq.pop_all()
        s, r = hs.posted, hr.posted
        s.migrated = r.migrated = True
        s.device = r.device = b
        rt.enqueue_matches([(s, r)])
        for _ in range(5):
            m.lcx.progress()
        return first, len(rcq), len(scq), dict(rt.failover_stats)
    first, nr, ns, fo = _twin(scenario)
    assert (first, nr, ns, fo["dedup_suppressed"]) == (1, 0, 0, 1)


def test_dedup_window_boundary_allows_evicted_replay_twin():
    def scenario(m):
        rt = m.lcx.Runtime(name="wb", dedup_window=2)
        dev = rt.device()
        rcqs, pairs = [], []
        for i in range(3):
            scq, rcq = m.lcx.CompletionQueue(), m.lcx.CompletionQueue()
            hs = m.lcx.send_x(m.f32(i)).comp(scq).device(dev).tag(i) \
                .runtime(rt)()
            hr = m.lcx.recv_x(m.zeros()).comp(rcq).device(dev).tag(i) \
                .runtime(rt)()
            rcqs.append(rcq)
            pairs.append((hs.posted, hr.posted))
        for _ in range(10):
            m.lcx.progress_x().runtime(rt)()
            if all(len(q) for q in rcqs):
                break
        for q in rcqs:
            q.pop_all()
        for s, r in (pairs[0], pairs[2]):
            s.migrated = r.migrated = True
            rt.enqueue_matches([(s, r)])
        for _ in range(5):
            m.lcx.progress_x().runtime(rt)()
        return len(rcqs[0]), len(rcqs[2]), dict(rt.failover_stats)
    n0, n2, fo = _twin(scenario)
    assert (n0, n2, fo["dedup_suppressed"]) == (1, 0, 1)


def test_unmigrated_duplicates_still_deliver_twice_twin():
    def scenario(m):
        m.lcx.init()
        rt = m.lcx.runtime()
        m.lcx.install_transport(m.lcx.FaultyTransport(seed=5,
                                                      duplicate=1.0))
        cq = m.lcx.CompletionQueue()
        m.lcx.put_x(m.f32(1.0)).remote_comp(cq).tag(0)()
        for _ in range(20):
            m.lcx.progress()
            if len(cq) >= 2:
                break
        return _payloads(cq.pop_all()), rt.failover_stats["dedup_suppressed"]
    assert _twin(scenario) == ([1.0, 1.0], 0)


def test_serving_engine_failover_wiring_twin():
    """tests/test_failover.py's serving case on both engines: the wiring,
    then a frozen serving device that must not wedge the tick loop."""
    from repro.configs.base import ModelConfig as JConfig
    from repro.models import init_model as jinit
    from repro.serving import Request as JRequest
    from repro.serving import ServeConfig as JServe
    from repro.serving import ServingEngine as JEngine
    from repro_torch.configs.base import ModelConfig as TConfig
    from repro_torch.convert import params_from_jax
    from repro_torch.serving import Request as TRequest
    from repro_torch.serving import ServeConfig as TServe
    from repro_torch.serving import ServingEngine as TEngine

    kw = dict(name="d", n_layers=1, d_model=32, n_heads=2, n_kv_heads=2,
              d_ff=64, vocab=97, q_block=8)
    jcfg = JConfig(dtype=jnp.float32, param_dtype=jnp.float32, **kw)
    tcfg = TConfig(dtype=torch.float32, param_dtype=torch.float32, **kw)
    jp = jax.jit(lambda k: jinit(k, jcfg)[0])(jax.random.PRNGKey(0))
    tp = params_from_jax(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    scfg = dict(n_slots=2, max_seq=32, max_new_tokens=3)
    engines = {
        "jax": lambda: JEngine(jcfg, jp, JServe(**scfg), failover=True),
        "torch": lambda: TEngine(tcfg, tp, TServe(**scfg), failover=True,
                                 device="cpu"),
    }
    requests = {"jax": JRequest, "torch": TRequest}
    out = {}
    for side, make in engines.items():
        jreset()
        treset()
        eng = make()
        wiring = (eng.heartbeat is not None,
                  eng.lcx_runtime.heartbeat is eng.heartbeat,
                  eng.standby_device is not None and eng.standby_device.alive,
                  eng.heartbeat.on_dead)
        primary = eng._executor.device
        primary.freeze()
        eng.submit(requests[side](rid=0, prompt=np.arange(4,
                                                          dtype=np.int32)))
        done = eng.run_until_drained()
        rt = eng.lcx_runtime
        out[side] = (wiring, [(r.rid, r.output, r.error) for r in done],
                     dict(eng.stats), _events(rt, eng.heartbeat),
                     dict(rt.failover_stats), primary.alive, rt.tick)
    jreset()
    treset()
    assert out["torch"] == out["jax"]
    wiring, done = out["torch"][:2]
    assert wiring == (True, True, True, "failover")
    assert len(done) == 1 and done[0][2] is None


# -- tests/test_faults.py: dead devices, injector, remesh --------------------
def test_dead_device_drains_fatal_twin():
    def scenario(m):
        m.lcx.init()
        dev = m.lcx.Device()
        sync = m.lcx.Synchronizer()
        m.lcx.put_x(m.f32(1.0)).remote_comp(sync).device(dev)()
        drained = m.fail_device(dev)
        (ev,) = sync.wait(raise_on_error=False)
        pending = m.lcx.runtime().pending_count()
        sync2 = m.lcx.Synchronizer()
        m.lcx.put_x(m.f32(1.0)).remote_comp(sync2).device(dev)()
        m.lcx.progress()
        (ev2,) = sync2.wait(raise_on_error=False)
        return drained, dev.alive, ev.status.name, pending, ev2.status.name
    assert _twin(scenario) == (1, False, "FATAL", 0, "FATAL")


def test_fail_device_drains_its_own_runtime_twin():
    """tests/test_resources_hierarchy.py: a hierarchy-created device's
    ledger is drained through ``dev.runtime``, not the global one."""
    def scenario(m):
        m.lcx.init()
        rt = m.lcx.Runtime(name="own")
        dev = rt.device()
        sync = m.lcx.Synchronizer()
        m.lcx.put_x(m.f32(2.0)).remote_comp(sync).device(dev) \
            .runtime(rt)()
        return (m.fail_device(dev), rt.pending_count(),
                sync.wait(raise_on_error=False)[0].status.name)
    assert _twin(scenario) == (1, 0, "FATAL")


def test_node_failure_feeds_elastic_reshard():
    """An injected NodeFailure kills the device, pending comm drains
    fatal on both sides, and the port's elastic_reshard moves live state
    to the devices named leaf by leaf."""
    def scenario(m):
        m.lcx.init()
        dev = m.lcx.Device()
        sync = m.lcx.Synchronizer()
        m.lcx.put_x(m.f32(4.0)).remote_comp(sync).device(dev)()
        inj = m.FailureInjector(fail_at=[2], lost_devices=1, devices=[dev])
        inj.check(1)
        try:
            inj.check(2)
            lost = None
        except m.NodeFailure as e:
            lost = e.lost_devices
        (ev,) = sync.wait(raise_on_error=False)
        return lost, inj.fired, ev.status.name, dev.alive
    assert _twin(scenario) == (1, [2], "FATAL", False)
    state = {"w": torch.arange(8.0), "b": [torch.ones(3), torch.zeros(2)]}
    new = trt.elastic_reshard(state, {"w": "cpu", "b": ["cpu", "cpu"]})
    assert torch.equal(new["w"], state["w"]) and isinstance(new["b"], list)
    assert all(t.device.type == "cpu" for t in (new["w"], *new["b"]))


def test_failure_injector_schedule_twin():
    """tests/test_runtime.py's injector schedule: fires once per step in
    ``fail_at`` and carries ``lost_devices``."""
    def scenario(m):
        inj = m.FailureInjector(fail_at=[7, 13], lost_devices=2)
        seen = []
        for step in range(20):
            try:
                inj.check(step)
            except m.NodeFailure as e:
                seen.append((step, e.lost_devices, str(e)))
        return seen, inj.fired, sorted(inj.fail_at)
    seen, fired, left = _twin(scenario)
    assert [s for s, _, _ in seen] == [7, 13] == fired and left == []


@pytest.mark.parametrize("case", ["flags", "ema_freeze"])
def test_straggler_monitor_twin(case):
    def scenario(m):
        if case == "flags":
            mon = m.StragglerMonitor(threshold=2.0, patience=2)
            steps = [(1, 1.0), (2, 1.05), (3, 5.0), (4, 5.0), (5, 1.0),
                     (6, 5.0), (7, 1.0)]
        else:
            mon = m.StragglerMonitor(threshold=2.0, patience=3,
                                     ema_decay=0.5)
            steps = [(0, 1.0), (1, 10.0), (2, 10.0), (3, 10.0), (4, 1.2)]
        verdicts = [(mon.observe(s, dt), mon.ema, mon.slow_streak)
                    for s, dt in steps]
        return verdicts, mon.events
    verdicts, _ = _twin(scenario)
    if case == "flags":
        assert [v for v, _, _ in verdicts] == [
            "ok", "ok", "slow", "remesh", "ok", "slow", "ok"]
    else:
        assert [v for v, _, _ in verdicts][3] == "remesh"


@pytest.mark.parametrize("shape,lost", [
    ({"data": 16, "model": 16}, 1), ({"data": 16, "model": 16}, 5),
    ({"data": 8}, 1), ({"data": 8}, 5), ({"data": 4}, 100),
    ({"model": 8}, 1)])
def test_shrink_mesh_shape_twin(shape, lost):
    assert _twin(lambda m: m.shrink_mesh_shape(shape, lost))
