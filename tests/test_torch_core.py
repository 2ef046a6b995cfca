"""Twins of the LCX core tests (tests/test_flex.py,
tests/test_core_resources.py, tests/test_resources_hierarchy.py): the
same scenario runs on the JAX package's ``repro.core`` and on the port's
``repro_torch.core``, and the outcomes are compared.  Multi-rank
scenarios run the reference under ``jax.vmap(axis_name="x")`` and the
port on rank-stacked ``[4, ...]`` tensors."""
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as jlcx  # noqa: E402
import repro.core.flex as jflex  # noqa: E402
from repro.core.attr import reset_global_attrs as jreset  # noqa: E402
from repro.core.resources import PostedOp as JPostedOp  # noqa: E402

import repro_torch.core as tlcx  # noqa: E402
import repro_torch.core.flex as tflex  # noqa: E402
from repro_torch.core.attr import reset_global_attrs as treset  # noqa: E402
from repro_torch.core.resources import PostedOp as TPostedOp  # noqa: E402

N = 4
SIDES = {"jax": (jlcx, jflex, JPostedOp), "torch": (tlcx, tflex, TPostedOp)}


@pytest.fixture(autouse=True)
def fresh_runtimes():
    jreset()
    treset()
    jlcx.init()
    tlcx.init()
    yield
    jreset()
    treset()


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as e:          # the exception type is the outcome
        return ("raises", type(e).__name__)


def _twin(scenario, raises=False):
    """Run ``scenario(lcx, flex, PostedOp)`` on both sides; the outcomes
    must be equal, and must be results unless ``raises``."""
    out = {side: _outcome(lambda m=mods: scenario(*m))
           for side, mods in SIDES.items()}
    assert out["torch"] == out["jax"], out
    assert (out["jax"][0] == "raises") == raises, out
    return out["jax"]


# -- flexible functions (tests/test_flex.py) ---------------------------------
def _foo_x(flex):
    class foo_x(flex.FlexOp):
        _positional = ("a",)
        _optional = dict(b=10, c=None, d="x", must=None)

        def _invoke(self):
            return (self.arg("a"), self.arg("b"), self.arg("c"),
                    self.arg("d"))
    return foo_x


FLEX_SCENARIOS = {
    "defaults": lambda f: f(1)(),
    "any_order": lambda f: (f(1).c(3).b(2)(), f(1).d("y").b(0).c(9)()),
    "reuse": lambda f: (lambda op: (op(), op.c(7) and op(), op()))(f(1).b(5)),
    "late_override": lambda f: (lambda op: (op(c=42), op()))(f(1).b(5)),
    "clone": lambda f: (lambda op: (op.clone().b(6)(), op()))(f(1).b(5)),
    "kwargs": lambda f: f(1, b=2, c=3)(),
    "unknown": lambda f: f(1, nope=2),
    "unknown_late": lambda f: f(1)(nope=2),
    "missing_positional": lambda f: f()(),
    "too_many": lambda f: f(1, 2),
    "repr": lambda f: ("a=1" in repr(f(1).b(2)), "b=2" in repr(f(1).b(2))),
}


RAISING = ("unknown", "unknown_late", "missing_positional", "too_many")


@pytest.mark.parametrize("name", sorted(FLEX_SCENARIOS))
def test_flex_twin(name):
    got = _twin(lambda lcx, flex, _: FLEX_SCENARIOS[name](_foo_x(flex)),
                raises=name in RAISING)
    if name in RAISING:
        assert got == ("raises", "TypeError")


def test_flex_plain_and_required_twin():
    def scenario(lcx, flex, _):
        class req_x(flex.FlexOp):
            _positional = ()
            _optional = dict(must=flex.REQUIRED)

            def _invoke(self):
                return self.arg("must")

        foo = flex.plain(_foo_x(flex))
        return (foo(1, b=2), foo.__name__, req_x().must(3)(),
                _outcome(lambda: req_x()()))
    assert _twin(scenario)[1][3] == ("raises", "TypeError")


# -- attributes and completion objects (tests/test_core_resources.py) --------
def test_attrs_twin(monkeypatch):
    monkeypatch.setenv("LCX_ATTR_NPACKETS", "99")

    def scenario(lcx, flex, _):
        from importlib import import_module
        attr = import_module(lcx.__name__ + ".attr")
        out = [lcx.PacketPool().get_attr_packet_size(),
               lcx.PacketPool(packet_size=128).get_attr_packet_size(),
               lcx.PacketPool().get_attr_npackets()]
        attr.set_global_attr("packet_size", 512)
        out += [lcx.PacketPool().get_attr_packet_size(),
                lcx.PacketPool(packet_size=64).get_attr_packet_size(),
                _outcome(lambda: lcx.PacketPool(bogus=1))]
        return out
    assert _twin(scenario)[1] == [65536, 128, 99, 512, 64,
                                  ("raises", "AttributeError")]


def test_completion_objects_twin():
    def scenario(lcx, flex, _):
        out = []
        sync = lcx.Synchronizer(threshold=3)
        for i in range(2):
            sync.signal(lcx.Event(payload=i))
        out += [sync.ready(), _outcome(sync.wait)[0]]
        sync.signal(lcx.Event(payload=2))
        out += [sync.ready(), [e.payload for e in sync.wait()], sync.ready()]
        cq = lcx.CompletionQueue(capacity=2)
        out += [cq.signal(lcx.Event(payload=p)).name for p in "abc"]
        out += [cq.overflows, cq.pop().payload, len(cq),
                [e.payload for e in cq.pop_all()], cq.pop()]
        fh = lcx.FunctionHandler(lambda ev: ev.payload * 2)
        fh.signal(lcx.Event(payload=21))
        c = lcx.CounterCompletion(target=2)
        c.signal(lcx.Event())
        out += [fh.results, c.ready()]
        c.signal(lcx.Event())
        out += [c.ready(), lcx.PacketPool(packet_size=100).is_eager(100),
                lcx.PacketPool(packet_size=100).is_eager(101)]
        return out
    _twin(scenario)


# -- matching (tests/test_core_resources.py) ---------------------------------
def _random_ops(lcx, PostedOp, rng, n, device):
    perms = [None, lcx.Perm.shift(1), lcx.Perm.shift(2),
             lcx.Perm.pairs([(0, 1)]), lcx.Perm.pairs([(1, 2), (0, 1)])]
    return [PostedOp(kind=rng.choice(("send", "recv")), buffer=None,
                     perm=rng.choice(perms), tag=rng.randrange(4),
                     comp=None, device=device, seq=seq)
            for seq in range(n)]


@pytest.mark.parametrize("kind", ["map", "queue"])
@pytest.mark.parametrize("policy", ["none", "rank_only", "tag_only",
                                    "rank_tag", "custom"])
def test_match_order_twin(kind, policy):
    def scenario(lcx, flex, PostedOp):
        key_fn = (lambda op: op.tag % 3) if policy == "custom" else None
        dev = lcx.Device(axis="x", mesh_shape={"x": N})
        eng = lcx.MatchingEngine(kind=kind, policy=policy, key_fn=key_fn)
        ops = _random_ops(lcx, PostedOp, random.Random(f"{kind}/{policy}"),
                          300, dev)
        matches = [[(s.seq, r.seq) for s, r in eng.post(op)] for op in ops]
        return matches, eng.pending()
    matches, _ = _twin(scenario)[1]
    if kind == "map":     # an in-order queue may block on its first heads
        assert sum(map(len, matches)) > 0


def test_engine_argument_checks_twin():
    def scenario(lcx, flex, _):
        return [_outcome(lambda: lcx.MatchingEngine(kind="hashmap")),
                _outcome(lambda: lcx.MatchingEngine(policy="rank_tag_plus")),
                _outcome(lambda: lcx.MatchingEngine(policy="custom"))]
    assert _twin(scenario)[1] == [("raises", "ValueError")] * 3


def test_per_device_ledger_twin():
    """take_ready drains one device's ledger without touching another's;
    a cross-device match is claimed once."""
    def scenario(lcx, flex, PostedOp):
        rt = lcx.runtime()
        d1 = lcx.Device(axis="x", mesh_shape={"x": N})
        d2 = lcx.Device(axis="x", mesh_shape={"x": N})
        op = lambda kind, tag, dev: PostedOp(kind=kind, buffer=None,
                                             perm=None, tag=tag, comp=None,
                                             device=dev, seq=tag)
        m = [(op("send", t, d), op("recv", t, d))
             for t, d in ((1, d1), (2, d2), (3, d1))]
        rt.enqueue_matches(m)
        name = lambda ms: [s.tag for s, _ in ms]
        out = [rt.pending_count(), name(rt.take_ready(d1)),
               rt.pending_count(), name(rt.take_ready(d1)),
               name(rt.take_ready(d2)), rt.pending_count()]
        cross = (op("send", 9, d1), op("recv", 9, d2))
        rt.enqueue_matches([cross])
        out += [name(rt.take_ready(d2)), name(rt.take_ready(d1)),
                rt.pending_count()]
        return out
    assert _twin(scenario)[1] == [3, [1, 3], 1, [], [2], 0, [9], [], 0]


def test_hierarchy_and_resolution_twin():
    """tests/test_resources_hierarchy.py: construction and resolution
    order endpoint > device > runtime, with two runtimes isolated."""
    def scenario(lcx, flex, _):
        rt = lcx.Runtime(name="mine")
        nc, dev = rt.default_net_context, rt.default_device
        ep = rt.default_endpoint
        out = [nc in rt.net_contexts, dev in nc.devices,
               dev.net_context is nc, dev.runtime is rt,
               ep is dev.default_endpoint, rt.default_engine is dev.engine,
               rt.default_pool is dev.pool, rt.default_cq is dev.cq]
        dev2 = rt.device()
        ep2 = dev2.endpoint()
        res = lcx.resolve_resources(runtime=rt, device=dev2, endpoint=ep2)
        out += [res.engine is ep2.engine, res.device is dev2,
                _outcome(lambda: lcx.NetContext(rt, backend="carrier-pigeon"))]
        rt2 = lcx.Runtime(name="other")
        out += [rt2.default_engine is not rt.default_engine,
                rt.pending_count(), rt2.pending_count()]
        return out
    _twin(scenario)


# -- the quickstart on 4 ranks (examples/quickstart.py) ----------------------
def _quickstart(lcx, x, stats):
    lcx.init()
    dev = lcx.Device(axis="x")
    sync = lcx.Synchronizer(threshold=1)
    lcx.put_x(x).perm(lcx.Perm.shift(1)).remote_comp(sync).device(dev)()
    lcx.progress()
    (ev,) = sync.wait()
    neighbour = ev.payload
    cq = lcx.CompletionQueue()
    fh = lcx.FunctionHandler(lambda e: e.payload * 2)
    lcx.am_x(x).perm(lcx.Perm.shift(2)).remote_comp(cq).device(dev)()
    lcx.am_x(x).perm(lcx.Perm.shift(1)).remote_comp(fh).device(dev)()
    lcx.progress()
    from_two_away = cq.pop().payload
    doubled = fh.results[0]
    eng = lcx.MatchingEngine(kind="map", policy="rank_tag")
    s2 = lcx.Synchronizer(threshold=2)
    lcx.send_x(x * 10).perm(lcx.Perm.shift(1)).tag(7).comp(s2) \
        .matching_engine(eng).device(dev)()
    lcx.recv_x(x).perm(lcx.Perm.shift(1)).tag(7).comp(s2) \
        .matching_engine(eng).device(dev)()
    lcx.progress()
    matched = [e.payload for e in s2.wait() if e.payload is not None][0]
    total = lcx.all_reduce(x, device=dev, backend="ring")
    stats["dev"] = dict(dev.stats)
    stats["pool"] = dict(lcx.runtime().default_pool.stats)
    return neighbour, from_two_away, doubled, matched, total


def test_quickstart_four_ranks_twin():
    xs = np.arange(float(N), dtype=np.float32)
    jstats, tstats = {}, {}
    want = jax.vmap(lambda x: _quickstart(jlcx, x, jstats),
                    axis_name="x")(jnp.asarray(xs))
    with tlcx.ranks.bind_axis("x", N):
        got = _quickstart(tlcx, torch.from_numpy(xs), tstats)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(got[0].numpy(), np.roll(xs, 1))
    np.testing.assert_array_equal(got[4].numpy(), np.full(N, xs.sum()))
    assert tstats == jstats
    assert jstats["dev"]["transfers"] > 0


def test_aggregated_mixed_dtypes_twin():
    """Small eager puts on one perm share one transfer through a byte
    view; bools travel in their own class."""
    rng = np.random.default_rng(0)
    payloads = [rng.standard_normal((N, 3)).astype(np.float32),
                rng.integers(-9, 9, (N, 5)).astype(np.int32),
                rng.standard_normal((N, 2)).astype(np.float32),
                rng.integers(0, 2, (N, 4)).astype(bool)]

    def body(lcx, xs, stats):
        lcx.init()
        dev = lcx.Device(axis="x")
        cq = lcx.CompletionQueue()
        for i, x in enumerate(xs):
            lcx.put_x(x).perm(lcx.Perm.shift(1)).tag(i).remote_comp(cq) \
                .device(dev)()
        lcx.progress()
        evs = sorted(cq.pop_all(), key=lambda e: e.tag)
        stats["dev"] = dict(dev.stats)
        stats["pool"] = dict(lcx.runtime().default_pool.stats)
        return [e.payload for e in evs]

    jstats, tstats = {}, {}
    want = jax.vmap(lambda *xs: body(jlcx, xs, jstats), axis_name="x")(
        *[jnp.asarray(p[:, None] if p.ndim == 1 else p) for p in payloads])
    with tlcx.ranks.bind_axis("x", N):
        got = body(tlcx, [torch.from_numpy(p) for p in payloads], tstats)
    for g, w, p in zip(got, want, payloads):
        assert g.dtype == torch.from_numpy(p).dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(g.numpy(), np.roll(p, 1, axis=0))
    assert tstats == jstats
    assert jstats["pool"]["aggregated_transfers"] >= 1


def test_corrupted_payload_bits_twin():
    """A corrupting transport inverts the payload's bytes in both."""
    xs = np.arange(float(N), dtype=np.float32) + 0.5

    def body(lcx, x):
        lcx.init()
        lcx.install_transport(lcx.FaultyTransport(seed=0, corrupt=1.0))
        cq = lcx.CompletionQueue()
        lcx.put_x(x).perm(lcx.Perm.shift(1)).remote_comp(cq) \
            .device(lcx.Device(axis="x"))()
        lcx.progress()
        ev = cq.pop()
        return ev.payload, ev.status.name

    jout = {}
    jpay = jax.vmap(lambda x: (lambda p, s: jout.setdefault("s", s) and p)(
        *body(jlcx, x)), axis_name="x")(jnp.asarray(xs))
    with tlcx.ranks.bind_axis("x", N):
        tpay, tstatus = body(tlcx, torch.from_numpy(xs))
    assert tstatus == jout["s"]
    np.testing.assert_array_equal(tpay.numpy().view(np.uint32),
                                  np.asarray(jpay).view(np.uint32))
    np.testing.assert_array_equal(
        tpay.numpy().view(np.uint32), ~np.roll(xs, 1).view(np.uint32))
