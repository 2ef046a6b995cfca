"""Twins of tests/test_collectives.py: the same rank values go through the
JAX package's LCX collectives under ``jax.vmap(axis_name="x")`` and the
port's under ``ranks.bind_axis("x", 4)`` on rank-stacked tensors; the
outputs, ``Device.stats`` and the default pool's stats are compared.

Tolerances: gathers, all-to-all, broadcast and the ring sums are held
bit for bit (the ring adds in the same order on both sides); the native
sums reduce in XLA's order on one side and torch's on the other, so
float32 results may differ in the last bits (rtol 1e-6 over 4 terms)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as jlcx  # noqa: E402
from repro.core.attr import reset_global_attrs as jreset  # noqa: E402

import repro_torch.core as tlcx  # noqa: E402
from repro_torch.core.attr import reset_global_attrs as treset  # noqa: E402

N = 4
NATIVE_RTOL = 1e-6


@pytest.fixture(autouse=True)
def fresh_runtimes():
    jreset()
    treset()
    yield
    jreset()
    treset()


def _values(shape, dtype=np.float32, seed=0):
    rng = np.random.default_rng(seed)
    if np.issubdtype(dtype, np.integer):
        return rng.integers(-50, 50, (N,) + shape).astype(dtype)
    return rng.standard_normal((N,) + shape).astype(dtype)


def _twin(fn, xs, *, dtype=None):
    """``fn(lcx, x, dev)`` on both sides; returns (jax out, port out,
    jax stats, port stats) as numpy / dicts."""
    stats = {}

    def body(lcx, x, side):
        lcx.init()
        dev = lcx.Device(axis="x")
        out = fn(lcx, x, dev)
        stats[side] = {"dev": dict(dev.stats),
                       "pool": dict(lcx.runtime().default_pool.stats)}
        return out

    jx = jnp.asarray(xs)
    tx = torch.from_numpy(xs)
    if dtype is not None:
        jx, tx = jx.astype(dtype[0]), tx.to(dtype[1])
    want = jax.vmap(lambda x: body(jlcx, x, "jax"), axis_name="x")(jx)
    with tlcx.ranks.bind_axis("x", N):
        got = body(tlcx, tx, "torch")
    return (np.asarray(jnp.asarray(want, jnp.float32)),
            got.float().numpy(), stats["jax"], stats["torch"])


def _check(want, got, jstats, tstats, exact=True):
    assert got.shape == want.shape
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=NATIVE_RTOL, atol=1e-6)
    assert tstats == jstats


@pytest.mark.parametrize("backend", ["ring", "native"])
@pytest.mark.parametrize("tiled", [True, False])
@pytest.mark.parametrize("shape", [(8,), (2, 3), ()])
def test_all_gather_twin(backend, tiled, shape):
    xs = _values(shape)
    fn = lambda lcx, x, d: lcx.all_gather_x(x).device(d).backend(backend) \
        .tiled(tiled)()
    if backend == "native" and tiled and shape == ():
        # lax.all_gather(tiled=True) of a scalar has no axis 0 to merge
        with pytest.raises(ValueError):
            _twin(fn, xs)
        with tlcx.ranks.bind_axis("x", N), pytest.raises(ValueError):
            tlcx.init()
            fn(tlcx, torch.from_numpy(xs), tlcx.Device(axis="x"))
        return
    want, got, js, ts = _twin(fn, xs)
    _check(want, got, js, ts)
    flat = xs.reshape(N, -1)
    for r in range(N):
        np.testing.assert_array_equal(got[r].reshape(N, -1), flat)


@pytest.mark.parametrize("backend", ["ring", "native"])
def test_reduce_scatter_twin(backend):
    xs = _values((8,))
    want, got, js, ts = _twin(
        lambda lcx, x, d: lcx.reduce_scatter(x, device=d, backend=backend),
        xs)
    _check(want, got, js, ts, exact=backend == "ring")
    np.testing.assert_allclose(got, xs.sum(0).reshape(N, -1), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("backend", ["ring", "native"])
@pytest.mark.parametrize("shape", [(8,), (3, 5), (7,), ()])
def test_all_reduce_twin(backend, shape):
    xs = _values(shape)
    want, got, js, ts = _twin(
        lambda lcx, x, d: lcx.all_reduce(x, device=d, backend=backend), xs)
    _check(want, got, js, ts, exact=backend == "ring")
    for r in range(N):
        np.testing.assert_allclose(got[r], xs.sum(0), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("backend", ["ring", "native"])
def test_all_reduce_int32_twin(backend):
    xs = _values((6,), np.int32)
    want, got, js, ts = _twin(
        lambda lcx, x, d: lcx.all_reduce(x, device=d, backend=backend), xs)
    _check(want, got, js, ts)
    np.testing.assert_array_equal(got, np.broadcast_to(xs.sum(0), xs.shape))


@pytest.mark.parametrize("backend", ["pairwise", "native"])
@pytest.mark.parametrize("shape", [(8,), (4, 3)])
def test_all_to_all_twin(backend, shape):
    xs = _values(shape)
    want, got, js, ts = _twin(
        lambda lcx, x, d: lcx.all_to_all(x, device=d, backend=backend), xs)
    _check(want, got, js, ts)
    c = shape[0] // N
    expect = np.swapaxes(xs.reshape((N, N, c) + shape[1:]), 0, 1)
    np.testing.assert_array_equal(got, expect.reshape(xs.shape))


@pytest.mark.parametrize("root", [0, 2])
def test_broadcast_twin(root):
    xs = _values((8,))
    want, got, js, ts = _twin(
        lambda lcx, x, d: lcx.broadcast(x, device=d, root=root), xs)
    _check(want, got, js, ts)
    for r in range(N):
        np.testing.assert_array_equal(got[r], xs[root])


def test_ring_equals_native_allreduce_bf16_twin():
    """Each side's ring against its own native sum within the
    reference's bf16 bound, and the two rings bit for bit."""
    xs = _values((16,))
    dt = (jnp.bfloat16, torch.bfloat16)
    ring = _twin(lambda lcx, x, d: lcx.all_reduce(x, device=d,
                                                  backend="ring"), xs,
                 dtype=dt)
    native = _twin(lambda lcx, x, d: lcx.all_reduce(x, device=d,
                                                    backend="native"), xs,
                   dtype=dt)
    _check(*ring)
    for side in (0, 1):
        np.testing.assert_allclose(ring[side], native[side], rtol=2e-2,
                                   atol=1e-2)
    np.testing.assert_allclose(native[1], native[0], rtol=2e-2, atol=1e-2)


@pytest.mark.parametrize("op,want", [
    ("all_gather", N - 1), ("reduce_scatter", N - 1),
    ("all_reduce", 2 * (N - 1)), ("all_to_all", N - 1),
    ("broadcast", 0)])
def test_device_stats_count_transfers_twin(op, want):
    xs = _values((8,))
    _, _, js, ts = _twin(lambda lcx, x, d: getattr(lcx, op)(x, device=d),
                         xs)
    assert ts == js
    assert ts["dev"]["transfers"] == want


def test_tags_of_ring_steps_twin():
    """all_reduce posts its reduce-scatter with ``tag`` and its
    all-gather with ``tag + 1``; pairwise all_to_all uses ``tag + k``."""
    seen = {}

    def body(lcx, x, side):
        lcx.init()
        dev = lcx.Device(axis="x")
        tags = seen.setdefault(side, [])
        rt = lcx.runtime()
        orig = rt.enqueue_matches

        def enqueue(matches):
            tags.extend((s.op_name, s.tag) for s, _ in matches)
            return orig(matches)

        rt.enqueue_matches = enqueue
        lcx.all_reduce_x(x).device(dev).tag(5)()
        lcx.all_to_all_x(x).device(dev).tag(20)()
        return x

    xs = _values((8,))
    jax.vmap(lambda x: body(jlcx, x, "jax"), axis_name="x")(jnp.asarray(xs))
    with tlcx.ranks.bind_axis("x", N):
        body(tlcx, torch.from_numpy(xs), "torch")
    assert seen["torch"] == seen["jax"]
    assert {t for _, t in seen["torch"]} == {5, 6, 21, 22, 23}


@pytest.mark.parametrize("op", ["all_gather", "reduce_scatter",
                                "all_reduce", "all_to_all", "broadcast"])
def test_unbound_device_raises_value_error(op):
    for lcx, x in ((jlcx, jnp.zeros((8,))), (tlcx, torch.zeros((N, 8)))):
        lcx.init()
        with pytest.raises(ValueError, match="bound to a mesh axis"):
            getattr(lcx, op)(x, device=lcx.Device())


@pytest.mark.parametrize("op,backend", [
    ("reduce_scatter", "ring"), ("all_to_all", "pairwise"),
    ("all_to_all", "native")])
def test_dim0_not_divisible_raises_value_error(op, backend):
    xs = _values((6,))
    with pytest.raises(ValueError, match="dim0 6 % 4"):
        _twin(lambda lcx, x, d: getattr(lcx, op)(x, device=d,
                                                 backend=backend), xs)
    with tlcx.ranks.bind_axis("x", N), pytest.raises(ValueError,
                                                     match="dim0 6 % 4"):
        tlcx.init()
        getattr(tlcx, op)(torch.from_numpy(xs), device=tlcx.Device(axis="x"),
                          backend=backend)


def test_port_rejects_wrong_rank_count_and_native_scatter_remainder():
    """Port-only checks: a tensor whose dim 0 is not the axis size, and
    the native reduce-scatter's remainder (an assertion inside XLA on the
    reference side)."""
    tlcx.init()
    with tlcx.ranks.bind_axis("x", N):
        dev = tlcx.Device(axis="x")
        with pytest.raises(ValueError, match="rank-stacked"):
            tlcx.all_gather(torch.zeros((N + 1, 8)), device=dev)
        with pytest.raises(ValueError, match="dim0 6 % 4"):
            tlcx.reduce_scatter(torch.zeros((N, 6)), device=dev,
                                backend="native")


def test_barrier_checks_the_axis():
    tlcx.init()
    tlcx.barrier()                          # loopback default device
    dev = tlcx.Device(axis="x")
    with tlcx.ranks.bind_axis("x", N):
        tlcx.barrier(device=dev)
    with pytest.raises(RuntimeError, match="not bound"):
        tlcx.barrier(device=dev)
