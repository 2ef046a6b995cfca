"""Twins of the JAX package's MoE layer (``repro/models/moe.py``): the same
numpy inputs go through the reference and the port.

Tolerances: routing ids, capacities, dispatch buffers and combine's
bookkeeping are held exactly (integers and copies); every float result is
float32 math summed in another order (XLA's on one side, PyTorch's on
the other), held to atol 1e-5 and rtol 1e-5 (MoE outputs, sums of up to
64 products) or 1e-6 (the router's weights and aux loss)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as jlcx  # noqa: E402
from repro.configs.base import ModelConfig as JConfig  # noqa: E402
from repro.core.attr import reset_global_attrs as jreset  # noqa: E402
from repro.models import moe as jm  # noqa: E402

import repro_torch.core as tlcx  # noqa: E402
from repro_torch.configs.base import ModelConfig as TConfig  # noqa: E402
from repro_torch.core.attr import reset_global_attrs as treset  # noqa: E402
from repro_torch.kernels import model_kernels  # noqa: E402
from repro_torch.models import moe as tm  # noqa: E402

MOE = dict(name="m", family="moe", n_layers=1, d_model=32, n_heads=2,
           n_kv_heads=2, d_ff=64, vocab=53, n_experts=8, n_experts_per_tok=2,
           moe_d_ff=24, capacity_factor=1.0)
TOL = dict(atol=1e-5, rtol=1e-5)
ROUTER_TOL = dict(atol=1e-6, rtol=1e-6)
EP = 4


def _cfgs(**kw):
    j = JConfig(dtype=jnp.float32, param_dtype=jnp.float32, **{**MOE, **kw})
    t = TConfig(dtype=torch.float32, param_dtype=torch.float32,
                **{**MOE, **kw})
    return j, t


def _params(cfg, seed=0, shared=0):
    """Numpy MoE params in the reference's layout (experts scaled as its
    init does)."""
    rng = np.random.default_rng(seed)
    E, d, f = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    n = lambda *s: (rng.standard_normal(s) / np.sqrt(s[-2])).astype(
        np.float32)
    p = {"router": {"w": n(d, E)}, "w_gate": {"w": n(E, d, f)},
         "w_up": {"w": n(E, d, f)}, "w_down": {"w": n(E, f, d)}}
    if shared:
        fs = shared * f
        p.update(shared_gate={"w": n(d, fs)}, shared_up={"w": n(d, fs)},
                 shared_down={"w": n(fs, d)})
    return p


def _both(p):
    j = jax.tree.map(jnp.asarray, p)
    t = jax.tree.map(torch.from_numpy, p)
    return j, t


def _x(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


@pytest.mark.parametrize("router", ["softmax", "sigmoid"])
@pytest.mark.parametrize("norm_topk", [True, False])
def test_route(router, norm_topk):
    jc, tc = _cfgs(router_type=router, router_norm_topk=norm_topk)
    jp, tp = _both(_params(jc))
    x = _x(1, 24, jc.d_model)
    jids, jw, jaux = jm.route(jc, jp["router"], jnp.asarray(x))
    tids, tw, taux = tm.route(tc, tp["router"], torch.from_numpy(x))
    assert tids.dtype == torch.int64
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    _close(tw.numpy(), jw, ROUTER_TOL)
    _close(taux.item(), float(jaux), ROUTER_TOL)


@pytest.mark.parametrize("router", ["softmax", "sigmoid"])
def test_route_breaks_ties_like_reference(router):
    """Tied scores (a zero row: the padding of the token-sliced expert
    parallelism) choose the lower expert ids, as ``lax.top_k`` does;
    ``torch.topk`` chose others, and the aux loss differed."""
    jc, tc = _cfgs(router_type=router)
    jp, tp = _both(_params(jc))
    x = _x(1, 6, jc.d_model)
    x[2:4] = 0.0
    jids, jw, jaux = jm.route(jc, jp["router"], jnp.asarray(x))
    tids, tw, taux = tm.route(tc, tp["router"], torch.from_numpy(x))
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    assert tids[2].tolist() == [0, 1]
    _close(tw.numpy(), jw, ROUTER_TOL)
    _close(taux.item(), float(jaux), ROUTER_TOL)


@pytest.mark.parametrize("n_tokens", [1, 8, 31, 498, 4096])
@pytest.mark.parametrize("shape", [(8, 2, 1.0), (128, 8, 1.25), (16, 2, 8.0)])
def test_capacity(n_tokens, shape):
    E, k, cf = shape
    jc, tc = _cfgs(n_experts=E, n_experts_per_tok=k, capacity_factor=cf)
    assert tm.capacity(tc, n_tokens) == jm.capacity(jc, n_tokens)


@pytest.mark.parametrize("n_slots", [1, 8, 12, 16, 33])
@pytest.mark.parametrize("shape", [(8, 2, 1.0), (128, 8, 1.25), (16, 2, 8.0)])
def test_decode_capacity_holds_every_slot(n_slots, shape):
    """A decode step routes n_slots one-token sequences at once: its
    capacity holds every slot that chose an expert, and is the reference's
    capacity wherever that already does."""
    E, k, cf = shape
    _, tc = _cfgs(n_experts=E, n_experts_per_tok=k, capacity_factor=cf)
    c = tm.decode_capacity(tc, n_slots)
    assert c >= n_slots and c % 8 == 0
    assert c == max(tm.capacity(tc, n_slots), -(-n_slots // 8) * 8)


def test_sort_local_decode_routes_each_token_alone():
    """The reference's engine routes each decode slot alone (T = 1); the
    port's decode routes 16 slots in one call.  With 12 slots holding the
    same token, 12 > capacity(16) = 8 rows go to one expert: the batched
    call with ``decode=True`` keeps them all and equals the reference's
    per-token results, while the prefill capacity drops some."""
    jc, tc = _cfgs()
    jp, tp = _both(_params(jc, seed=11))
    x = _x(12, 16, jc.d_model)
    x[4:] = x[3]
    ids, _, _ = tm.route(tc, tp["router"], torch.from_numpy(x))
    per_expert = torch.bincount(ids.reshape(-1), minlength=jc.n_experts)
    assert int(per_expert.max()) > tm.capacity(tc, 16)
    want = np.concatenate([np.asarray(jm._moe_sort_local(
        jc, jp, jnp.asarray(x[i:i + 1]))[0]) for i in range(16)])
    got, _ = tm._moe_sort_local(tc, tp, torch.from_numpy(x), decode=True)
    _close(got.numpy(), want)
    dropped, _ = tm._moe_sort_local(tc, tp, torch.from_numpy(x))
    assert np.abs(dropped.numpy() - want).max() > 1e-2


def _routed(seed, T, jc, tc):
    jp, tp = _both(_params(jc))
    x = _x(seed, T, jc.d_model)
    jr = jm.route(jc, jp["router"], jnp.asarray(x))
    tr = tm.route(tc, tp["router"], torch.from_numpy(x))
    return x, jr, tr


def test_dispatch_and_combine_drop_tokens():
    """Capacity 8 for 40 tokens x top-2 over 8 experts: ~10 a expert, so
    tokens drop; buffer and bookkeeping exact, combine within TOL."""
    jc, tc = _cfgs()
    T, C, E = 40, 8, jc.n_experts
    x, (jids, jw, _), (tids, tw, _) = _routed(3, T, jc, tc)
    jbuf, jinfo = jm.dispatch(jnp.asarray(x), jids, jw, E, C)
    tbuf, tinfo = tm.dispatch(torch.from_numpy(x), tids, tw, E, C)
    assert int((tinfo["slot"] == E * C).sum()) > 0, "no token dropped"
    np.testing.assert_array_equal(tbuf.numpy(), np.asarray(jbuf))
    for key in ("slot", "tok"):
        np.testing.assert_array_equal(tinfo[key].numpy(),
                                      np.asarray(jinfo[key]))
    _close(tinfo["w"].numpy(), jinfo["w"], ROUTER_TOL)
    yb = _x(4, E, C, jc.d_model)
    _close(tm.combine(torch.from_numpy(yb), tinfo, jc.d_model).numpy(),
           jm.combine(jnp.asarray(yb), jinfo, jc.d_model))


@pytest.mark.parametrize("hook", [False, True])
@pytest.mark.parametrize("span", [(0, 8), (2, 3)])
def test_expert_ffn(hook, span):
    jc, tc = _cfgs()
    jp, tp = _both(_params(jc))
    e0, n = span
    xb = _x(5, n, 6, jc.d_model)
    want = jm._expert_ffn(jp, jnp.asarray(xb), e0, n)
    kern = model_kernels(tc)["moe_gmm"] if hook else None
    got = tm._expert_ffn(tp, torch.from_numpy(xb), e0, n, kernel_fn=kern)
    _close(got.numpy(), want)


def test_dense_vs_sort_oracle():
    """tests/test_models_consistency.py::test_moe_dense_vs_sort_oracle on
    the layer: with capacity factor 16 nothing drops, so the two backends
    agree (atol 5e-6, that test's bound), and each equals the
    reference's."""
    jc, tc = _cfgs(capacity_factor=16.0)
    jp, tp = _both(_params(jc, seed=5))
    x = _x(6, 16, jc.d_model)
    yd, ad = tm._moe_dense(tc, tp, torch.from_numpy(x))
    ys, as_ = tm._moe_sort_local(tc, tp, torch.from_numpy(x))
    np.testing.assert_allclose(yd.numpy(), ys.numpy(), atol=5e-6)
    assert float(ad) == float(as_)
    jd, _ = jm._moe_dense(jc, jp, jnp.asarray(x))
    js, _ = jm._moe_sort_local(jc, jp, jnp.asarray(x))
    _close(yd.numpy(), jd)
    _close(ys.numpy(), js)


@pytest.mark.parametrize("chunks", [0, 2, 4])
@pytest.mark.parametrize("hook", [False, True])
def test_sort_local_stream_chunks(chunks, hook):
    jc, tc = _cfgs()
    jp, tp = _both(_params(jc, seed=7))
    x = _x(8, 40, jc.d_model)
    want, jaux = jm._moe_sort_local(jc, jp, jnp.asarray(x),
                                    stream_chunks=chunks)
    kern = model_kernels(tc)["moe_gmm"] if hook else None
    got, taux = tm._moe_sort_local(tc, tp, torch.from_numpy(x),
                                   stream_chunks=chunks, kernel_fn=kern)
    _close(got.numpy(), want)
    _close(taux.item(), float(jaux), ROUTER_TOL)


@pytest.mark.parametrize("backend", ["sort", "lcx", "dense"])
def test_moe_apply_with_shared_expert(backend):
    jc, tc = _cfgs(n_shared_experts=1, moe_backend=backend)
    jp, tp = _both(_params(jc, seed=9, shared=1))
    x = _x(10, 2, 12, jc.d_model)
    want, jaux = jm.moe_apply(jc, jp, jnp.asarray(x))
    got, taux = tm.moe_apply(tc, tp, torch.from_numpy(x),
                             kernel_fn=model_kernels(tc)["moe_gmm"])
    assert got.shape == x.shape
    _close(got.numpy(), want)
    _close(taux.item(), float(jaux), ROUTER_TOL)


def test_moe_init_layout_and_distributions():
    tc = TConfig(dtype=torch.float32, param_dtype=torch.float32,
                 **{**MOE, "n_shared_experts": 2})
    p = tm.moe_init(torch.Generator().manual_seed(0), tc, torch.device("cpu"))
    E, d, f = tc.n_experts, tc.d_model, tc.moe_d_ff
    shapes = {k: tuple(v["w"].shape) for k, v in p.items()}
    assert shapes == {"router": (d, E), "w_gate": (E, d, f),
                      "w_up": (E, d, f), "w_down": (E, f, d),
                      "shared_gate": (d, 2 * f), "shared_up": (d, 2 * f),
                      "shared_down": (2 * f, d)}
    assert p["router"]["w"].dtype == torch.float32
    assert abs(float(p["w_gate"]["w"].std()) - d ** -0.5) < 0.02
    assert abs(float(p["w_down"]["w"].std()) - f ** -0.5) < 0.02


@pytest.fixture
def fresh_runtimes():
    jreset()
    treset()
    yield
    jreset()
    treset()


def _recording(monkeypatch, module):
    """Record every Runtime that ``module.Runtime`` makes."""
    made = []
    base = module.Runtime

    class Recording(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr(module, "Runtime", Recording)
    return made


@pytest.mark.parametrize("backend", ["native", "pairwise"])
def test_ep_shard_twin(backend, monkeypatch, fresh_runtimes):
    """The reference's ``_moe_ep_shard`` under ``jax.vmap(axis_name="ep")``
    over 4 ranks (expert stacks passed as [ep, E_loc, ...]) against the
    port's on rank-stacked tokens, at capacity factor 1.0 so tokens drop:
    outputs and aux within TOL, and the private runtime's devices made
    the same transfers.  Each side also equals its own per-rank sort
    path (the port's through the kernel hook's plain version)."""
    jc, tc = _cfgs()
    E = jc.n_experts
    p = _params(jc, seed=11)
    x = _x(12, EP, 32, jc.d_model)
    jmade = _recording(monkeypatch, jlcx)
    tmade = _recording(monkeypatch, tlcx)

    jp = {"router": {"w": jnp.asarray(p["router"]["w"])}}
    spec = {"router": {"w": None}}
    for k in ("w_gate", "w_up", "w_down"):
        w = p[k]["w"]
        jp[k] = {"w": jnp.asarray(w.reshape((EP, E // EP) + w.shape[1:]))}
        spec[k] = {"w": 0}
    jy, jaux = jax.vmap(
        lambda pp, xx: jm._moe_ep_shard(jc, pp, xx, "ep", backend),
        in_axes=(spec, 0), axis_name="ep")(jp, jnp.asarray(x))

    tp = jax.tree.map(torch.from_numpy, p)
    kern = model_kernels(tc)["moe_gmm"]
    with tlcx.ranks.bind_axis("ep", EP):
        ty, taux = tm._moe_ep_shard(tc, tp, torch.from_numpy(x), "ep",
                                    backend, kernel_fn=kern)
    assert ty.shape == x.shape and taux.shape == (EP,)
    _close(ty.numpy(), jy)
    _close(taux.numpy(), jaux, ROUTER_TOL)

    ids = tm.route(tc, tp["router"], torch.from_numpy(x[0]))[0]
    assert int(torch.bincount(ids.reshape(-1), minlength=E).max()) > \
        tm.capacity(tc, x.shape[1]), "no token dropped"
    jps = jax.tree.map(jnp.asarray, p)
    for r in range(EP):
        jl, _ = jm._moe_sort_local(jc, jps, jnp.asarray(x[r]))
        np.testing.assert_array_equal(np.asarray(jy[r]), np.asarray(jl))
        tl, _ = tm._moe_sort_local(tc, tp, torch.from_numpy(x[r]),
                                   kernel_fn=kern)
        _close(ty[r].numpy(), tl.numpy())

    assert len(jmade) == len(tmade) == 1
    jstats = [dict(d.stats) for d in jmade[0].devices()]
    tstats = [dict(d.stats) for d in tmade[0].devices()]
    assert tstats == jstats
    want = 2 * (EP - 1) if backend == "pairwise" else 0
    assert sum(s["transfers"] for s in tstats) == want
