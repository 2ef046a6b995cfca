"""The port's entry points called as the reference's own tests and
benchmarks call the reference: the kernel entry points with ``block_q=``,
``block_k=``, ``chunk=`` and ``backend=`` (``tests/test_kernels.py``,
``benchmarks/kernels_bench.py``), ``model_kernels(cfg, backend=)``,
``TrainConfig(donate=False)`` (``tests/test_runtime.py``),
``restore_checkpoint(..., shardings)`` by keyword and by position, and
``DataLoader(dataset, shardings, start_step, prefetch)``.  Each result is
held against the reference's on the same numpy inputs, with the
tolerances of ``tests/test_torch_kernels.py`` (f32 2e-5, bf16 2e-2)."""
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import SingleDeviceSharding  # noqa: E402

from repro.checkpoint import restore_checkpoint as jrestore  # noqa: E402
from repro.checkpoint import save_checkpoint as jsave  # noqa: E402
from repro.configs.base import ModelConfig as JConfig  # noqa: E402
from repro.data import DataLoader as JLoader  # noqa: E402
from repro.data import SyntheticLMDataset as JDataset  # noqa: E402
from repro.data import make_batch as jmake_batch  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import init_model as jinit  # noqa: E402
from repro.optim import adamw_init as jadamw_init  # noqa: E402
from repro.optim import cosine_schedule as jcosine  # noqa: E402
from repro.runtime import TrainConfig as JTrainConfig  # noqa: E402
from repro.runtime import make_train_step as jmake_train_step  # noqa: E402

from repro_torch.checkpoint import restore_checkpoint  # noqa: E402
from repro_torch.configs.base import ModelConfig as TConfig  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import ranks  # noqa: E402
from repro_torch.data import DataLoader, SyntheticLMDataset  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import moe_gmm as tgmm  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ring_allgather as tring  # noqa: E402
from repro_torch.kernels import ssd_scan as tssd  # noqa: E402
from repro_torch.models.common import keyed_leaves, tree_leaves  # noqa: E402
from repro_torch.optim import adamw_init, cosine_schedule  # noqa: E402
from repro_torch.parallel import Mesh, NamedSharding  # noqa: E402
from repro_torch.parallel import PartitionSpec as P  # noqa: E402
from repro_torch.runtime import (TrainConfig, Trainer,  # noqa: E402
                                 make_train_step)

BACKENDS = [None, "pallas", "xla"]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _rng_arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _pair(a, dtype):
    return (jnp.asarray(a).astype(getattr(jnp, dtype)),
            torch.from_numpy(a).to(getattr(torch, dtype)))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_takes_block_and_backend_keywords(backend, dtype):
    """``ops.flash_attention(..., block_q=, block_k=, backend=)`` as
    ``tests/test_kernels.py:102`` calls it (block 32 on S = 64)."""
    q, k, v = _rng_arrays(0, (1, 4, 64, 16), (1, 2, 64, 16), (1, 2, 64, 16))
    kw = dict(causal=True, block_q=32, block_k=32, backend=backend)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, k, v))
    want = jops.flash_attention(jq, jk, jv, **kw)
    got = tops.flash_attention(tq, tk, tv, **kw)
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL[dtype])


@pytest.mark.parametrize("backend", BACKENDS)
def test_ssd_scan_takes_chunk_and_backend_keywords(backend):
    """``ops.ssd_scan(..., chunk=, backend=)`` as
    ``benchmarks/kernels_bench.py:53-58`` calls it."""
    b, s, h, p, n = 2, 64, 3, 16, 8
    x, dtr, a, bm, cm = _rng_arrays(1, (b, s, h, p), (b, s, h), (h,),
                                    (b, s, h, n), (b, s, h, n))
    dt = np.log1p(np.exp(dtr)).astype(np.float32)
    A = -np.exp(a).astype(np.float32)
    args = [(jnp.asarray(t), torch.from_numpy(t)) for t in (x, dt, A, bm, cm)]
    want = jops.ssd_scan(*[j for j, _ in args], chunk=16, backend=backend)
    got = tops.ssd_scan(*[t for _, t in args], chunk=16, backend=backend)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), atol=1e-4)


@pytest.mark.parametrize("backend", BACKENDS)
def test_moe_gmm_takes_backend_keyword(backend):
    """``ops.moe_gmm(xb, w, backend=)`` as
    ``benchmarks/kernels_bench.py:67`` calls it."""
    xb, w = _rng_arrays(2, (4, 24, 32), (4, 32, 40))
    want = jops.moe_gmm(jnp.asarray(xb), jnp.asarray(w), backend=backend)
    got = tops.moe_gmm(torch.from_numpy(xb), torch.from_numpy(w),
                       backend=backend)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-4)


def test_ring_all_gather_takes_backend_keyword():
    """``ops.ring_all_gather(x, axis, axis_size=, backend="xla")``: the
    reference under ``vmap`` over the axis, the port rank-stacked."""
    n = 4
    (x,) = _rng_arrays(3, (n, 1, 6))
    want = jax.vmap(lambda xr: jops.ring_all_gather(
        xr, "r", axis_size=n, backend="xla"), axis_name="r")(jnp.asarray(x))
    with ranks.bind_axis("r", n):
        got = tops.ring_all_gather(torch.from_numpy(x), "r", axis_size=n,
                                   backend="xla")
    np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_model_kernels_take_backend(backend):
    """``model_kernels(cfg, backend=)``'s flash and SSD hooks against the
    reference's hooks (``tests/test_kernels.py::
    test_model_kernels_hooks_match_model_layout``)."""
    kw = dict(n_layers=1, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
              vocab=64, q_block=16)
    jks = jops.model_kernels(JConfig(dtype=jnp.float32,
                                     param_dtype=jnp.float32, **kw),
                             backend=backend)
    tks = tops.model_kernels(TConfig(dtype=torch.float32,
                                     param_dtype=torch.float32, **kw),
                             backend=backend)
    q, k, v = _rng_arrays(4, (2, 64, 4, 16), (2, 64, 2, 16), (2, 64, 2, 16))
    want = jks["flash_attention"](jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=True, scale=0.25)
    got = tks["flash_attention"](torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), causal=True,
                                 scale=0.25)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-5)
    x, dtr, a, bm, cm = _rng_arrays(5, (1, 32, 2, 8), (1, 32, 2), (2,),
                                    (1, 32, 2, 4), (1, 32, 2, 4))
    dt, A = np.log1p(np.exp(dtr)).astype(np.float32), -np.exp(a)
    args = [(jnp.asarray(t), torch.from_numpy(np.asarray(t, np.float32)))
            for t in (x, dt, A, bm, cm)]
    want = jks["ssd_scan"](*[j for j, _ in args], chunk=8)
    got = tks["ssd_scan"](*[t for _, t in args], chunk=8)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), atol=1e-4)


def _meta(*shapes):
    return [torch.empty(s, device="meta") for s in shapes]


def test_backend_xla_takes_the_plain_version_on_cpu_only():
    """On CPU tensors ``backend="xla"`` is the plain version, bit for bit.
    Off the CPU a wrapper launches its kernel or raises: ``"xla"`` raises
    and names the plain function to call, and every other value sends
    the tensor to the kernel (which has none for ``meta``)."""
    q, k = _meta((1, 4, 8, 16), (1, 2, 8, 16))
    x, dt, A, bm = _meta((1, 8, 2, 4), (1, 8, 2), (2,), (1, 8, 2, 4))
    xb, w = _meta((2, 8, 16), (2, 16, 8))
    (r,) = _meta((4, 1, 8))
    calls = {
        "flash-attention": (tfa.flash_attention, (q, k, k),
                            "flash_attention_plain"),
        "SSD-scan": (tssd.ssd_scan, (x, dt, A, bm, bm), "ssd_scan_plain"),
        "grouped-matmul": (tgmm.moe_gmm, (xb, w), "moe_gmm_plain"),
        "ring all-gather": (tring.ring_all_gather, (r,),
                            "ring_all_gather_plain"),
    }
    for name, (fn, args, plain) in calls.items():
        with pytest.raises(ValueError, match=f"call {plain} "):
            fn(*args, backend="xla")
        for backend in (None, "pallas", "triton"):
            with pytest.raises(ValueError, match=f"no {name} kernel"):
                fn(*args, backend=backend)
    qc, kc = [torch.from_numpy(a) for a in _rng_arrays(
        6, (1, 4, 8, 16), (1, 2, 8, 16))]
    assert torch.equal(tfa.flash_attention(qc, kc, kc, backend="xla"),
                       tfa.flash_attention_plain(qc, kc, kc))
    xbc, wc = [torch.from_numpy(a) for a in _rng_arrays(
        7, (2, 8, 16), (2, 16, 8))]
    assert torch.equal(tgmm.moe_gmm(xbc, wc, backend="xla"),
                       tgmm.moe_gmm_plain(xbc, wc))
    xc, dtc, Ac, bmc = [torch.from_numpy(a) for a in _rng_arrays(
        8, (1, 40, 2, 4), (1, 40, 2), (2,), (1, 40, 2, 4))]
    dtc, Ac = torch.nn.functional.softplus(dtc), -torch.exp(Ac)
    for chunk in (16, 256):      # the CPU path takes the chunk it is given
        got = tssd.ssd_scan(xc, dtc, Ac, bmc, bmc, chunk=chunk,
                            backend="xla")
        want = tssd.ssd_scan_plain(xc, dtc, Ac, bmc, bmc, chunk=chunk)
        assert all(torch.equal(g, w) for g, w in zip(got, want))


TINY = dict(name="t", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
            d_ff=64, vocab=97, remat="none")


def test_train_config_donate_false_steps_match_reference():
    """``TrainConfig(donate=False)``, as ``tests/test_runtime.py:76-93``
    passes it: two steps of the port's step against the reference's
    jitted step without donation, from the reference's params (f32,
    within 1e-5), and the port's Trainer with ``donate=False`` gives the
    ``donate=True`` run's losses bit for bit; with ``False`` the params
    and moments a step was given stay as they were, with ``True`` they
    are updated in place."""
    jcfg = JConfig(dtype=jnp.float32, param_dtype=jnp.float32, **TINY)
    tcfg = TConfig(dtype=torch.float32, param_dtype=torch.float32, **TINY)
    kw = dict(lr=1e-3, warmup=1, total_steps=10, donate=False)
    jp = jax.jit(lambda key: jinit(key, jcfg)[0])(jax.random.PRNGKey(0))
    tp = params_from_jax(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    jstep = jax.jit(jmake_train_step(jcfg, JTrainConfig(**kw),
                                     jcosine(1e-3, 1, 10)))
    tstep = make_train_step(tcfg, TrainConfig(**kw), cosine_schedule(
        1e-3, 1, 10))
    jo, to = jadamw_init(jp, jcfg.opt_dtype), adamw_init(tp, tcfg.opt_dtype)
    for i in range(2):
        b = jmake_batch(jcfg, 16, 4, step=i, seed=1)
        jp, jo, jm = jstep(jp, jo, {k: jnp.asarray(v) for k, v in b.items()})
        tp, to, tm = tstep(tp, to, {k: torch.as_tensor(v)
                                    for k, v in b.items()})
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]),
                                                  abs=1e-5)
    losses = {}
    for donate in (True, False):
        tr = Trainer(tcfg, TrainConfig(lr=1e-3, warmup=1, total_steps=10,
                                       seq_len=16, global_batch=4,
                                       log_every=1, donate=donate),
                     device="cpu")
        given = tr.params, tr.opt
        before = [t.clone() for t in tree_leaves((given[0], given[1].m))]
        tr.run(3)
        losses[donate] = [m["loss"] for m in tr.metrics_log]
        after = tree_leaves((given[0], given[1].m))
        same = [torch.equal(a, b) for a, b in zip(before, after)]
        assert all(same) if not donate else not any(same)
    assert losses[True] == losses[False]


def _tree(seed):
    a, b, c = _rng_arrays(seed, (3, 5), (4,), (2, 2, 3))
    return {"w": a, "b": b, "inner": {"k": c}}


@pytest.mark.parametrize("by", ["keyword", "position"])
def test_restore_checkpoint_takes_shardings(by):
    """``restore_checkpoint(ckpt_dir, target, step, shardings)``: the
    reference's checkpoint restored by both packages, shardings passed by
    keyword and as the fourth positional argument; every leaf lands on
    the one card (here ``device="cpu"``) with the reference's values."""
    tree = _tree(8)
    mesh = Mesh((2, 4), ("data", "model"))
    tsh = {"w": NamedSharding(mesh, P("data")), "b": NamedSharding(mesh, P()),
           "inner": {"k": NamedSharding(mesh, P(None, "model"))}}
    jsh = jax.tree.map(lambda _: SingleDeviceSharding(jax.devices()[0]),
                       tree)
    with tempfile.TemporaryDirectory() as d:
        jsave(d, 3, jax.tree.map(jnp.asarray, tree))
        jtarget = jax.tree.map(jnp.asarray, tree)
        ttarget = jax.tree.map(lambda a: torch.zeros(a.shape), tree)
        if by == "keyword":
            want, jstep_, _ = jrestore(d, jtarget, shardings=jsh)
            got, step, _ = restore_checkpoint(d, ttarget, shardings=tsh,
                                              device="cpu")
        else:
            want, jstep_, _ = jrestore(d, jtarget, None, jsh)
            got, step, _ = restore_checkpoint(d, ttarget, None, tsh,
                                              device="cpu")
        assert step == jstep_ == 3
        for (name, t), (kp, w) in zip(
                keyed_leaves(got),
                jax.tree_util.tree_flatten_with_path(want)[0]):
            assert name == jax.tree_util.keystr(kp)
            assert t.device.type == "cpu"
            np.testing.assert_array_equal(t.numpy(), np.asarray(w))
        # a device in the shardings' place is refused, never read
        with pytest.raises(TypeError, match="NamedSharding"):
            restore_checkpoint(d, ttarget, None, "cpu")


@pytest.mark.parametrize("by", ["keyword", "position"])
def test_data_loader_takes_shardings_in_the_reference_order(by):
    """``DataLoader(dataset, shardings, start_step, prefetch)`` in the
    reference's order yields the reference loader's batches."""
    jds = JDataset(vocab=50, seq_len=8, global_batch=2, seed=1)
    tds = SyntheticLMDataset(vocab=50, seq_len=8, global_batch=2, seed=1)
    jsh = {k: SingleDeviceSharding(jax.devices()[0])
           for k in ("tokens", "labels")}
    mesh = Mesh((2,), ("data",))
    tsh = {k: NamedSharding(mesh, P("data")) for k in ("tokens", "labels")}
    jl = JLoader(jds, jsh, 4, 2)
    tl = (DataLoader(tds, tsh, 4, 2, device="cpu") if by == "position"
          else DataLoader(tds, shardings=tsh, start_step=4, prefetch=2,
                          device="cpu"))
    try:
        assert tl.shardings is tsh
        for _ in range(3):
            (js, jb), (ts, tb) = next(jl), next(tl)
            assert js == ts
            for k in jb:
                np.testing.assert_array_equal(tb[k].numpy(),
                                              np.asarray(jb[k]))
    finally:
        jl.close()
        tl.close()
    with pytest.raises(TypeError, match="shardings"):
        DataLoader(tds, "cpu")
