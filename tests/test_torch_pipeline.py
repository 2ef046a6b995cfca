"""Twins of tests/test_pipeline.py, of the gpipe case of
tests/test_failover.py and of the pipeline-parallel case of
tests/test_multidevice.py: the reference's GPipe runs under
``jax.vmap(axis_name="pipe")``, the port's on ``[n_stages, ...]`` stage
params with the ``pipe`` axis bound; ``pp_apply_model`` / ``pp_loss``
against the reference's ``apply_model`` and ``jax.grad(loss_fn)``.

Tolerances: the GPipe outputs within 1e-5 (the reference's own), the
LCX and native schedules within 1e-6 of each other, the pipeline's
logits and every gradient within 1e-4 (tests/test_multidevice.py)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as jlcx  # noqa: E402
from repro.configs.base import ModelConfig as JConfig  # noqa: E402
from repro.core.attr import reset_global_attrs as jreset  # noqa: E402
from repro.models import apply_model as japply  # noqa: E402
from repro.models import init_model as jinit  # noqa: E402
from repro.models import loss_fn as jloss  # noqa: E402
from repro.parallel.pipeline import gpipe as jgpipe  # noqa: E402

import repro_torch.core as tlcx  # noqa: E402
from repro_torch.configs.base import ModelConfig as TConfig  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.attr import reset_global_attrs as treset  # noqa: E402
from repro_torch.models.common import keyed_leaves, tree_leaves  # noqa: E402
from repro_torch.parallel import Mesh, use_mesh  # noqa: E402
from repro_torch.parallel import pipeline as tpipe  # noqa: E402
from repro_torch.parallel.pp import pp_apply_model, pp_loss  # noqa: E402

N_STAGES = 4
PP = dict(name="pp", n_layers=8, d_model=64, n_heads=4, n_kv_heads=2,
          d_ff=128, vocab=97, q_block=8, remat="none")


@pytest.fixture(autouse=True)
def fresh_runtimes():
    jreset()
    treset()
    yield
    jreset()
    treset()


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _sequential(micro, ws, bs=None):
    ref = micro
    for i in range(ws.shape[0]):
        ref = np.tanh(ref @ ws[i] + (0 if bs is None else bs[i]))
    return ref


def test_gpipe_matches_sequential():
    ws = _rand(0, N_STAGES, 8, 8, scale=8 ** -0.5)
    bs = _rand(1, N_STAGES, 8, scale=0.1)
    micro = _rand(2, 6, 3, 8)

    def jstage(params, x):
        w, b = params
        return jnp.tanh(x @ w + b)

    def per_rank(w, b):
        jlcx.init()
        return jgpipe(jstage, (w, b), jnp.asarray(micro), axis="pipe")

    ref = np.asarray(jax.vmap(per_rank, axis_name="pipe")(
        jnp.asarray(ws), jnp.asarray(bs)))
    out = tpipe.gpipe(lambda p, x: torch.tanh(x @ p[0] + p[1]),
                      [torch.from_numpy(ws), torch.from_numpy(bs)],
                      torch.from_numpy(micro), axis="pipe")
    assert out.shape == (N_STAGES, 6, 3, 8)
    seq = _sequential(micro, ws, bs)
    for r in range(N_STAGES):            # broadcast to all ranks
        np.testing.assert_allclose(out[r].numpy(), ref[r], atol=1e-5)
        np.testing.assert_allclose(out[r].numpy(), seq, atol=1e-5)


@pytest.mark.parametrize("use_lcx", [True, False])
def test_gpipe_native_backend_matches_lcx(use_lcx):
    ws = _rand(3, N_STAGES, 4, 4, scale=0.3)
    micro = _rand(4, 5, 2, 4)

    def body(w):
        jlcx.init()
        return jgpipe(lambda w_, x: x @ w_, w, jnp.asarray(micro),
                      axis="pipe", use_lcx=use_lcx)

    ref = np.asarray(jax.vmap(body, axis_name="pipe")(jnp.asarray(ws)))
    tw = torch.from_numpy(ws)
    stage = lambda w_, x: x @ w_  # noqa: E731
    out = tpipe.gpipe(stage, tw, torch.from_numpy(micro), use_lcx=use_lcx)
    other = tpipe.gpipe(stage, tw, torch.from_numpy(micro),
                        use_lcx=not use_lcx)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-6)
    np.testing.assert_allclose(out.numpy(), other.numpy(), atol=1e-6)


def test_gpipe_puts_one_transfer_a_tick():
    """The LCX schedule is M + n - 1 tick tasks, each one put of every
    stage's activation to the next stage, on the pipeline's private
    runtime; nothing goes through the global one."""
    made = []
    base = tlcx.Runtime

    class Recording(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    ws = torch.from_numpy(_rand(5, N_STAGES, 4, 4, scale=0.3))
    micro = torch.from_numpy(_rand(6, 7, 2, 4))
    orig = tlcx.Runtime
    tlcx.Runtime = Recording
    try:
        tpipe.gpipe(lambda w, x: x @ w, ws, micro)
    finally:
        tlcx.Runtime = orig
    (rt,) = made
    assert rt.name == "gpipe"
    (dev,) = [d for d in rt.devices() if d.axis == "pipe"]
    assert dev.stats["transfers"] == 7 + N_STAGES - 1


def test_gpipe_schedule_survives_stage_device_kill():
    """tests/test_failover.py's case: the stage device frozen before tick
    0; the heartbeat migrates its transfers to the warm standby, the
    outputs equal the sequential stack, one failover on both packages."""
    ws = _rand(7, N_STAGES, 8, 8, scale=8 ** -0.5)
    micro = _rand(8, 6, 3, 8)

    jrt = jlcx.Runtime(name="gp-fo")
    jdev = jrt.device(axis="pipe")
    jdev.freeze()

    def per_rank(w):
        return jgpipe(lambda w_, x: jnp.tanh(x @ w_), w, jnp.asarray(micro),
                      axis="pipe", runtime=jrt, device=jdev, failover=True)

    ref = np.asarray(jax.vmap(per_rank, axis_name="pipe")(jnp.asarray(ws)))

    trt = tlcx.Runtime(name="gp-fo")
    tdev = trt.device(axis="pipe")
    tdev.freeze()
    out = tpipe.gpipe(lambda w_, x: torch.tanh(x @ w_), torch.from_numpy(ws),
                      torch.from_numpy(micro), axis="pipe", runtime=trt,
                      device=tdev, failover=True)
    seq = _sequential(micro, ws)
    np.testing.assert_allclose(out[0].numpy(), seq, atol=1e-5)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)
    for rt, dev in ((jrt, jdev), (trt, tdev)):
        assert rt.failover_stats["failovers"] == 1
        assert not dev.alive and dev.migrated_to is not None
    assert trt.failover_stats == jrt.failover_stats


def test_stage_slice():
    p = {"w": torch.arange(12.0).reshape(4, 3), "b": [torch.arange(4.0)]}
    s = tpipe.stage_slice(p, 2)
    assert torch.equal(s["w"], torch.tensor([6.0, 7.0, 8.0]))
    assert float(s["b"][0]) == 2.0


# -- pipeline-parallel model --------------------------------------------------
@pytest.fixture(scope="module")
def pp_model():
    jcfg = JConfig(**PP, dtype=jnp.float32, param_dtype=jnp.float32)
    tcfg = TConfig(**PP, dtype=torch.float32, param_dtype=torch.float32)
    jp = jax.jit(lambda k: jinit(k, jcfg)[0])(jax.random.PRNGKey(0))
    toks = np.random.default_rng(1).integers(0, 97, (4, 16)).astype(np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, 1)}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    ref_logits = np.asarray(jax.jit(lambda p, t: japply(jcfg, p, t)[0])(
        jp, jb["tokens"]))
    ref_grads = jax.jit(jax.grad(lambda p: jloss(jcfg, p, jb)[0]))(jp)
    flat, _ = jax.tree_util.tree_flatten_with_path(ref_grads)
    ref_grads = {jax.tree_util.keystr(k): np.asarray(v) for k, v in flat}
    params = params_from_jax(tcfg, jax.tree.map(np.asarray, jp),
                             device="cpu")
    tb = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    return tcfg, params, tb, ref_logits, ref_grads


MESH = Mesh((4, 2), ("pipe", "data"))


def test_pp_apply_model_matches_reference(pp_model):
    tcfg, params, batch, ref_logits, _ = pp_model
    made = []
    orig = tlcx.Runtime

    class Recording(orig):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    tlcx.Runtime = Recording
    try:
        with use_mesh(MESH), torch.no_grad():
            out = pp_apply_model(tcfg, params, batch["tokens"], mesh=MESH,
                                 n_micro=2)
    finally:
        tlcx.Runtime = orig
    np.testing.assert_allclose(out.numpy(), ref_logits, atol=1e-4,
                               rtol=1e-4)
    # the mesh branch: one GPipe schedule, M + n - 1 = 5 puts
    (rt,) = made
    (dev,) = [d for d in rt.devices() if d.axis == "pipe"]
    assert dev.stats["transfers"] == 2 + 4 - 1


def test_pp_loss_grads_match_reference(pp_model):
    """Autograd through the LCX schedule (every put, completion and
    executor step) gives ``jax.grad(loss_fn)``'s gradients, leaf for
    leaf."""
    tcfg, params, batch, _, ref_grads = pp_model
    leaves = list(tree_leaves(params))
    for t in leaves:
        t.requires_grad_(True)
    try:
        with use_mesh(MESH):
            loss = pp_loss(tcfg, params, batch, mesh=MESH, n_micro=2)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
    finally:
        for t in leaves:
            t.requires_grad_(False)
    from repro_torch.models.common import tree_unflatten
    gtree = tree_unflatten(params, list(grads))
    port = {name: (torch.stack(t) if isinstance(t, list) else t).numpy()
            for name, t in keyed_leaves(gtree)}
    assert set(port) == set(ref_grads)
    err = max(float(np.abs(port[k] - ref_grads[k]).max()) for k in port)
    assert err < 1e-4, err


def test_pp_asserts_like_reference(pp_model):
    tcfg, params, batch, _, _ = pp_model
    with pytest.raises(AssertionError):     # 8 periods over 3 stages
        pp_apply_model(tcfg, params, batch["tokens"],
                       mesh=Mesh((3,), ("pipe",)), n_micro=2)
    moe = dataclasses.replace(tcfg, n_experts=4, n_experts_per_tok=2,
                              moe_d_ff=32, moe_backend="lcx", family="moe")
    with pytest.raises(AssertionError):     # the EP MoE cannot nest
        pp_apply_model(moe, params, batch["tokens"], mesh=MESH, n_micro=2)
    prefixed = dataclasses.replace(tcfg, first_k_dense=1, n_experts=4,
                                   n_experts_per_tok=2, moe_d_ff=32,
                                   family="moe")
    with pytest.raises(AssertionError):     # prefix layers
        pp_apply_model(prefixed, params, batch["tokens"], mesh=MESH,
                       n_micro=2)
