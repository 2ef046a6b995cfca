"""The port's trainer against the JAX package's: three
``make_train_step`` steps from the reference's params (params, AdamW
state and metrics; the f32 and the int8 + error-feedback accumulators),
the reference's ``tests/test_runtime.py`` Trainer runs on the port
(convergence, exact restart, failure recovery), the model-flops count
and logical dims of every architecture, and the training CLI."""
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.analysis.roofline import active_params as jactive  # noqa: E402
from repro.analysis.roofline import model_flops as jflops  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro.data import make_batch as jmake_batch  # noqa: E402
from repro.models import init_model as jinit  # noqa: E402
from repro.models.model import abstract_init as jabstract  # noqa: E402
from repro.optim import adamw_init as jadamw_init  # noqa: E402
from repro.optim import cosine_schedule as jcosine  # noqa: E402
from repro.runtime import TrainConfig as JTrainConfig  # noqa: E402
from repro.runtime import make_train_step as jmake_train_step  # noqa: E402

from repro_torch.analysis import active_params, model_flops  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import abstract_init  # noqa: E402
from repro_torch.models.common import keyed_leaves, tree_leaves  # noqa: E402
from repro_torch.optim import adamw_init, cosine_schedule  # noqa: E402
from repro_torch.runtime import (FailureInjector, NodeFailure,  # noqa: E402
                                 TrainConfig, Trainer, make_train_step)

ROOT = Path(__file__).resolve().parents[1]
LR, WARMUP, TOTAL = 1e-3, 1, 10


def _ref_leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(k): np.asarray(v) for k, v in flat}


def _port_leaves(tree):
    return {name: (torch.stack(t) if isinstance(t, list) else t)
            .detach().float().numpy()
            for name, t in keyed_leaves(tree)}


def _three_steps(arch, **accum):
    """Three train steps of the reference and of the port from the same
    params on the same batches -> (reference metrics, port metrics,
    reference {params, opt} leaves, the port's)."""
    jcfg = jbase.get_smoke_config(arch)
    tcfg = tbase.get_smoke_config(arch)
    jp = jax.jit(lambda k: jinit(k, jcfg)[0])(jax.random.PRNGKey(0))
    tp = params_from_jax(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    kw = dict(lr=LR, warmup=WARMUP, total_steps=TOTAL, **accum)
    jstep = jax.jit(jmake_train_step(jcfg, JTrainConfig(**kw),
                                     jcosine(LR, WARMUP, TOTAL)))
    tstep = make_train_step(tcfg, TrainConfig(**kw),
                            cosine_schedule(LR, WARMUP, TOTAL))
    jo, to = jadamw_init(jp, jcfg.opt_dtype), adamw_init(tp, tcfg.opt_dtype)
    jms, tms = [], []
    for i in range(3):
        b = jmake_batch(jcfg, 20, 4, step=i, seed=1)
        jp, jo, jm = jstep(jp, jo, {k: jnp.asarray(v) for k, v in b.items()})
        tp, to, tm = tstep(tp, to, {k: torch.as_tensor(v)
                                    for k, v in b.items()})
        jms.append({k: float(v) for k, v in jm.items()})
        tms.append({k: float(v) for k, v in tm.items()})
    return (jms, tms, _ref_leaves({"params": jp, "opt": jo}),
            _port_leaves({"params": tp, "opt": to}))


def _check_steps(jms, tms, want, got):
    """Metrics within 1e-5 relative.  Each param leaf within 1e-5 of its
    largest magnitude plus 1e-6 (0.1% of one step's update at lr 1e-3:
    Adam normalises a gradient that is noise, such as a key bias's, to a
    full-size step, so its sign may follow rounding); each moment leaf
    within 1e-4 of its largest magnitude."""
    assert [set(m) for m in tms] == [set(m) for m in jms]
    for jm, tm in zip(jms, tms):
        for k in jm:
            np.testing.assert_allclose(tm[k], jm[k], rtol=1e-5, atol=1e-7,
                                       err_msg=k)
    assert set(got) == set(want)
    for name, w in want.items():
        scale = np.abs(w).max()
        atol = 1e-5 * scale + 1e-6 if name.startswith("['params']") \
            else 1e-4 * scale
        np.testing.assert_allclose(got[name], w, rtol=0, atol=atol,
                                   err_msg=name)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "mamba2-130m",
                                  "qwen3-moe-30b-a3b", "deepseek-v3-671b",
                                  "llava-next-mistral-7b", "hubert-xlarge"])
def test_three_train_steps_match_reference(arch):
    """params, AdamW state (step, m, v) and metrics (loss, xent, aux,
    mtp, grad_norm, lr) after three steps of batch 4 x 20 tokens."""
    _check_steps(*_three_steps(arch))


@pytest.mark.parametrize("compressed", [False, True],
                         ids=["f32_accum", "int8_accum"])
def test_three_accumulated_steps_match_reference(compressed):
    """grad_accum=2 with the f32 accumulator and with the int8 +
    error-feedback one (qwen2 smoke)."""
    _check_steps(*_three_steps("qwen2-0.5b", grad_accum=2,
                               compressed_accum=compressed))


# -- the reference's tests/test_runtime.py Trainer runs, on the port --------
def tiny_cfg(**kw):
    base = dict(name="t", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                d_ff=128, vocab=211, dtype=torch.float32,
                param_dtype=torch.float32, remat="none")
    base.update(kw)
    return ModelConfig(**base)


def test_loss_decreases():
    tcfg = TrainConfig(lr=1e-3, warmup=5, total_steps=60, seq_len=32,
                       global_batch=8, log_every=5)
    tr = Trainer(tiny_cfg(), tcfg, device="cpu")
    tr.run(40)
    losses = [m["loss"] for m in tr.metrics_log]
    assert losses[-1] < losses[0]
    assert all(m["tokens_per_s"] > 0 and m["model_flops_per_s"] > 0
               for m in tr.metrics_log)


def test_checkpoint_restart_resumes_exactly():
    """A second trainer restored from the first one's checkpoint holds its
    params and optimizer state bit for bit, and its next steps equal the
    first trainer's."""
    with tempfile.TemporaryDirectory() as d:
        tcfg = TrainConfig(lr=1e-3, warmup=2, total_steps=30, seq_len=16,
                           global_batch=4, ckpt_dir=d, ckpt_every=5,
                           log_every=1)
        tr = Trainer(tiny_cfg(), tcfg, device="cpu")
        tr.run(10)
        tr2 = Trainer(tiny_cfg(), tcfg, device="cpu")
        assert tr2.restore()
        assert tr2.step_count == 10
        for a, b in zip(tree_leaves({"p": tr.params, "o": tr.opt}),
                        tree_leaves({"p": tr2.params, "o": tr2.opt})):
            assert torch.equal(a.detach(), b)
        tr.run(3)
        tr2.run(3)
        assert [m["loss"] for m in tr2.metrics_log] == \
            [m["loss"] for m in tr.metrics_log[-3:]]


def test_failure_recovery_resumes_from_checkpoint():
    with tempfile.TemporaryDirectory() as d:
        tcfg = TrainConfig(lr=1e-3, warmup=2, total_steps=40, seq_len=16,
                           global_batch=4, ckpt_dir=d, ckpt_every=5)
        inj = FailureInjector(fail_at=[7, 13])
        tr = Trainer(tiny_cfg(), tcfg, device="cpu", failure_injector=inj)
        out = tr.run(20)
        assert out["failures"] == 2
        assert out["final_step"] == 20
        assert inj.fired == [7, 13]


def test_failure_before_checkpoint_raises():
    tcfg = TrainConfig(lr=1e-3, total_steps=10, seq_len=16,
                       global_batch=4, ckpt_dir=None)
    inj = FailureInjector(fail_at=[2])
    tr = Trainer(tiny_cfg(), tcfg, device="cpu", failure_injector=inj)
    with pytest.raises((RuntimeError, NodeFailure)):
        tr.run(5)


@pytest.mark.parametrize("compressed,atol", [(False, 2e-5), (True, 5e-5)],
                         ids=["f32_accum", "int8_accum"])
def test_grad_accum_close_to_one_step(compressed, atol):
    """grad_accum=2 on batch 8 == one step on the same data (the
    reference's bounds: 2e-5 with the f32 accumulator, 5e-5 with int8 +
    error feedback, which carries the residual in f32)."""
    kw = dict(lr=1e-3, warmup=0, total_steps=5, seq_len=16, global_batch=8)
    tr1 = Trainer(tiny_cfg(), TrainConfig(**kw), device="cpu")
    tr2 = Trainer(tiny_cfg(), TrainConfig(grad_accum=2,
                                          compressed_accum=compressed, **kw),
                  device="cpu")
    tr1._run_until(1)
    tr2._run_until(1)
    for a, b in zip(tree_leaves(tr1.params), tree_leaves(tr2.params)):
        np.testing.assert_allclose(b.detach().numpy(), a.detach().numpy(),
                                   atol=atol)


def test_remesh_waits_for_parallel():
    """``remesh`` moves an unmeshed trainer onto a mesh (the port's
    ``parallel/``): the state is kept bit for bit, the shardings and the
    loader are built, and training goes on."""
    from repro_torch.parallel import Mesh, NamedSharding, active_mesh
    tr = Trainer(tiny_cfg(), TrainConfig(seq_len=8, global_batch=2),
                 device="cpu")
    tr._run_until(1)
    before = [t.detach().clone() for t in tree_leaves(tr.params)]
    mesh = Mesh((2, 1), ("data", "model"))
    tr.remesh(mesh)
    try:
        assert active_mesh() is mesh and tr.loader is not None
        assert isinstance(tr.param_sharding["embed"]["emb"], NamedSharding)
        for a, b in zip(before, tree_leaves(tr.params)):
            assert torch.equal(a, b)
        tr._run_until(2)
        assert tr.step_count == 2
    finally:
        tr.remesh(None)
    assert active_mesh() is None and tr.loader is None


# -- the trainer on a mesh: tests/test_multidevice.py's cases ---------------
def test_train_step_sharded_matches_single_device():
    """``Trainer(mesh=(data=2, model=4))`` and a meshless trainer, two
    steps each: the params bit for bit (the shardings change layout, not
    values; the reference allows 2e-4 for its compiler's resharding),
    and the mesh's param and batch specs are the reference's."""
    from repro.models.model import abstract_init as jabs
    from repro.parallel import sharding as js
    from repro_torch.parallel import Mesh, active_mesh
    tcfg = TrainConfig(lr=1e-3, warmup=0, total_steps=4, seq_len=32,
                       global_batch=8)
    mesh = Mesh((2, 4), ("data", "model"))
    tr_m = Trainer(tiny_cfg(), tcfg, mesh=mesh, device="cpu")
    try:
        assert active_mesh() is mesh and tr_m.loader is not None
        tr_m._run_until(2)
        jcfg = jbase.ModelConfig(**{**dict(
            name="t", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
            d_ff=128, vocab=211, remat="none"), "dtype": jnp.float32,
            "param_dtype": jnp.float32})
        jproto, jdims = jabs(jcfg)
        jm = js.abstract_mesh((2, 4), ("data", "model"))
        flat, _ = jax.tree_util.tree_flatten_with_path(
            js.param_shardings(jdims, jproto, jm),
            is_leaf=lambda t: hasattr(t, "spec"))
        want = {jax.tree_util.keystr(k): tuple(v.spec) for k, v in flat}
        def specs(tree, prefix=""):
            for k, v in tree.items():
                if isinstance(v, dict):
                    yield from specs(v, f"{prefix}[{k!r}]")
                else:
                    yield f"{prefix}[{k!r}]", tuple(v.spec)
        got = dict(specs(tr_m.param_sharding))
        assert got == want
        assert {k: tuple(v.spec) for k, v in tr_m.batch_sharding().items()} \
            == {"tokens": ("data",), "labels": ("data",)}
    finally:
        tr_m.remesh(None)
    tr_1 = Trainer(tiny_cfg(), tcfg, device="cpu")
    tr_1._run_until(2)
    for a, b in zip(tree_leaves(tr_m.params), tree_leaves(tr_1.params)):
        assert torch.equal(a, b)


def test_elastic_remesh_preserves_state():
    """Lose half the data-parallel ranks: ``remesh`` from (data=4,
    model=2) to ``shrink_mesh_shape(..., lost=4)`` = (2, 2) keeps the
    params and optimizer state bit for bit, and training goes on, with
    the losses of a trainer that never remeshed."""
    from repro_torch.parallel import Mesh
    from repro_torch.runtime import shrink_mesh_shape
    tcfg = TrainConfig(lr=1e-3, warmup=0, total_steps=8, seq_len=32,
                       global_batch=8, log_every=1)
    tr = Trainer(tiny_cfg(), tcfg, mesh=Mesh((4, 2), ("data", "model")),
                 device="cpu")
    ref = Trainer(tiny_cfg(), tcfg, device="cpu")
    try:
        tr._run_until(2)
        before = [t.clone() for t in tree_leaves({"p": tr.params,
                                                  "o": tr.opt})]
        shape = shrink_mesh_shape({"data": 4, "model": 2}, lost=4)
        assert shape == {"data": 2, "model": 2}
        tr.remesh(Mesh(tuple(shape.values()), tuple(shape)))
        assert tr.mesh.shape == shape
        for a, b in zip(before, tree_leaves({"p": tr.params, "o": tr.opt})):
            assert torch.equal(a, b)
        tr._run_until(4)
        assert tr.step_count == 4
    finally:
        tr.remesh(None)
    ref._run_until(4)
    assert [m["loss"] for m in tr.metrics_log] == \
        [m["loss"] for m in ref.metrics_log]


# -- model flops and logical dims --------------------------------------------
@pytest.mark.parametrize("arch", tbase.ARCH_IDS)
def test_abstract_init_flops_and_dims_match_reference(arch):
    """``abstract_init`` (meta tensors, nothing allocated) gives the
    reference's shapes, dtypes and logical dims, and ``active_params`` /
    ``model_flops`` count what the reference's count, at full size."""
    jcfg, tcfg = jbase.get_config(arch), tbase.get_config(arch)
    jproto, jdims = jabstract(jcfg)
    proto, dims = abstract_init(tcfg)
    assert dims == jdims
    want = _ref_leaves(jax.tree.map(
        lambda s: np.empty(0, dtype=np.dtype(s.dtype)), jproto))
    shapes = {jax.tree_util.keystr(k): tuple(v.shape) for k, v in
              jax.tree_util.tree_flatten_with_path(jproto)[0]}
    got = dict(keyed_leaves(proto))
    assert set(got) == set(shapes)
    for name, leaf in got.items():
        parts = leaf if isinstance(leaf, list) else [leaf]
        assert all(t.device.type == "meta" for t in parts)
        shape = ((len(parts),) if isinstance(leaf, list) else ()) \
            + tuple(parts[0].shape)
        assert shape == shapes[name], name
        assert str(parts[0].dtype)[6:] == str(want[name].dtype), name
    assert active_params(tcfg, proto) == jactive(jcfg, jproto)
    for kind in ("train", "prefill", "decode"):
        assert model_flops(tcfg, proto, kind, 1024, 8) == \
            jflops(jcfg, jproto, kind, 1024, 8)


def test_train_cli_smoke_on_cpu():
    """``launch.train --smoke --device cpu`` trains a few steps."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                        "--arch", "qwen2-0.5b", "--smoke", "--device", "cpu",
                        "--steps", "3", "--seq-len", "32", "--batch", "2"],
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert '"final_step": 3' in r.stdout and "step     3 loss=" in r.stdout
