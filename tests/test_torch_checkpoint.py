"""Checkpoints: the port writes the reference's format and the two
packages read each other's.  A checkpoint of the reference's ``Trainer``
(f32 and bf16) restores into the port's bit for bit; the port's restores
through the reference's ``restore_checkpoint`` leaf for leaf, AdamW
state included; bf16 leaves are byte-identical to the reference's own.
Also the store's atomic commit, garbage collection and its errors."""
import json
import os
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import restore_checkpoint as jrestore  # noqa: E402
from repro.checkpoint import save_checkpoint as jsave  # noqa: E402
from repro.configs.base import ModelConfig as JConfig  # noqa: E402
from repro.runtime import TrainConfig as JTrainConfig  # noqa: E402
from repro.runtime import Trainer as JTrainer  # noqa: E402

from repro_torch.checkpoint import (AsyncCheckpointer, latest_step,  # noqa: E402
                                    list_steps, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models.common import keyed_leaves, tree_leaves  # noqa: E402
from repro_torch.runtime import TrainConfig, Trainer  # noqa: E402

TINY = dict(name="t", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
            d_ff=64, vocab=97, remat="none")
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _cfgs(dtype):
    jdt, tdt = DTYPES[dtype]
    return (JConfig(dtype=jdt, param_dtype=jdt, **TINY),
            ModelConfig(dtype=tdt, param_dtype=tdt, **TINY))


def _tcfg(d, cls):
    return cls(lr=1e-3, warmup=1, total_steps=10, seq_len=8, global_batch=2,
               ckpt_dir=d, ckpt_every=100)


def _bits(t):
    t = t.detach()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def _ref_bits(a):
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype == jnp.bfloat16 else a


@pytest.mark.parametrize("dtype", DTYPES)
def test_reference_trainer_checkpoint_restores_into_port(dtype):
    """The reference's Trainer trains 2 steps and saves; the port's
    Trainer restores that checkpoint: params equal ``params_from_jax`` of
    the reference's bit for bit, the AdamW moments and step too."""
    jcfg, tcfg = _cfgs(dtype)
    with tempfile.TemporaryDirectory() as d:
        jtr = JTrainer(jcfg, _tcfg(d, JTrainConfig))
        jtr.run(2)
        tr = Trainer(tcfg, _tcfg(d, TrainConfig), device="cpu")
        assert tr.restore() and tr.step_count == 2
    want = params_from_jax(tcfg, jax.tree.map(np.asarray, jtr.params),
                           device="cpu")
    for a, b in zip(tree_leaves(tr.params), tree_leaves(want)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert int(tr.opt.step) == 2
    got = {n: v for n, v in keyed_leaves(tr.opt)}
    flat = jax.tree_util.tree_flatten_with_path(jtr.opt)[0]
    assert len(flat) == len(got)
    for kp, leaf in flat:
        t = got[jax.tree_util.keystr(kp)]
        t = torch.stack(t) if isinstance(t, list) else t
        np.testing.assert_array_equal(_bits(t), _ref_bits(leaf))


def _port_state_as_reference(jtr, tr):
    """The port trainer's {params, opt} as a reference tree (the
    reference trainer's structure, the port's values)."""
    got = {n: (torch.stack(v) if isinstance(v, list) else v)
           for n, v in keyed_leaves({"params": tr.params, "opt": tr.opt})}
    flat, treedef = jax.tree_util.tree_flatten_with_path(
        {"params": jtr.params, "opt": jtr.opt})
    leaves = []
    for kp, ref in flat:
        bits = _bits(got[jax.tree_util.keystr(kp)])
        leaves.append(jnp.asarray(bits.view(jnp.bfloat16)
                                  if ref.dtype == jnp.bfloat16 else bits))
    return jax.tree_util.tree_unflatten(treedef, leaves)


def test_port_checkpoint_restores_through_reference():
    """The port's Trainer trains 2 steps (f32) and saves; the reference's
    ``restore_checkpoint`` reads it into the reference's tree, equal leaf
    for leaf to the port's state (AdamW step and moments included)."""
    jcfg, tcfg = _cfgs("float32")
    with tempfile.TemporaryDirectory() as d:
        tr = Trainer(tcfg, _tcfg(d, TrainConfig), device="cpu")
        tr.run(2)
        jtr = JTrainer(jcfg, _tcfg(None, JTrainConfig))
        target = {"params": jtr.params, "opt": jtr.opt}
        state, step, extra = jrestore(d, target)
    assert step == 2 and extra == {"step_count": 2}
    want = _port_state_as_reference(jtr, tr)
    for (kp, a), b in zip(jax.tree_util.tree_flatten_with_path(state)[0],
                          jax.tree.leaves(want)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=jax.tree_util.keystr(kp))


def test_port_bf16_checkpoint_is_byte_identical_to_reference():
    """A bf16 trainer's checkpoint from the port and the reference's
    ``save_checkpoint`` of the same values: the same manifest and the
    same bytes in every file (bf16 leaves under the ``<V2`` descr,
    manifest dtype "bfloat16").  The reference cannot restore a bf16
    leaf itself: ``np.load`` gives void items that numpy cannot cast to
    ``ml_dtypes.bfloat16``; viewed as bf16 they equal the port's."""
    jcfg, tcfg = _cfgs("bfloat16")
    with tempfile.TemporaryDirectory() as d, \
            tempfile.TemporaryDirectory() as dj:
        tr = Trainer(tcfg, _tcfg(d, TrainConfig), device="cpu")
        tr.run(2)
        jtr = JTrainer(jcfg, _tcfg(None, JTrainConfig))
        jstate = _port_state_as_reference(jtr, tr)
        jsave(dj, 2, jstate, extra={"step_count": 2})
        sub = "step_000000002"
        files = sorted(os.listdir(os.path.join(d, sub)))
        assert files == sorted(os.listdir(os.path.join(dj, sub)))
        for f in files:
            with open(os.path.join(d, sub, f), "rb") as a, \
                    open(os.path.join(dj, sub, f), "rb") as b:
                assert a.read() == b.read(), f
        with open(os.path.join(d, sub, "manifest.json")) as f:
            manifest = json.load(f)
        bf16 = [e for e in manifest["leaves"] if e["dtype"] == "bfloat16"]
        assert bf16 and all(e["name"].startswith("['params']") for e in bf16)
        arr = np.load(os.path.join(d, sub, bf16[0]["file"]))
        assert arr.dtype == np.dtype("V2")
        np.testing.assert_array_equal(
            arr.view(jnp.bfloat16).astype(np.float32),
            np.asarray(jax.tree.leaves(jstate["params"])[0], np.float32))
        with pytest.raises(ValueError, match="cast"):
            jrestore(dj, {"params": jtr.params, "opt": jtr.opt})


def test_checkpoint_atomicity_and_gc():
    with tempfile.TemporaryDirectory() as d:
        tree = {"a": torch.arange(4.0), "b": {"c": torch.ones((2, 3))}}
        for step in (1, 2, 3, 4):
            save_checkpoint(d, step, {"a": tree["a"] * step,
                                      "b": {"c": tree["b"]["c"] * step}})
        # a stale .tmp dir must be ignored
        os.makedirs(os.path.join(d, "step_000000099.tmp"))
        assert list_steps(d) == [1, 2, 3, 4]
        assert latest_step(d) == 4
        restored, step, _ = restore_checkpoint(d, tree)
        assert step == 4
        np.testing.assert_allclose(restored["a"].numpy(),
                                   np.arange(4.0) * 4)
        ck = AsyncCheckpointer(d, keep=2)
        ck.save(5, tree)
        ck.wait()
        assert list_steps(d) == [4, 5]


def test_stacked_leaves_round_trip():
    """A list of per-period nests is written as the reference's stacked
    leaves and read back into the list; a 0-d int32 leaf keeps its
    shape."""
    tree = {"stack": [{"w": torch.full((2, 3), float(i))} for i in range(3)],
            "n": torch.tensor(7, dtype=torch.int32)}
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, 1, tree)
        with open(os.path.join(d, "step_000000001", "manifest.json")) as f:
            entries = {e["name"]: e for e in json.load(f)["leaves"]}
        assert entries["['stack']['w']"]["shape"] == [3, 2, 3]
        assert entries["['n']"] == {"name": "['n']", "file": "leaf_00000.npy",
                                    "shape": [], "dtype": "int32"}
        out, _, _ = restore_checkpoint(d, tree)
    assert out["n"].shape == () and int(out["n"]) == 7
    for i, p in enumerate(out["stack"]):
        assert torch.equal(p["w"], torch.full((2, 3), float(i)))


def test_checkpoint_shape_mismatch_rejected():
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, 1, {"a": torch.zeros((4,))})
        with pytest.raises(ValueError):
            restore_checkpoint(d, {"a": torch.zeros((5,))})


def test_checkpoint_missing_leaf_rejected():
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, 1, {"a": torch.zeros(2)})
        with pytest.raises(KeyError):
            restore_checkpoint(d, {"a": torch.zeros(2),
                                   "b": torch.zeros(2)})
