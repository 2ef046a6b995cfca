"""The training cuts that ``chip_smoke.py`` runs on the card, held here on
the CPU without one.

- The same paths at smoke widths, cut as the card's f32 check cuts them
  (``chip_smoke.TRAIN_SMOKE_CUTS``): DeepSeek-V3 with its 3 dense layers,
  one MoE layer and the MTP loss at 4 of 8 routed experts (top-2 kept),
  llava at 1 of 2 layers with its patch embeddings, hubert on frames.
  ``loss_fn``'s loss, its parts and the gradient of every leaf against
  ``jax.value_and_grad`` of the reference's, with the reference's params
  carried over through numpy; f32 within 1e-5, as
  ``tests/test_torch_train.py``.  The card's check ties its step to the
  port's CPU step on the same shapes.
- Every full-width cut of ``chip_smoke.TRAIN_CUTS``, applied to the
  reference's published config: its ``scan_plan`` accepts it, both
  packages count the same parameters, and its training state (params,
  grads and two moments in ``opt_dtype``) counted on ``meta`` stays under
  ``TRAIN_STATE_CAP``.
- The llava depth rule of ``chip_smoke.depth_from_probes``."""
import dataclasses
import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.data import make_batch as jmake_batch  # noqa: E402
from repro.models import abstract_init as jabstract  # noqa: E402
from repro.models import init_model as jinit  # noqa: E402
from repro.models import loss_fn as jloss  # noqa: E402

from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.data import make_batch  # noqa: E402
from repro_torch.models import loss_fn  # noqa: E402
from repro_torch.models.common import keyed_leaves  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _load_chip_smoke():
    """``chip_smoke.py`` as a module, its tables and pure helpers only:
    importing it runs no phase and needs no card."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_tables", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CHIP = _load_chip_smoke()
CARD_CUTS = [(arch, i) for arch, cuts in CHIP.TRAIN_CUTS.items()
             for i in range(len(cuts))]


def _ref_leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(k): np.asarray(v) for k, v in flat}


def _port_loss_and_grads(tcfg, tp, batch):
    leaves = dict(keyed_leaves(tp))
    flat = [t for leaf in leaves.values()
            for t in (leaf if isinstance(leaf, list) else [leaf])]
    for t in flat:
        t.requires_grad_(True)
    loss, metrics = loss_fn(tcfg, tp, {k: torch.as_tensor(v)
                                       for k, v in batch.items()})
    grads = dict(zip(map(id, flat), torch.autograd.grad(
        loss, flat, allow_unused=True, materialize_grads=True)))
    gtree = {name: (torch.stack([grads[id(t)] for t in leaf])
                    if isinstance(leaf, list) else grads[id(leaf)])
             for name, leaf in leaves.items()}
    return ({k: float(v.detach()) for k, v in metrics.items()},
            {k: v.numpy() for k, v in gtree.items()})


@pytest.mark.parametrize("arch", list(CHIP.TRAIN_SMOKE_CUTS))
def test_cut_loss_and_grads_match_reference(arch):
    """The smoke config cut as ``TRAIN_SMOKE_CUTS`` says, at the card
    check's seq and batch: loss, xent, aux (and mtp for DeepSeek-V3)
    within 1e-5 relative, every gradient within 1e-5 of its leaf's largest
    |g|."""
    over = CHIP.TRAIN_SMOKE_CUTS[arch]
    jcfg = dataclasses.replace(jbase.get_smoke_config(arch), **over)
    tcfg = dataclasses.replace(tbase.get_smoke_config(arch), **over)
    seq, batch_size = CHIP.TRAIN_F32_SEQ, CHIP.TRAIN_F32_BATCH
    jp = jax.jit(lambda k: jinit(k, jcfg)[0])(jax.random.PRNGKey(0))
    jb = jmake_batch(jcfg, seq, batch_size, step=0, seed=0)
    batch = make_batch(tcfg, seq, batch_size, step=0, seed=0)
    for k in jb:
        np.testing.assert_array_equal(batch[k], jb[k])
    (_, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jloss(jcfg, p, b), has_aux=True))(
            jp, {k: jnp.asarray(v) for k, v in jb.items()})
    metrics, grads = _port_loss_and_grads(
        tcfg, params_from_jax(tcfg, jax.tree.map(np.asarray, jp),
                              device="cpu"), batch)
    assert set(metrics) == set(jm)
    if jcfg.n_experts:
        assert metrics["aux"] > 0
    if jcfg.mtp_depth:
        assert math.isfinite(metrics["mtp"]) and metrics["mtp"] > 0
    for k in jm:
        np.testing.assert_allclose(metrics[k], float(jm[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    want = _ref_leaves(jg)
    assert set(grads) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(grads[name], w, rtol=0,
                                   atol=1e-5 * max(np.abs(w).max(), 1e-3),
                                   err_msg=name)


@pytest.mark.parametrize("arch,i", CARD_CUTS,
                         ids=[f"{a}-{i}" for a, i in CARD_CUTS])
def test_card_cut_builds_and_fits(arch, i):
    """A cut of ``TRAIN_CUTS`` on the reference's published config: its
    ``scan_plan`` accepts it (a whole period after the dense prefix), the
    two packages count the same parameters, and params + grads + two
    moments stay under ``TRAIN_STATE_CAP``: the port's count on ``meta``
    (``chip_smoke.train_state_bytes``) equals the one made from the
    reference's ``abstract_init`` leaves."""
    over = CHIP.TRAIN_CUTS[arch][i]
    jcfg = dataclasses.replace(jbase.get_config(arch), **over)
    prefix, period, n_periods = jcfg.scan_plan()
    assert len(prefix) == jcfg.first_k_dense and n_periods >= 1
    if jcfg.n_experts:
        assert any(spec.ffn == "moe" for spec in period)
    leaves = jax.tree.leaves(jabstract(jcfg)[0])
    n = sum(math.prod(x.shape) for x in leaves)
    nbytes = sum(math.prod(x.shape) * x.dtype.itemsize for x in leaves)
    want = 2 * nbytes + 2 * n * jnp.dtype(jcfg.opt_dtype).itemsize
    tcfg = dataclasses.replace(tbase.get_config(arch), **over)
    assert CHIP.train_state_bytes(tcfg) == (n, want)
    assert want < CHIP.TRAIN_STATE_CAP


@pytest.mark.parametrize("package", [jbase, tbase],
                         ids=["reference", "port"])
def test_dense_prefix_alone_is_refused(package):
    """Why DeepSeek-V3's cut keeps one MoE layer: with ``n_layers ==
    first_k_dense`` no period follows the prefix, and both packages'
    ``scan_plan`` refuse the config."""
    cfg = dataclasses.replace(package.get_smoke_config("deepseek-v3-671b"),
                              n_layers=1, first_k_dense=1)
    with pytest.raises(AssertionError):
        cfg.scan_plan()


def test_depth_from_probes():
    """llava's depth: the slope of the peak memory between the probes, the
    largest depth that leaves ``TRAIN_FREE_BYTES`` of ``TRAIN_CARD_BYTES``
    free, and at most the cap.  Peaks are those of one run of
    ``chip_smoke.py``'s probes at 2 and 4 layers on an NVIDIA H100 80GB
    HBM3 at 700.00 W."""
    peaks = {4: 18_477_470_208, 2: 13_241_733_632}
    slope, fit, depth = CHIP.depth_from_probes(peaks, cap=20)
    assert slope == (18_477_470_208 - 13_241_733_632) / 2
    assert fit == 2 + int((CHIP.TRAIN_CARD_BYTES - CHIP.TRAIN_FREE_BYTES
                           - 13_241_733_632) // slope) == 23
    assert depth == 20
    assert CHIP.depth_from_probes(peaks, cap=32)[2] == 23
    assert CHIP.TRAIN_CUTS["llava-next-mistral-7b"][0]["n_layers"] <= \
        tbase.get_config("llava-next-mistral-7b").n_layers
