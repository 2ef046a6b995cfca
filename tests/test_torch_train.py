"""The port's training math against the JAX package's: the MoE aux loss
that ``apply_model`` returns, the chunked attention's custom backward
(``_Flash``) against ``jax.vjp`` of the reference's
``attention_chunked``, and ``loss_fn``'s loss, metrics and gradients
against ``jax.value_and_grad`` on six smoke configs (dense, SSM, MoE,
MLA + MTP, VLM, audio), with the reference's params carried over through
numpy and the same batches from both data pipelines.  Tolerances, stated
per test: the same float32 math, summed in other orders."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.data import make_batch as jmake_batch  # noqa: E402
from repro.models import apply_model as japply  # noqa: E402
from repro.models import init_model as jinit  # noqa: E402
from repro.models import loss_fn as jloss  # noqa: E402
from repro.models.attention import attention_chunked as jchunked  # noqa: E402

from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.data import make_batch  # noqa: E402
from repro_torch.models import apply_model, loss_fn  # noqa: E402
from repro_torch.models.attention import (_Flash, attention_chunked,  # noqa: E402
                                          attention_full)
from repro_torch.models.common import keyed_leaves  # noqa: E402

SEQ, BATCH = 20, 2          # above the smoke configs' q_block of 16


def _ref_leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(k): np.asarray(v) for k, v in flat}


def _port_leaves(tree):
    return {name: (torch.stack(t) if isinstance(t, list) else t)
            .detach().float().numpy()
            for name, t in keyed_leaves(tree)}


@pytest.fixture(scope="module")
def models():
    built = {}

    def get(arch, **over):
        key = (arch, tuple(sorted(over.items())))
        if key not in built:
            jcfg = dataclasses.replace(jbase.get_smoke_config(arch), **over)
            tcfg = dataclasses.replace(tbase.get_smoke_config(arch), **over)
            jp = jax.jit(lambda k: jinit(k, jcfg)[0])(jax.random.PRNGKey(0))
            built[key] = (jcfg, tcfg, jp, jax.tree.map(np.asarray, jp))
        return built[key]
    return get


def _port_params(tcfg, tree):
    return params_from_jax(tcfg, tree, device="cpu")


def test_apply_model_returns_moe_aux_like_reference(models):
    """``apply_model`` returns ``(logits, aux)``, aux the layers' summed
    Switch load-balancing loss, as the reference's does (qwen3-moe smoke,
    two MoE layers; 1e-5)."""
    jcfg, tcfg, jp, tree = models("qwen3-moe-30b-a3b")
    toks = np.random.default_rng(0).integers(0, jcfg.vocab, (BATCH, SEQ))
    toks = toks.astype(np.int32)
    jlog, jaux = jax.jit(lambda p, t: japply(jcfg, p, t))(jp,
                                                          jnp.asarray(toks))
    out = apply_model(tcfg, _port_params(tcfg, tree), torch.as_tensor(toks))
    assert isinstance(out, tuple) and len(out) == 2
    logits, aux = out
    assert aux.dtype == torch.float32 and aux.dim() == 0
    assert float(aux) > 0
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlog),
                               atol=1e-4, rtol=1e-4)


# (batch, seq, q heads, kv heads, dk, dv, causal, window, block)
FLASH_CASES = {
    "causal": (2, 32, 4, 2, 16, 16, True, None, 8),
    "not_causal": (2, 32, 4, 2, 16, 16, False, None, 8),
    "window": (1, 32, 6, 2, 16, 16, True, 5, 8),
    "gqa_7_to_1": (1, 24, 7, 1, 16, 16, True, None, 8),
    "dk_ne_dv": (1, 32, 4, 4, 24, 16, True, None, 8),
    "padded_tail": (1, 37, 4, 2, 16, 16, True, None, 8),
    "padded_tail_window_not_causal": (2, 40, 4, 4, 16, 8, False, 7, 16),
}


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_backward_matches_reference_vjp(case):
    """out, dq, dk and dv of the port's chunked attention (``_Flash``)
    against ``jax.vjp`` of the reference's ``attention_chunked`` on the
    same numpy inputs and cotangent.  S = 37 and 40 are not multiples of
    the block: the port pads to whole blocks and masks the tail, the
    reference takes gcd(S, block) blocks.  f32; 1e-5 absolute on
    unit-normal inputs."""
    b, s, hq, hkv, dk, dv, causal, window, blk = FLASH_CASES[case]
    rng = np.random.default_rng(s + hq)
    q, k, v, do = (rng.standard_normal(shape).astype(np.float32) for shape
                   in ((b, s, hq, dk), (b, s, hkv, dk), (b, s, hkv, dv),
                       (b, s, hq, dv)))
    kw = dict(scale=1 / np.sqrt(dk), causal=causal, window=window,
              q_block=blk, k_block=blk)

    @jax.jit
    def ref(q, k, v, do):
        out, vjp = jax.vjp(lambda q, k, v: jchunked(q, k, v, **kw), q, k, v)
        return (out,) + vjp(do)

    want = ref(q, k, v, do)
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    got = attention_chunked(tq, tk, tv, **kw)
    got.backward(torch.tensor(do))
    for name, g, w in zip(("out", "dq", "dk", "dv"),
                          (got, tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   atol=1e-5, rtol=0, err_msg=name)


def test_flash_backward_equals_autograd_of_full_attention():
    """The custom backward against plain autograd through
    ``attention_full`` (the check ``chip_smoke.py`` makes on the card at
    qwen2's head shape), here at 7/1 heads, S = 40 (a padded tail);
    f32, 1e-5."""
    rng = np.random.default_rng(3)
    q, k, v, do = (torch.tensor(rng.standard_normal(shape),
                                dtype=torch.float32) for shape in
                   ((2, 40, 7, 16), (2, 40, 1, 16), (2, 40, 1, 16),
                    (2, 40, 7, 16)))
    pos = torch.arange(40)
    grads = []
    for fn in (lambda q, k, v: attention_chunked(
                   q, k, v, scale=0.25, causal=True, window=None,
                   q_block=16, k_block=16),
               lambda q, k, v: attention_full(
                   q, k, v, scale=0.25, causal=True, window=None,
                   q_pos=pos, k_pos=pos)):
        xs = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = fn(*xs)
        out.backward(do)
        grads.append([out.detach()] + [x.grad for x in xs])
    for g, w in zip(*grads):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=0)


def test_flash_gradcheck_f64():
    """``torch.autograd.gradcheck`` of ``_Flash`` in f64 (the blocks are
    summed in f64 for f64 inputs): GQA 2 to 1, dk 6 != dv 4, causal, 16
    keys of which the last 3 are a masked padded tail."""
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(shape, dtype=torch.float64, generator=gen,
                           requires_grad=True)
               for shape in ((1, 1, 2, 16, 6), (1, 1, 16, 6),
                             (1, 1, 16, 4)))
    assert torch.autograd.gradcheck(
        lambda q, k, v: _Flash.apply(q, k, v, 0.4, True, None, 8, 4, 13),
        (q, k, v))


LOSS_ARCHS = ["qwen2-0.5b", "mamba2-130m", "qwen3-moe-30b-a3b",
              "deepseek-v3-671b", "llava-next-mistral-7b", "hubert-xlarge"]


def _batch(cfg):
    return make_batch(cfg, SEQ, BATCH, step=3, seed=1)


def _port_loss_and_grads(tcfg, tp, batch):
    leaves = list(dict(keyed_leaves(tp)).values())
    flat = [t for leaf in leaves
            for t in (leaf if isinstance(leaf, list) else [leaf])]
    for t in flat:
        t.requires_grad_(True)
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    loss, metrics = loss_fn(tcfg, tp, tb)
    grads = torch.autograd.grad(loss, flat, allow_unused=True,
                                materialize_grads=True)
    by_tensor = dict(zip(map(id, flat), grads))
    gtree = {name: (torch.stack([by_tensor[id(t)] for t in leaf])
                    if isinstance(leaf, list) else by_tensor[id(leaf)])
             for name, leaf in keyed_leaves(tp)}
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            {k: v.numpy() for k, v in gtree.items()})


@pytest.mark.parametrize("arch", LOSS_ARCHS)
def test_loss_and_grads_match_reference(models, arch):
    """loss_fn's loss and metrics (xent, aux, mtp) and the gradient of
    every leaf, against ``jax.value_and_grad`` of the reference's
    ``loss_fn`` on one batch of ``data.make_batch`` (equal in both
    packages; llava with its patch embeddings, whose rows are cut from
    the logits; hubert on frames).  f32: metrics within 1e-5 relative,
    gradients within 1e-5 of the largest |g| of the leaf."""
    jcfg, tcfg, jp, tree = models(arch)
    jb = jmake_batch(jcfg, SEQ, BATCH, step=3, seed=1)
    batch = _batch(tcfg)
    for k in jb:
        np.testing.assert_array_equal(batch[k], jb[k])
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jloss(jcfg, p, b), has_aux=True))(
            jp, {k: jnp.asarray(v) for k, v in jb.items()})
    loss, metrics, grads = _port_loss_and_grads(
        tcfg, _port_params(tcfg, tree), batch)
    assert set(metrics) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(metrics[k]), float(jm[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    want = _ref_leaves(jg)
    assert set(grads) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(grads[name], w, rtol=0,
                                   atol=1e-5 * max(np.abs(w).max(), 1e-3),
                                   err_msg=name)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "qwen3-moe-30b-a3b",
                                  "deepseek-v3-671b"])
def test_remat_modes_give_the_same_loss_and_grads(models, arch):
    """``cfg.remat`` "none", "full" (``torch.utils.checkpoint`` over each
    period) and "dots" (matmul outputs kept) recompute the same function:
    the same loss and gradients to 1e-6, the MoE routing included."""
    _, tcfg, _, tree = models(arch)
    batch = _batch(tcfg)
    runs = [_port_loss_and_grads(dataclasses.replace(tcfg, remat=r),
                                 _port_params(tcfg, tree), batch)
            for r in ("none", "full", "dots")]
    for loss, _, grads in runs[1:]:
        np.testing.assert_allclose(float(loss), float(runs[0][0]),
                                   rtol=1e-6)
        for name, g in grads.items():
            np.testing.assert_allclose(g, runs[0][2][name], rtol=1e-6,
                                       atol=1e-9, err_msg=name)
