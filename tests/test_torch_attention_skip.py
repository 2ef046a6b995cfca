"""The causal-skip schedule of the chunked attention
(``impl="chunked_causal_skip"``) against the reference's: the three
attention impls through ``apply_model`` (the twin of
``tests/test_models_consistency.py::test_attn_impl_full_vs_chunked_vs_skip``,
with a ``q_block`` below S so that the chunked paths run), the same
through ``mla_apply``, and the loss and gradients through ``loss_fn``
against ``jax.value_and_grad`` of the reference's.  All f32: forward
within 5e-5 (the reference test's), loss and gradients within 1e-5."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import ModelConfig as JConfig  # noqa: E402
from repro.configs.deepseek_v3_671b import smoke as jmla_smoke  # noqa: E402
from repro.models import apply_model as japply  # noqa: E402
from repro.models import init_model as jinit  # noqa: E402
from repro.models import loss_fn as jloss  # noqa: E402
from repro.models import mla as jmla  # noqa: E402

from repro_torch.configs.base import ModelConfig as TConfig  # noqa: E402
from repro_torch.configs.deepseek_v3_671b import (  # noqa: E402
    smoke as tmla_smoke)
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import (apply_model, attention,  # noqa: E402
                                loss_fn, mla)
from repro_torch.models.common import keyed_leaves  # noqa: E402

IMPLS = ("full", "chunked", "chunked_causal_skip")
FWD_TOL = 5e-5
GRAD_TOL = 1e-5
CFG = dict(name="impl", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
           d_ff=128, vocab=97, q_block=8)


@pytest.fixture(scope="module")
def dense():
    jcfg = JConfig(dtype=jnp.float32, param_dtype=jnp.float32, **CFG)
    tcfg = TConfig(dtype=torch.float32, param_dtype=torch.float32, **CFG)
    jp = jax.jit(lambda k: jinit(k, jcfg)[0])(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jp)
    return jcfg, tcfg, jp, tree


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s),
                                                dtype=np.int32)


# S = 32: four whole 8-row blocks; S = 30: the port pads to 32, the
# reference takes gcd(30, 8) = 2-row blocks
@pytest.mark.parametrize("s", [32, 30])
def test_attn_impl_full_vs_chunked_vs_skip(dense, s):
    jcfg, tcfg, jp, tree = dense
    tp = params_from_jax(tcfg, tree, device="cpu")
    t = _tokens(1, 2, s, CFG["vocab"])
    with torch.no_grad():
        got = {i: apply_model(tcfg, tp, torch.from_numpy(t), impl=i)[0]
               .numpy() for i in IMPLS}
    want = {i: np.asarray(jax.jit(lambda p, x, i=i: japply(
        jcfg, p, x, impl=i)[0])(jp, jnp.asarray(t))) for i in IMPLS}
    for i in IMPLS:
        np.testing.assert_allclose(got[i], want[i], atol=FWD_TOL, err_msg=i)
        np.testing.assert_allclose(got[i], got["full"], atol=FWD_TOL,
                                   err_msg=i)


def test_skip_schedule_is_taken_and_visits_only_the_triangle(dense,
                                                             monkeypatch):
    """``chunked_causal_skip`` runs ``_flash_causal_skip`` (not
    ``_Flash``) with bq == bk, and computes nq (nq + 1) / 2 score blocks
    where ``"chunked"`` computes nq² of them."""
    _, tcfg, _, tree = dense
    tp = params_from_jax(tcfg, tree, device="cpu")
    t = torch.from_numpy(_tokens(2, 1, 32, CFG["vocab"]))
    seen, blocks = [], {"n": 0}
    real_skip, real_einsum = attention._flash_causal_skip, torch.einsum

    def spy(q, k, v, scale, bq, bk):
        seen.append((bq, bk))
        return real_skip(q, k, v, scale, bq, bk)

    def count(eq, *ops):
        out = real_einsum(eq, *ops)
        if eq.endswith("->bhgqk") or eq.endswith("->bhgnqk"):
            # 8 x 8 score blocks of one (batch, head) in this product
            per_head = out.shape[0] * out.shape[1] * out.shape[2]
            blocks["n"] += out.numel() // (64 * per_head)
        return out

    monkeypatch.setattr(attention, "_flash_causal_skip", spy)
    monkeypatch.setattr(torch, "einsum", count)
    with torch.no_grad():
        apply_model(tcfg, tp, t, impl="chunked_causal_skip")
        skip_blocks, blocks["n"] = blocks["n"], 0
        apply_model(tcfg, tp, t, impl="chunked")
    assert seen == [(8, 8)] * CFG["n_layers"]
    nq = 32 // 8
    assert skip_blocks == CFG["n_layers"] * nq * (nq + 1) // 2
    assert blocks["n"] == CFG["n_layers"] * nq * nq


@pytest.mark.parametrize("s", [32, 29])
def test_mla_impls_match_reference(s):
    """``mla_apply`` under the three impls (DeepSeek-V3's smoke layer at
    ``q_block`` 8) against the reference's."""
    jcfg = dataclasses.replace(jmla_smoke(), q_block=8)
    tcfg = dataclasses.replace(tmla_smoke(), q_block=8)
    jp = jax.jit(lambda k: jmla.mla_init(k, jcfg)[0])(jax.random.PRNGKey(2))
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    x = np.random.default_rng(3).standard_normal(
        (2, s, jcfg.d_model)).astype(np.float32)
    pos = np.arange(s, dtype=np.int32)
    for i in IMPLS:
        want = jax.jit(lambda p, x, i=i: jmla.mla_apply(
            jcfg, p, x, positions=jnp.asarray(pos), impl=i))(
                jp, jnp.asarray(x))
        with torch.no_grad():
            got = mla.mla_apply(tcfg, tp, torch.from_numpy(x),
                                positions=torch.from_numpy(pos), impl=i)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=FWD_TOL, err_msg=i)


def _grads(tcfg, tp, batch, impl):
    flat = [t for _, leaf in keyed_leaves(tp)
            for t in (leaf if isinstance(leaf, list) else [leaf])]
    for t in flat:
        t.requires_grad_(True)
    loss, _ = loss_fn(tcfg, tp, {k: torch.from_numpy(v)
                                 for k, v in batch.items()}, impl=impl)
    grads = torch.autograd.grad(loss, flat, allow_unused=True,
                                materialize_grads=True)
    by_id = dict(zip(map(id, flat), grads))
    return float(loss.detach()), {
        name: (torch.stack([by_id[id(t)] for t in leaf])
               if isinstance(leaf, list) else by_id[id(leaf)]).numpy()
        for name, leaf in keyed_leaves(tp)}


def test_skip_loss_and_grads_match_reference(dense):
    """``loss_fn(..., impl="chunked_causal_skip")`` and its gradients
    against ``jax.value_and_grad`` of the reference's, and against the
    port's ``"chunked"``: f32, within 1e-5."""
    jcfg, tcfg, jp, tree = dense
    toks = _tokens(4, 2, 33, CFG["vocab"])
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jloss(jcfg, p, b, impl="chunked_causal_skip"),
        has_aux=True))(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    want = {jax.tree_util.keystr(k): np.asarray(v) for k, v in
            jax.tree_util.tree_flatten_with_path(jg)[0]}
    loss, grads = _grads(tcfg, params_from_jax(tcfg, tree, device="cpu"),
                         batch, "chunked_causal_skip")
    loss_c, grads_c = _grads(tcfg, params_from_jax(tcfg, tree, device="cpu"),
                             batch, "chunked")
    assert loss == pytest.approx(float(jl), abs=GRAD_TOL)
    assert loss == pytest.approx(loss_c, abs=GRAD_TOL)
    assert set(grads) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(grads[name], w, rtol=0, atol=GRAD_TOL,
                                   err_msg=name)
        np.testing.assert_allclose(grads[name], grads_c[name], rtol=0,
                                   atol=GRAD_TOL, err_msg=name)


def test_chunked_stays_the_default(dense, monkeypatch):
    """With no impl the chunked path runs, not the skip schedule, as in
    the reference (whose ``impl`` defaults to ``"chunked"``)."""
    _, tcfg, _, tree = dense
    tp = params_from_jax(tcfg, tree, device="cpu")
    t = torch.from_numpy(_tokens(5, 1, 32, CFG["vocab"]))

    def refuse(*a):
        raise AssertionError("the skip schedule ran by default")

    with torch.no_grad():
        want = apply_model(tcfg, tp, t, impl="chunked")[0]
        monkeypatch.setattr(attention, "_flash_causal_skip", refuse)
        got = apply_model(tcfg, tp, t)[0]
    assert torch.equal(got, want)
