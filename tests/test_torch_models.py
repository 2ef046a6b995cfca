"""The port's dense model against the JAX package's, on qwen2-0.5b's
smoke config in float32 with the reference's params carried over
through numpy.  Tolerance 1e-4 (atol and rtol): the same float32 math,
summed in another order."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.qwen2_0_5b import smoke as jsmoke  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import apply_model as japply  # noqa: E402
from repro.models import decode_step as jdecode  # noqa: E402
from repro.models import init_cache as jinit_cache  # noqa: E402
from repro.models import init_model as jinit  # noqa: E402
from repro.models import prefill as jprefill  # noqa: E402

from repro_torch.configs.base import ModelConfig as TConfig  # noqa: E402
from repro_torch.configs.qwen2_0_5b import smoke as tsmoke  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels import model_kernels  # noqa: E402
from repro_torch.models import (apply_model, decode_step, init_cache,  # noqa: E402
                                init_model, prefill)

TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = jsmoke(), tsmoke()
    jp, _ = jinit(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(np.asarray, jp)
    return jcfg, tcfg, jp, tree, params_from_jax(tcfg, tree, device="cpu")


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.long)


def _close(got, want):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want),
                               **TOL)


@pytest.mark.parametrize("s", [5, 16, 40])
def test_apply_model_logits(setup, s):
    """s <= q_block runs attention_full, s > q_block the chunked path."""
    jcfg, tcfg, jp, _, tp = setup
    toks = _tokens(s, 2, s, jcfg.vocab)
    want, _ = japply(jcfg, jp, jnp.asarray(toks))
    _close(apply_model(tcfg, tp, _t(toks)), want)


def test_apply_model_with_flash_hook(setup):
    """The port's model_kernels (plain flash on CPU) against the JAX
    model with the Pallas kernel in interpret mode."""
    jcfg, tcfg, jp, _, tp = setup
    toks = _tokens(11, 1, 24, jcfg.vocab)
    want, _ = japply(jcfg, jp, jnp.asarray(toks),
                     kernels=jops.model_kernels(jcfg, backend="pallas"))
    _close(apply_model(tcfg, tp, _t(toks), kernels=model_kernels(tcfg)),
           want)


def test_prefill_and_three_decode_steps(setup):
    jcfg, tcfg, jp, _, tp = setup
    b, s, smax = 2, 23, 48
    toks = _tokens(1, b, s, jcfg.vocab)
    jc = jinit_cache(jcfg, b, smax)
    tc = init_cache(tcfg, b, smax, device="cpu")
    jl, jc = jprefill(jcfg, jp, jnp.asarray(toks), jc)
    tl, tc = prefill(tcfg, tp, _t(toks), tc)
    _close(tl, jl)
    for key in ("k", "v"):
        _close(tc["stack"]["l0"][key], jc["stack"]["l0"][key])
    for i in range(3):
        nt = _tokens(100 + i, b, 1, jcfg.vocab)
        jl, jc = jdecode(jcfg, jp, jnp.asarray(nt), jc, jnp.int32(s + i))
        tl, tc = decode_step(tcfg, tp, _t(nt), tc, s + i)
        _close(tl, jl)
        for key in ("k", "v"):
            _close(tc["stack"]["l0"][key], jc["stack"]["l0"][key])


def test_decode_per_sequence_lengths(setup):
    """One batched decode with a length per sequence equals the
    reference's scalar-length decode of each sequence alone."""
    jcfg, tcfg, jp, _, tp = setup
    smax, lens = 32, [5, 12, 1]
    tc = init_cache(tcfg, len(lens), smax, device="cpu")
    want = []
    for i, n in enumerate(lens):
        toks = _tokens(20 + i, 1, n, jcfg.vocab)
        jc = jinit_cache(jcfg, 1, smax)
        _, jc = jprefill(jcfg, jp, jnp.asarray(toks), jc)
        view = {"stack": {"l0": {k: t[:, i:i + 1] for k, t in
                                 tc["stack"]["l0"].items()}}}
        prefill(tcfg, tp, _t(toks), view)
        nt = np.array([[7 + i]], np.int32)
        jl, _ = jdecode(jcfg, jp, jnp.asarray(nt), jc, jnp.int32(n))
        want.append(np.asarray(jl)[0])
    nt = np.array([[7], [8], [9]], np.int32)
    tl, _ = decode_step(tcfg, tp, _t(nt), tc, torch.tensor(lens))
    _close(tl, np.stack(want))


def test_converter_round_trips_every_leaf(setup):
    jcfg, tcfg, _, tree, tp = setup
    n_periods = tcfg.scan_plan()[2]
    assert len(tp["stack"]) == n_periods

    def walk(j, t, path):
        if isinstance(j, dict):
            assert set(j) == set(t), path
            for k in j:
                walk(j[k], t[k], path + (k,))
        else:
            assert t.dtype == torch.float32, path
            np.testing.assert_array_equal(t.numpy(), j, err_msg=str(path))

    for name, sub in tree.items():
        if name == "stack":
            for n in range(n_periods):
                walk(jax.tree.map(lambda a: a[n], sub), tp["stack"][n],
                     ("stack", n))
        else:
            walk(sub, tp[name], (name,))


def test_converter_keeps_bfloat16_bits():
    jcfg = jsmoke()
    jcfg.param_dtype = jnp.bfloat16
    jp, _ = jinit(jax.random.PRNGKey(1), jcfg)
    tree = jax.tree.map(np.asarray, jp)
    tcfg = tsmoke()
    tp = params_from_jax(tcfg, tree, device="cpu")
    w = tp["stack"][1]["l0"]["mixer"]["wq"]["w"]
    assert w.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        w.view(torch.int16).numpy(),
        tree["stack"]["l0"]["mixer"]["wq"]["w"][1].view(np.int16))


def test_init_model_layout_and_distributions():
    """The port's own init: the reference's tree (stack unstacked) with
    the same scales, drawn from a torch.Generator."""
    tcfg = tsmoke()
    jp, _ = jinit(jax.random.PRNGKey(0), jsmoke())
    tp = init_model(torch.Generator().manual_seed(0), tcfg, device="cpu")
    assert set(tp) == set(jp)
    assert len(tp["stack"]) == tcfg.n_layers
    jshapes = jax.tree.map(lambda a: a.shape[1:], jp["stack"])
    tshapes = jax.tree.map(lambda t: tuple(t.shape), tp["stack"][0])
    assert jshapes == tshapes
    emb = tp["embed"]["emb"]
    assert abs(float(emb.std()) - 0.02) < 0.002
    wq = tp["stack"][0]["l0"]["mixer"]["wq"]
    assert abs(float(wq["w"].std()) - tcfg.d_model ** -0.5) < 0.02
    assert float(wq["b"].abs().max()) == 0.0
    again = init_model(torch.Generator().manual_seed(0), tcfg, device="cpu")
    assert torch.equal(again["embed"]["emb"], emb)


@pytest.mark.parametrize("kind", ["hybrid_moe", "moe", "mla"])
def test_unported_layers_raise(kind):
    kw = dict(n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
              vocab=64, dtype=torch.float32, param_dtype=torch.float32)
    # hybrid_moe: Jamba's plan (mamba and attention layers, experts every
    # second layer), which waits for the MoE slice
    extra = {"hybrid_moe": dict(family="hybrid", ssm_state=16,
                                attn_layer_period=8, attn_layer_offset=4,
                                n_experts=4, n_experts_per_tok=2,
                                moe_d_ff=32, expert_layer_period=2,
                                expert_layer_offset=1),
             "moe": dict(family="moe", n_experts=4, n_experts_per_tok=2,
                         moe_d_ff=32),
             "mla": dict(q_lora_rank=16, kv_lora_rank=16)}[kind]
    cfg = TConfig(**kw, **extra)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        init_model(torch.Generator(), cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        init_cache(cfg, 1, 8, device="cpu")


VARIANTS = {
    "layernorm_gelu": dict(norm="ln", act="gelu"),
    "qk_norm_window": dict(qk_norm=True, sliding_window=8),
    "untied_head_noncausal": dict(tie_embeddings=False, causal=False),
}


@pytest.mark.parametrize("name", sorted(VARIANTS))
@pytest.mark.parametrize("s", [12, 24])
def test_config_variants_logits(name, s):
    """The model's other config paths (layernorm, GELU, qk-norm, sliding
    window, untied head, bidirectional) on the full and chunked
    attention paths."""
    kw = dict(n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, d_ff=48,
              vocab=50, q_block=16, **VARIANTS[name])
    from repro.configs.base import ModelConfig as JConfig
    jcfg = JConfig(dtype=jnp.float32, param_dtype=jnp.float32, **kw)
    tcfg = TConfig(dtype=torch.float32, param_dtype=torch.float32, **kw)
    jp, _ = jinit(jax.random.PRNGKey(2), jcfg)
    tp = params_from_jax(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    toks = _tokens(s + 1, 2, s, jcfg.vocab)
    want, _ = japply(jcfg, jp, jnp.asarray(toks))
    _close(apply_model(tcfg, tp, _t(toks)), want)
