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
    _close(apply_model(tcfg, tp, _t(toks))[0], want)


def test_apply_model_with_flash_hook(setup):
    """The port's model_kernels (plain flash on CPU) against the JAX
    model with the Pallas kernel in interpret mode."""
    jcfg, tcfg, jp, _, tp = setup
    toks = _tokens(11, 1, 24, jcfg.vocab)
    want, _ = japply(jcfg, jp, jnp.asarray(toks),
                     kernels=jops.model_kernels(jcfg, backend="pallas"))
    _close(apply_model(tcfg, tp, _t(toks), kernels=model_kernels(tcfg))[0],
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
    """Every layer kind is ported now and builds: MoE layers, alone
    (``moe``) or in Jamba's plan (``hybrid_moe``: mamba and attention
    layers, experts every second layer), and MLA layers (``mla``), whose
    params and latent cache take the reference's keys and shapes."""
    kw = dict(n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
              vocab=64, dtype=torch.float32, param_dtype=torch.float32)
    extra = {"hybrid_moe": dict(family="hybrid", ssm_state=16,
                                attn_layer_period=8, attn_layer_offset=4,
                                n_experts=4, n_experts_per_tok=2,
                                moe_d_ff=32, expert_layer_period=2,
                                expert_layer_offset=1),
             "moe": dict(family="moe", n_experts=4, n_experts_per_tok=2,
                         moe_d_ff=32),
             "mla": dict(q_lora_rank=16, kv_lora_rank=16,
                         qk_nope_head_dim=8, qk_rope_head_dim=4,
                         v_head_dim=8)}[kind]
    cfg = TConfig(**kw, **extra)
    params = init_model(torch.Generator(), cfg, device="cpu")
    caches = init_cache(cfg, 1, 8, device="cpu")
    prefix, period, n_periods = cfg.scan_plan()
    if kind == "mla":
        mixer = params["stack"][0]["l0"]["mixer"]
        assert {k: tuple(v["w"].shape) for k, v in mixer.items()
                if "w" in v} == {
            "w_dq": (32, 16), "w_uq": (16, 4 * 12), "w_dkv": (32, 16 + 4),
            "w_uk": (16, 4 * 8), "w_uv": (16, 4 * 8), "wo": (4 * 8, 32)}
        assert {k: tuple(t.shape) for k, t in caches["stack"]["l0"].items()
                } == {"ckv": (n_periods, 1, 8, 16),
                      "krope": (n_periods, 1, 8, 4)}
        return
    moe = [f"l{j}" for j, spec in enumerate(period) if spec.ffn == "moe"]
    assert moe and all(set(params["stack"][0][name]["ffn"]) == {
        "router", "w_gate", "w_up", "w_down"} for name in moe)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 8),
                                           (False, None)])
@pytest.mark.parametrize("s", [37, 40])
def test_chunked_attention_pads_to_whole_blocks(monkeypatch, s, causal,
                                                window):
    """The chunked path keeps blocks of q_block rows and masks a padded
    tail (37 is prime: the reference's gcd blocks are single rows there),
    and equals the reference's ``attention_chunked``."""
    from repro.models import attention as jattn
    from repro_torch.models import attention as tattn
    rng = np.random.default_rng(s)
    q, k, v = (rng.standard_normal((2, s, h, 8)).astype(np.float32)
               for h in (4, 2, 2))
    kw = dict(scale=8 ** -0.5, causal=causal, window=window, q_block=16,
              k_block=16)
    want = jax.jit(lambda q, k, v: jattn.attention_chunked(q, k, v, **kw))(
        q, k, v)
    blocks = []
    fwd = tattn._flash_fwd

    def spy(*a, **k):
        blocks.append(a[6:8])
        return fwd(*a, **k)

    monkeypatch.setattr(tattn, "_flash_fwd", spy)
    got = tattn.attention_chunked(*map(torch.as_tensor, (q, k, v)), **kw)
    assert blocks == [(16, 16)]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


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
    _close(apply_model(tcfg, tp, _t(toks))[0], want)


# ---------------------------------------------------------------------------
# MoE: qwen3-moe-30b-a3b's and jamba-1.5-large-398b's smoke configs
# ---------------------------------------------------------------------------
from repro.configs.jamba_1_5_large_398b import smoke as jjamba  # noqa: E402
from repro.configs.qwen3_moe_30b_a3b import smoke as jqwen3  # noqa: E402
from repro_torch.configs.jamba_1_5_large_398b import smoke as tjamba  # noqa: E402
from repro_torch.configs.qwen3_moe_30b_a3b import smoke as tqwen3  # noqa: E402

MOE_SMOKES = {"qwen3-moe": (jqwen3, tqwen3), "jamba": (jjamba, tjamba)}


@pytest.fixture(scope="module", params=sorted(MOE_SMOKES))
def moe_setup(request):
    """The reference's params for the smoke config (its init compiled as
    one program), carried over; the reference's entry points jitted."""
    jcfg, tcfg = (f() for f in MOE_SMOKES[request.param])
    jp = jax.jit(lambda k: jinit(k, jcfg)[0])(jax.random.PRNGKey(3))
    tree = jax.tree.map(np.asarray, jp)
    fns = {"apply": jax.jit(lambda p, t: japply(jcfg, p, t)),
           "prefill": jax.jit(lambda p, t, c: jprefill(jcfg, p, t, c)),
           "decode": jax.jit(lambda p, t, c, n: jdecode(jcfg, p, t, c, n))}
    return jcfg, tcfg, jp, tree, params_from_jax(tcfg, tree, device="cpu"), \
        fns


@pytest.mark.parametrize("kernels", [False, True])
def test_moe_apply_model_logits(moe_setup, kernels):
    """Full-sequence logits with and without the port's kernel hooks
    (flash, SSD scan and the grouped matmul: plain versions on the
    CPU)."""
    jcfg, tcfg, jp, _, tp, fns = moe_setup
    toks = _tokens(31, 2, 24, jcfg.vocab)
    want, aux = fns["apply"](jp, jnp.asarray(toks))
    assert float(aux) > 0
    got = apply_model(tcfg, tp, _t(toks),
                      kernels=model_kernels(tcfg) if kernels else None)[0]
    _close(got, want)


def test_moe_prefill_and_decode_caches(moe_setup):
    """Prefill then three decode steps: logits and every cache leaf (KV
    rows of attention layers, conv and SSM state of Mamba layers)."""
    jcfg, tcfg, jp, _, tp, fns = moe_setup
    b, s, smax = 2, 19, 40
    toks = _tokens(32, b, s, jcfg.vocab)
    jc = jinit_cache(jcfg, b, smax)
    tc = init_cache(tcfg, b, smax, device="cpu")
    kern = model_kernels(tcfg)

    def same_caches():
        for name, sub in jc["stack"].items():
            for key, leaf in sub.items():
                _close(tc["stack"][name][key], leaf)

    jl, jc = fns["prefill"](jp, jnp.asarray(toks), jc)
    tl, tc = prefill(tcfg, tp, _t(toks), tc, kernels=kern)
    _close(tl, jl)
    same_caches()
    for i in range(3):
        nt = _tokens(200 + i, b, 1, jcfg.vocab)
        jl, jc = fns["decode"](jp, jnp.asarray(nt), jc, jnp.int32(s + i))
        tl, tc = decode_step(tcfg, tp, _t(nt), tc, s + i, kernels=kern)
        _close(tl, jl)
        same_caches()


def test_converter_carries_moe_leaves(moe_setup):
    """``params_from_jax`` carries the router (f32 ``{"w"}``) and the
    expert stacks (``[n_periods, E, d, f]`` in the reference's
    ``"stack"``, one ``[E, d, f]`` per period here) leaf for leaf."""
    jcfg, tcfg, _, tree, tp, _ = moe_setup
    _, period, n_periods = tcfg.scan_plan()
    moe = [f"l{j}" for j, spec in enumerate(period) if spec.ffn == "moe"]
    assert moe
    E, d, f = jcfg.n_experts, jcfg.d_model, jcfg.moe_d_ff
    for name in moe:
        jffn = tree["stack"][name]["ffn"]
        assert jffn["w_gate"]["w"].shape == (n_periods, E, d, f)
        for n in range(n_periods):
            tffn = tp["stack"][n][name]["ffn"]
            assert set(tffn) == set(jffn)
            assert tffn["router"]["w"].dtype == torch.float32
            for key, sub in jffn.items():
                np.testing.assert_array_equal(tffn[key]["w"].numpy(),
                                              sub["w"][n])


def test_converter_carries_shared_experts():
    kw = dict(name="sh", family="moe", n_layers=2, d_model=32, n_heads=4,
              n_kv_heads=2, d_ff=64, vocab=50, n_experts=4,
              n_experts_per_tok=2, moe_d_ff=16, n_shared_experts=2)
    from repro.configs.base import ModelConfig as JConfig
    jcfg = JConfig(dtype=jnp.float32, param_dtype=jnp.float32, **kw)
    tcfg = TConfig(dtype=torch.float32, param_dtype=torch.float32, **kw)
    jp = jax.jit(lambda k: jinit(k, jcfg)[0])(jax.random.PRNGKey(4))
    tree = jax.tree.map(np.asarray, jp)
    tp = params_from_jax(tcfg, tree, device="cpu")
    for key in ("shared_gate", "shared_up", "shared_down"):
        np.testing.assert_array_equal(
            tp["stack"][1]["l0"]["ffn"][key]["w"].numpy(),
            tree["stack"]["l0"]["ffn"][key]["w"][1])
    toks = _tokens(33, 2, 12, jcfg.vocab)
    want, _ = japply(jcfg, jp, jnp.asarray(toks))
    _close(apply_model(tcfg, tp, _t(toks))[0], want)


# ---------------------------------------------------------------------------
# the decode-attention hook (its plain twin on the CPU)
# ---------------------------------------------------------------------------
def _bf16_at_hd64(name):
    """``name``'s smoke config in bf16 at head dim 64: a shape the
    ``decode_attention`` hook takes (the smoke configs' head dim of 16 is
    not one)."""
    import dataclasses
    from repro_torch.configs.base import get_smoke_config
    return dataclasses.replace(get_smoke_config(name), head_dim=64,
                               dtype=torch.bfloat16,
                               param_dtype=torch.bfloat16)


def _counting(fn, calls):
    def wrapped(*a, **kw):
        calls.append(1)
        return fn(*a, **kw)
    return wrapped


@pytest.mark.parametrize("name", ["internlm2-20b", "qwen3-moe-30b-a3b",
                                  "starcoder2-7b"])
def test_attn_decode_with_hook_equals_without(name):
    """``attn_decode`` through the hook (un-roped projections, the step's
    cos / sin given or not) gives the plain path's output and cache bit
    for bit: qwen3-moe with qk_norm, starcoder2 with its bias and a
    window shorter than some lengths."""
    from repro_torch.models.attention import attn_decode, attn_init
    from repro_torch.models.common import rope_cos_sin
    cfg = _bf16_at_hd64(name)
    hook = model_kernels(cfg)["decode_attention"]
    gen = torch.Generator().manual_seed(3)
    p = attn_init(gen, cfg, torch.device("cpu"))
    b, smax = 4, 40
    x = torch.randn((b, 1, cfg.d_model), generator=gen).to(torch.bfloat16)
    shape = (b, smax, cfg.n_kv_heads, cfg.head_dim)
    cache = {n: torch.randn(shape, generator=gen).to(torch.bfloat16)
             for n in ("k", "v")}
    lens = torch.tensor([0, 5, 23, 39], dtype=torch.int32)
    want_cache = {n: t.clone() for n, t in cache.items()}
    want, _ = attn_decode(cfg, p, x, want_cache, lens)
    for rope in (rope_cos_sin(lens, cfg.head_dim, cfg.rope_theta), None):
        got_cache = {n: t.clone() for n, t in cache.items()}
        calls = []
        got, _ = attn_decode(cfg, p, x, got_cache, lens,
                             kernel_fn=_counting(hook, calls), rope=rope)
        assert calls == [1]
        assert torch.equal(got, want)
        for n in ("k", "v"):
            assert torch.equal(got_cache[n], want_cache[n])


@pytest.mark.parametrize("name", ["internlm2-20b", "qwen3-moe-30b-a3b"])
def test_engine_with_decode_hook_decodes_the_same_tokens(name):
    """``ServingEngine`` with ``model_kernels`` (the decode hook's plain
    twin here) gives every request the tokens it gets without kernels,
    and the hook runs once per attention layer and decode tick."""
    from repro_torch.serving import Request, ServeConfig, ServingEngine
    cfg = _bf16_at_hd64(name)
    params = init_model(torch.Generator().manual_seed(0), cfg, device="cpu")
    prompts = [np.arange(n, dtype=np.int32) % cfg.vocab for n in
               (3, 11, 6, 17, 9)]

    def serve(kernels):
        eng = ServingEngine(cfg, params, ServeConfig(
            n_slots=3, max_seq=32, max_new_tokens=6), kernels=kernels,
            device="cpu")
        for i, pr in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=pr))
        done = eng.run_until_drained()
        assert len(done) == len(prompts) and not eng.failed
        return {r.rid: list(r.output) for r in done}, eng.stats["ticks"]

    calls = []
    kernels = model_kernels(cfg)
    kernels["decode_attention"] = _counting(kernels["decode_attention"],
                                            calls)
    got, ticks = serve(kernels)
    want, _ = serve(None)
    assert got == want
    attn_layers = sum(l.mixer == "attn" for l in cfg.layer_plan())
    assert len(calls) == ticks * attn_layers > 0
