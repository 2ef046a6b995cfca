"""Every reference architecture in the port: the config registry and each
config against the JAX package's, and the smoke models of the six
architectures ported last (three dense configs, DeepSeek-V3's MLA + MoE
+ MTP, the vision and the audio frontend) against the reference's, in
float32 with the reference's params carried over through numpy.
Tolerance 1e-4 (atol and rtol): the same float32 math, summed in another
order."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import apply_model as japply  # noqa: E402
from repro.models import decode_step as jdecode  # noqa: E402
from repro.models import init_cache as jinit_cache  # noqa: E402
from repro.models import init_model as jinit  # noqa: E402
from repro.models import prefill as jprefill  # noqa: E402

from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels import model_kernels  # noqa: E402
from repro_torch.models import (apply_model, decode_step, init_cache,  # noqa: E402
                                init_model, prefill)

TOL = dict(atol=1e-4, rtol=1e-4)
NEW = ["internlm2-20b", "starcoder2-7b", "command-r-plus-104b",
       "deepseek-v3-671b", "llava-next-mistral-7b", "hubert-xlarge"]


def test_arch_ids_and_list_archs_match_reference():
    assert tbase.ARCH_IDS == jbase.ARCH_IDS
    assert tbase.list_archs() == jbase.list_archs()
    with pytest.raises(KeyError, match="unknown architecture"):
        tbase.get_config("gpt-2")


def _fields(cfg):
    """The config's fields, dtypes by name (jnp.bfloat16 and
    torch.bfloat16 are the same type to the model)."""
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if f.name in ("dtype", "param_dtype", "opt_dtype"):
            v = str(jnp.dtype(v)) if not isinstance(v, torch.dtype) \
                else str(v).split(".")[1]
        out[f.name] = v
    return out


@pytest.mark.parametrize("which", ["full", "smoke"])
@pytest.mark.parametrize("arch", jbase.ARCH_IDS)
def test_configs_match_reference(arch, which):
    """Every field of the full and the smoke config equals the
    reference's (the twin of tests/test_archs_smoke.py::
    test_full_configs_match_assignment), with the same layer plan and
    decode-cache spec."""
    get = {"full": (jbase.get_config, tbase.get_config),
           "smoke": (jbase.get_smoke_config, tbase.get_smoke_config)}[which]
    jcfg, tcfg = get[0](arch), get[1](arch)
    assert _fields(tcfg) == _fields(jcfg)
    assert [(s.mixer, s.ffn) for s in tcfg.layer_plan()] == \
        [(s.mixer, s.ffn) for s in jcfg.layer_plan()]
    assert tcfg.kv_cache_spec(8, 1024) == jcfg.kv_cache_spec(8, 1024)


def _inputs(cfg, seed, b=2, s=20):
    """Tokens, and the frontend's embeddings where the config has one."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    fe = None
    if cfg.family == "audio":
        fe = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    elif cfg.frontend_len:
        fe = rng.standard_normal((b, cfg.frontend_len, cfg.d_model)).astype(
            np.float32)
    return toks, fe


def _t(a):
    return None if a is None else torch.as_tensor(a)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.fixture(scope="module")
def models():
    """{arch: (jcfg, tcfg, reference params, the port's params)}, built
    once per architecture that asks."""
    built = {}

    def get(arch):
        if arch not in built:
            jcfg = jbase.get_smoke_config(arch)
            tcfg = tbase.get_smoke_config(arch)
            jp = jax.jit(lambda k: jinit(k, jcfg)[0])(jax.random.PRNGKey(0))
            tp = params_from_jax(tcfg, jax.tree.map(np.asarray, jp),
                                 device="cpu")
            built[arch] = (jcfg, tcfg, jp, tp)
        return built[arch]
    return get


@pytest.mark.parametrize("arch", NEW)
def test_smoke_model_matches_reference(models, arch):
    """apply_model's logits (20 positions: above q_block, so the chunked
    attention runs); for a decoder also prefill and two decode steps.
    llava runs here without patch embeddings (a text-only prompt), hubert
    on frame embeddings."""
    jcfg, tcfg, jp, tp = models(arch)
    toks, fe = _inputs(jcfg, 1)
    if jcfg.family == "vlm":
        fe = None
    want = jax.jit(lambda p, t, f: japply(jcfg, p, t, frontend_embeds=f)[0])(
        jp, jnp.asarray(toks), None if fe is None else jnp.asarray(fe))
    _close(apply_model(tcfg, tp, _t(toks).long(), frontend_embeds=_t(fe))[0],
           want)
    if not jcfg.causal:
        return
    b, s = toks.shape
    jc = jinit_cache(jcfg, b, 32)
    tc = init_cache(tcfg, b, 32, device="cpu")
    jl, jc = jax.jit(lambda p, t, c: jprefill(jcfg, p, t, c))(
        jp, jnp.asarray(toks), jc)
    tl, tc = prefill(tcfg, tp, _t(toks).long(), tc)
    _close(tl, jl)
    jstep = jax.jit(lambda p, t, c, n: jdecode(jcfg, p, t, c, n))
    for i in range(2):
        nt = np.random.default_rng(30 + i).integers(
            0, jcfg.vocab, (b, 1)).astype(np.int32)
        jl, jc = jstep(jp, jnp.asarray(nt), jc, jnp.int32(s + i))
        tl, tc = decode_step(tcfg, tp, _t(nt).long(), tc, s + i)
        _close(tl, jl)


def test_llava_with_patch_embeddings(models):
    """The VLM frontend: 16 patch embeddings prepended to an 8-token
    prompt.  apply_model's logits over all 24 positions, then prefill
    with the same embeddings and two decode steps after them."""
    jcfg, tcfg, jp, tp = models("llava-next-mistral-7b")
    toks, fe = _inputs(jcfg, 2, s=8)
    want = jax.jit(lambda p, t, f: japply(jcfg, p, t, frontend_embeds=f)[0])(
        jp, jnp.asarray(toks), jnp.asarray(fe))
    got = apply_model(tcfg, tp, _t(toks).long(), frontend_embeds=_t(fe))[0]
    assert tuple(got.shape) == (2, jcfg.frontend_len + 8, jcfg.vocab)
    _close(got, want)
    n = jcfg.frontend_len + 8
    jc = jinit_cache(jcfg, 2, 32)
    tc = init_cache(tcfg, 2, 32, device="cpu")
    jl, jc = jax.jit(lambda p, t, c, f: jprefill(jcfg, p, t, c,
                                                 frontend_embeds=f))(
        jp, jnp.asarray(toks), jc, jnp.asarray(fe))
    tl, tc = prefill(tcfg, tp, _t(toks).long(), tc, frontend_embeds=_t(fe))
    _close(tl, jl)
    _close(tl[:, 0], np.asarray(want)[:, -1])
    for i in range(2):
        nt = np.full((2, 1), 5 + i, np.int32)
        jl, jc = jdecode(jcfg, jp, jnp.asarray(nt), jc, jnp.int32(n + i))
        tl, tc = decode_step(tcfg, tp, _t(nt).long(), tc, n + i)
        _close(tl, jl)


def test_hubert_noncausal_flash_hook(models):
    """hubert's encoder with the flash hook, causal=False: the port's
    model_kernels (the kernel's plain version on the CPU) against the
    reference with the Pallas kernel in interpret mode."""
    jcfg, tcfg, jp, tp = models("hubert-xlarge")
    _, fe = _inputs(jcfg, 3, b=1, s=32)
    kernels = model_kernels(tcfg)
    assert "flash_attention" in kernels and not tcfg.causal
    want, _ = japply(jcfg, jp, None, frontend_embeds=jnp.asarray(fe),
                     kernels=jops.model_kernels(jcfg, backend="pallas"))
    got = apply_model(tcfg, tp, None, frontend_embeds=_t(fe),
                      kernels=kernels)[0]
    _close(got, want)


def _shapes(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_shapes(v, path + (k,)))
        return out
    if isinstance(tree, list):
        out = {}
        for n, v in enumerate(tree):
            out.update(_shapes(v, path + (n,)))
        return out
    return {path: (tuple(tree.shape), str(tree.dtype))}


@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "hubert-xlarge"])
def test_params_from_jax_matches_init_model_tree(models, arch):
    """params_from_jax maps DeepSeek-V3's tree (MLA layers, experts, the
    MTP params) and hubert's (no embed table) leaf for leaf onto the
    port's own init_model tree: the same keys, shapes and dtypes."""
    jcfg, tcfg, jp, tp = models(arch)
    own = init_model(torch.Generator().manual_seed(0), tcfg, device="cpu")
    assert _shapes(tp) == _shapes(own)
    if arch == "deepseek-v3-671b":
        assert {"mtp_layer", "mtp_proj", "mtp_norm"} <= set(own)
        assert own["mtp_layer"]["mixer"]["wq"]["w"].shape == (
            tcfg.d_model, tcfg.n_heads * tcfg.head_dim)
    else:
        assert "embed" not in own and "embed" not in jp


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here: the entry points run on it")


@pytest.mark.parametrize("arch", jbase.ARCH_IDS)
def test_entry_points_default_to_the_card(no_cuda, arch):
    """init_model and init_cache of every architecture default to
    ``"cuda"`` and raise where it is absent."""
    cfg = tbase.get_smoke_config(arch)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_model(torch.Generator(), cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_cache(cfg, 1, 8)
