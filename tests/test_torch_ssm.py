"""The port's Mamba-2 mixer and the SSM and hybrid models against the JAX
package's, on the same numpy inputs with the reference's params carried
over through numpy.  Tolerance 1e-4 (atol and rtol) in float32: the same
math, summed in another order."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import ModelConfig as JConfig  # noqa: E402
from repro.configs.mamba2_130m import smoke as jsmoke  # noqa: E402
from repro.models import apply_model as japply  # noqa: E402
from repro.models import decode_step as jdecode  # noqa: E402
from repro.models import init_cache as jinit_cache  # noqa: E402
from repro.models import init_model as jinit  # noqa: E402
from repro.models import prefill as jprefill  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402

from repro_torch.configs.base import ModelConfig as TConfig  # noqa: E402
from repro_torch.configs.mamba2_130m import smoke as tsmoke  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels import model_kernels  # noqa: E402
from repro_torch.models import (apply_model, decode_step, init_cache,  # noqa: E402
                                prefill)
from repro_torch.models import ssm as tssm  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)
F32J = dict(dtype=jnp.float32, param_dtype=jnp.float32, q_block=8)
F32T = dict(dtype=torch.float32, param_dtype=torch.float32, q_block=8)
# tests/test_models_consistency.py::test_ssm_consistency and the hybrid
# of tests/test_serving.py::test_hybrid_serving_greedy (no experts)
CONFIGS = {
    "ssm": dict(name="ssm", family="ssm", n_layers=3, d_model=64,
                n_heads=1, n_kv_heads=1, d_ff=0, vocab=97, ssm_state=16,
                ssm_head_dim=16, ssm_chunk=8, tie_embeddings=True),
    "hybrid": dict(name="h", family="hybrid", n_layers=4, d_model=64,
                   n_heads=4, n_kv_heads=2, d_ff=128, vocab=97,
                   attn_layer_period=4, attn_layer_offset=1, ssm_state=16,
                   ssm_head_dim=16, ssm_chunk=8),
}


def _close(got, want):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want), **TOL)


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.long)


def _jinit(jcfg, seed):
    """The reference's params, its init compiled as one program (twice
    as fast as running it op by op)."""
    return jax.jit(lambda k: jinit(k, jcfg)[0])(jax.random.PRNGKey(seed))


def _japply_ssm(jcfg):
    """The reference mixer with its decode cache, compiled as one program
    (ten times as fast as op by op)."""
    return jax.jit(lambda p, x: jssm.ssm_apply(jcfg, p, x,
                                               return_cache=True))


def _tree(j):
    """A JAX param or cache tree as torch tensors (float32 here)."""
    if isinstance(j, dict):
        return {k: _tree(v) for k, v in j.items()}
    return torch.from_numpy(np.array(j))


@pytest.fixture(scope="module")
def mixer():
    jcfg, tcfg = jsmoke(), tsmoke()
    jp = jax.jit(lambda k: jssm.ssm_init(k, jcfg)[0])(jax.random.PRNGKey(0))
    return jcfg, tcfg, jp, _tree(jp)


@pytest.mark.parametrize("s", [16, 24, 37])
def test_ssd_chunked(s):
    """Chunk halving included: 24 -> chunks of 8, 37 -> one-row chunks."""
    rng = np.random.default_rng(s)
    b, h, p, n = 2, 3, 8, 4
    x = rng.standard_normal((b, s, h, p), np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(h)).astype(np.float32)
    Bm = rng.standard_normal((b, s, h, n), np.float32)
    Cm = rng.standard_normal((b, s, h, n), np.float32)
    arrs = (x, dt, A, Bm, Cm)
    want = jax.jit(jssm.ssd_chunked, static_argnums=5)(
        *map(jnp.asarray, arrs), 16)
    got = tssm.ssd_chunked(*map(torch.from_numpy, arrs), 16)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("groups", [1, 2])
def test_heads_match_reference_repeat(groups):
    """``_heads`` gives the reference's x and head-repeated B/C; with one
    group B/C are views of the conv output with stride 0 over the heads
    (what the SSD-scan kernel reads), with more they are copies."""
    jcfg = dataclasses.replace(jsmoke(), ssm_groups=groups)
    tcfg = dataclasses.replace(tsmoke(), ssm_groups=groups)
    conv_ch = tcfg.ssm_d_inner + 2 * groups * tcfg.ssm_state
    xbc = np.random.default_rng(groups).standard_normal((2, 5, conv_ch),
                                                         np.float32)
    txbc = torch.from_numpy(xbc)
    got = tssm._heads(tcfg, txbc)
    for g, w in zip(got, jssm._heads(jcfg, jnp.asarray(xbc))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    _, Bm, Cm = got
    shares = groups == 1
    assert (Bm.stride(2) == 0) == shares and (Cm.stride(2) == 0) == shares
    assert (Bm.data_ptr() == txbc[..., tcfg.ssm_d_inner:].data_ptr()
            ) == shares


@pytest.fixture(scope="module")
def mixer_out(mixer):
    """The reference mixer's output and decode cache for one input (its
    output does not depend on ``return_cache``)."""
    jcfg, _, jp, _ = mixer
    x = np.random.default_rng(4).standard_normal((2, 21, 64), np.float32)
    want, jcache = _japply_ssm(jcfg)(jp, jnp.asarray(x))
    return x, want, jcache


@pytest.mark.parametrize("return_cache", [False, True])
@pytest.mark.parametrize("hook", [False, True])
def test_ssm_apply(mixer, mixer_out, return_cache, hook):
    """The port's mixer, with its plain path or the SSD-scan hook (plain
    version on the CPU), against the reference's plain path."""
    _, tcfg, _, tp = mixer
    x, want, jcache = mixer_out
    got, tcache = tssm.ssm_apply(
        tcfg, tp, torch.from_numpy(x), return_cache=return_cache,
        kernel_fn=model_kernels(tcfg)["ssd_scan"] if hook else None)
    _close(got, want)
    assert (tcache is None) == (not return_cache)
    if return_cache:
        assert set(tcache) == {"conv", "h"}
        for key in tcache:
            assert tcache[key].dtype == torch.float32
            _close(tcache[key], jcache[key])


def test_ssm_decode_three_tokens(mixer):
    """Prefill a short prompt (shorter than the conv window), then decode
    three tokens; the port updates its cache in place."""
    jcfg, tcfg, jp, tp = mixer
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 2, 64), np.float32)
    _, jcache = _japply_ssm(jcfg)(jp, jnp.asarray(x))
    _, tcache = tssm.ssm_apply(tcfg, tp, torch.from_numpy(x),
                               return_cache=True)
    jdec = jax.jit(lambda p, xt, c: jssm.ssm_decode(jcfg, p, xt, c))
    for i in range(3):
        xt = rng.standard_normal((2, 1, 64), np.float32)
        want, jcache = jdec(jp, jnp.asarray(xt), jcache)
        h_before = tcache["h"]
        got, out_cache = tssm.ssm_decode(tcfg, tp, torch.from_numpy(xt),
                                         tcache)
        assert out_cache is tcache and tcache["h"] is h_before
        _close(got, want)
        for key in ("conv", "h"):
            _close(tcache[key], jcache[key])


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_prefill_decode_consistency(name):
    """tests/test_models_consistency.py's check with the port on both
    sides (prefill and one decode against apply_model), each side's
    logits also held against the reference's."""
    jcfg = JConfig(**CONFIGS[name], **F32J)
    tcfg = TConfig(**CONFIGS[name], **F32T)
    jp = _jinit(jcfg, 0)
    tp = params_from_jax(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    S, B = 16, 2
    toks = np.random.default_rng(1).integers(0, jcfg.vocab, (B, S)).astype(
        np.int32)
    tl_pre, tc = prefill(tcfg, tp, _t(toks),
                         init_cache(tcfg, B, 2 * S, device="cpu"),
                         kernels=model_kernels(tcfg))
    jl_pre, jc = jax.jit(lambda p, t, c: jprefill(jcfg, p, t, c))(
        jp, jnp.asarray(toks), jinit_cache(jcfg, B, 2 * S))
    nxt = torch.argmax(tl_pre[:, -1], -1)[:, None]
    assert nxt.tolist() == np.asarray(jnp.argmax(jl_pre[:, -1], -1)
                                      )[:, None].tolist()
    tl_dec, tc = decode_step(tcfg, tp, nxt, tc, S)
    jl_dec, jc = jax.jit(lambda p, t, c, n: jdecode(jcfg, p, t, c, n))(
        jp, jnp.asarray(nxt.numpy()), jc, jnp.int32(S))
    full = torch.cat([_t(toks), nxt], 1)
    tl_full = apply_model(tcfg, tp, full)[0]
    jl_full, _ = jax.jit(lambda p, t: japply(jcfg, p, t))(
        jp, jnp.asarray(full.numpy()))
    for got, want in ((tl_pre[:, -1], tl_full[:, S - 1]),
                      (tl_dec[:, 0], tl_full[:, S])):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=5e-5)
    _close(tl_pre, jl_pre)
    _close(tl_dec, jl_dec)
    _close(tl_full, jl_full)
    for j, layer in jc["stack"].items():
        assert set(tc["stack"][j]) == set(layer)
        for key, want in layer.items():
            assert tuple(tc["stack"][j][key].shape) == want.shape
            _close(tc["stack"][j][key], want)


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_converter_round_trips_ssm_leaves(param_dtype):
    """Every leaf of an SSM tree crosses over with its bits and dtype,
    the float32 A_log, D and dt_bias beside bfloat16 weights."""
    jcfg = dataclasses.replace(jsmoke(),
                               param_dtype=getattr(jnp, param_dtype))
    tree = jax.tree.map(np.asarray, _jinit(jcfg, 2))
    tp = params_from_jax(tsmoke(), tree, device="cpu")
    n_periods = tsmoke().scan_plan()[2]
    assert len(tp["stack"]) == n_periods == 2

    def walk(j, t, path):
        if isinstance(j, dict):
            assert set(j) == set(t), path
            for k in j:
                walk(j[k], t[k], path + (k,))
            return
        assert str(t.dtype).split(".")[1] == j.dtype.name, path
        bits = {2: (torch.int16, np.int16), 4: (torch.int32, np.int32)}[
            j.dtype.itemsize]
        np.testing.assert_array_equal(t.view(bits[0]).numpy(),
                                      j.view(bits[1]), err_msg=str(path))

    for name, sub in tree.items():
        if name == "stack":
            for n in range(n_periods):
                walk(jax.tree.map(lambda a: a[n], sub), tp["stack"][n],
                     ("stack", n))
        else:
            walk(sub, tp[name], (name,))
    mixer_leaves = tp["stack"][0]["l0"]["mixer"]
    assert {k for k, v in mixer_leaves.items()
            if not isinstance(v, dict) and v.dtype == torch.float32} >= {
                "A_log", "D", "dt_bias"}
