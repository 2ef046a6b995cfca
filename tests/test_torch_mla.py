"""The port's Multi-head Latent Attention against the JAX package's, at
deepseek-v3-671b's smoke widths in float32 with the reference's params
carried over through numpy.  Tolerances: 1e-5 (atol and rtol) for one
function, 1e-4 for the whole model (the same float32 math, summed in
another order)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.deepseek_v3_671b import smoke as jsmoke  # noqa: E402
from repro.models import decode_step as jdecode  # noqa: E402
from repro.models import init_cache as jinit_cache  # noqa: E402
from repro.models import init_model as jinit  # noqa: E402
from repro.models import mla as jmla  # noqa: E402
from repro.models import prefill as jprefill  # noqa: E402
from repro.models.common import rope_cos_sin as jrope  # noqa: E402

from repro_torch.configs.deepseek_v3_671b import smoke as tsmoke  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import decode_step, init_cache, prefill  # noqa: E402
from repro_torch.models import mla  # noqa: E402
from repro_torch.models.common import rope_cos_sin  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


@pytest.fixture(scope="module")
def layer():
    """One MLA layer's params from the reference's init, on both sides."""
    jcfg, tcfg = jsmoke(), tsmoke()
    jp = jax.jit(lambda k: jmla.mla_init(k, jcfg)[0])(jax.random.PRNGKey(2))
    return jcfg, tcfg, jp, _torch_tree(jax.tree.map(np.asarray, jp))


def _x(seed, b, s, d):
    return np.random.default_rng(seed).standard_normal((b, s, d)).astype(
        np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


@pytest.mark.parametrize("per_seq", [False, True])
def test_rope_interleaved(layer, per_seq):
    """Shared positions [S] (prefill) and one row of positions per
    sequence [B, S] (the port's batched decode), the latter against the
    reference run on each sequence alone."""
    jcfg, _, _, _ = layer
    d = jcfg.qk_rope_head_dim
    x = np.random.default_rng(0).standard_normal((2, 5, 3, d)).astype(
        np.float32)
    pos = np.array([[0, 1, 2, 3, 4], [7, 8, 9, 10, 11]], np.int32)
    if not per_seq:
        pos = pos[0]
    cos, sin = rope_cos_sin(torch.as_tensor(pos), d, jcfg.rope_theta)
    got = mla._rope_interleaved(torch.as_tensor(x), cos, sin)
    rows = [pos[i] if per_seq else pos for i in range(2)]
    want = [jmla._rope_interleaved(jnp.asarray(x[i:i + 1]),
                                   *jrope(jnp.asarray(r), d, jcfg.rope_theta))
            for i, r in enumerate(rows)]
    _close(got, np.concatenate(want))


@pytest.mark.parametrize("fn", ["_queries", "_latents"])
def test_projections(layer, fn):
    jcfg, tcfg, jp, tp = layer
    x = _x(1, 2, 9, jcfg.d_model)
    pos = np.arange(3, 12, dtype=np.int32)
    want = jax.jit(lambda p, x, pos: getattr(jmla, fn)(jcfg, p, x, pos))(
        jp, jnp.asarray(x), jnp.asarray(pos))
    got = getattr(mla, fn)(tcfg, tp, torch.as_tensor(x), torch.as_tensor(pos))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        _close(g, w)


@pytest.mark.parametrize("s", [5, 16, 40])
def test_mla_apply(layer, s):
    """s <= q_block (16) runs attention_full, s > q_block the chunked
    path."""
    jcfg, tcfg, jp, tp = layer
    x = _x(s, 2, s, jcfg.d_model)
    pos = np.arange(s, dtype=np.int32)
    want = jax.jit(lambda p, x, pos: jmla.mla_apply(jcfg, p, x,
                                                    positions=pos))(
        jp, jnp.asarray(x), jnp.asarray(pos))
    got = mla.mla_apply(tcfg, tp, torch.as_tensor(x),
                        positions=torch.as_tensor(pos))
    _close(got, want)


def test_mla_decode_per_sequence_lengths(layer):
    """One batched absorbed decode with a cache length per sequence
    equals the reference's scalar-length decode of each sequence alone,
    output and latent cache."""
    jcfg, tcfg, jp, tp = layer
    smax, lens = 12, [3, 7, 0]
    rng = np.random.default_rng(5)
    ckv = rng.standard_normal((3, smax, jcfg.kv_lora_rank)).astype(
        np.float32)
    krope = rng.standard_normal((3, smax, jcfg.qk_rope_head_dim)).astype(
        np.float32)
    x = _x(6, 3, 1, jcfg.d_model)
    jdec = jax.jit(lambda p, x, c, n: jmla.mla_decode(jcfg, p, x, c, n))
    want_y, want_c = [], {"ckv": [], "krope": []}
    for i, n in enumerate(lens):
        y, c = jdec(jp, jnp.asarray(x[i:i + 1]),
                    {"ckv": jnp.asarray(ckv[i:i + 1]),
                     "krope": jnp.asarray(krope[i:i + 1])}, jnp.int32(n))
        want_y.append(np.asarray(y))
        for k in c:
            want_c[k].append(np.asarray(c[k]))
    cache = {"ckv": torch.as_tensor(ckv.copy()),
             "krope": torch.as_tensor(krope.copy())}
    y, out = mla.mla_decode(tcfg, tp, torch.as_tensor(x), cache,
                            torch.tensor(lens))
    assert out is cache                   # written in place
    _close(y, np.concatenate(want_y))
    for k in ("ckv", "krope"):
        _close(cache[k], np.concatenate(want_c[k]))


def test_absorbed_decode_equals_up_projected_apply(layer):
    """The two formulations are one function: decoding the last token
    against the latents of the first s - 1 gives mla_apply's last row."""
    _, tcfg, _, tp = layer
    s = 9
    x = torch.as_tensor(_x(7, 2, s, tcfg.d_model))
    pos = torch.arange(s, dtype=torch.int32)
    full = mla.mla_apply(tcfg, tp, x, positions=pos)
    cache = mla.mla_cache_init(tcfg, 2, 16)
    c_kv, k_rope = mla._latents(tcfg, tp, x[:, :-1], pos[:-1])
    cache["ckv"][:, :s - 1] = c_kv
    cache["krope"][:, :s - 1] = k_rope
    y, _ = mla.mla_decode(tcfg, tp, x[:, -1:], cache,
                          torch.full((2,), s - 1))
    np.testing.assert_allclose(y.numpy(), full[:, -1:].numpy(), **TOL)


def test_prefill_and_four_decode_steps():
    """deepseek-v3's smoke model (a dense MLA layer, two MoE MLA layers,
    the MTP params): prefill then four decode steps against the
    reference's ``prefill`` / ``decode_step``, logits and latent caches."""
    jcfg, tcfg = jsmoke(), tsmoke()
    jp = jax.jit(lambda k: jinit(k, jcfg)[0])(jax.random.PRNGKey(0))
    tp = params_from_jax(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    b, s, smax = 2, 11, 24
    toks = np.random.default_rng(3).integers(0, jcfg.vocab, (b, s)).astype(
        np.int32)
    jc = jinit_cache(jcfg, b, smax)
    tc = init_cache(tcfg, b, smax, device="cpu")
    jl, jc = jax.jit(lambda p, t, c: jprefill(jcfg, p, t, c))(
        jp, jnp.asarray(toks), jc)
    tl, tc = prefill(tcfg, tp, torch.as_tensor(toks).long(), tc)
    _close(tl, jl, MODEL_TOL)
    jstep = jax.jit(lambda p, t, c, n: jdecode(jcfg, p, t, c, n))
    for i in range(4):
        nt = np.random.default_rng(10 + i).integers(
            0, jcfg.vocab, (b, 1)).astype(np.int32)
        jl, jc = jstep(jp, jnp.asarray(nt), jc, jnp.int32(s + i))
        tl, tc = decode_step(tcfg, tp, torch.as_tensor(nt).long(), tc, s + i)
        _close(tl, jl, MODEL_TOL)
    for k in ("ckv", "krope"):
        _close(tc["prefix_0"][k], jc["prefix_0"][k], MODEL_TOL)
        _close(tc["stack"]["l0"][k], jc["stack"]["l0"][k], MODEL_TOL)
