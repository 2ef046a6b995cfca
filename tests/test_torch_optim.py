"""The port's optimizer against the JAX package's on the same numpy
inputs: AdamW with f32 and bf16 moments over several steps, global-norm
clipping, the cosine schedule, and the int8 compression with its
error-feedback accumulator.  f32 results within 1e-6 relative (the same
f32 operations, one ``pow`` implemented twice); bf16 within one bf16
step; int8 codes equal."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import optim as jopt  # noqa: E402

from repro_torch import optim as topt  # noqa: E402
from repro_torch.models.common import tree_leaves  # noqa: E402

BF16 = 2.0 ** -8          # bf16's relative rounding step


def _tree(seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((6, 5)).astype(dtype),
            "stack": {"b": rng.standard_normal((3, 4)).astype(dtype)},
            "s": np.asarray(rng.standard_normal(()), dtype)}


def _port_tree(tree, dtype=torch.float32):
    """The same nest as tensors; ``stack`` as the port's list of periods
    (the reference stacks them along dim 0)."""
    out = {k: torch.tensor(v, dtype=dtype) for k, v in tree.items()
           if k != "stack"}
    out["stack"] = [{"b": torch.tensor(r, dtype=dtype)}
                    for r in tree["stack"]["b"]]
    return out


def _np(tree):
    d = {k: v.float().numpy() for k, v in tree.items() if k != "stack"}
    d["stack"] = {"b": np.stack([p["b"].float().numpy()
                                 for p in tree["stack"]])}
    return d


def _close(got, want, rtol):
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(np.asarray(g, np.float32),
                                   np.asarray(w, np.float32), rtol=rtol,
                                   atol=rtol * 1e-3)


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_adamw_steps_match_reference(moments):
    """Four AdamW steps with the cosine schedule's learning rates and
    weight decay, f32 params: params and moments, and the step count.
    bf16 moments are rounded each step as the reference rounds them."""
    jdt = jnp.float32 if moments == "float32" else jnp.bfloat16
    tdt = getattr(torch, moments)
    p0 = _tree(0)
    jp, tp = jax.tree.map(jnp.asarray, p0), _port_tree(p0)
    js, ts = jopt.adamw_init(jp, jdt), topt.adamw_init(tp, tdt)
    assert all(t.dtype == tdt for t in tree_leaves(ts.m))
    jlr, tlr = jopt.cosine_schedule(0.1, 2, 6), topt.cosine_schedule(0.1, 2,
                                                                     6)
    for i in range(4):
        g = _tree(10 + i)
        jp, js = jopt.adamw_update(jp, jax.tree.map(jnp.asarray, g), js,
                                   lr=jlr(js.step), weight_decay=0.1)
        tp, ts = topt.adamw_update(tp, _port_tree(g), ts, lr=tlr(ts.step),
                                   weight_decay=0.1)
    assert int(ts.step) == int(js.step) == 4
    assert ts.step.dtype == torch.int32
    rtol = 1e-6 if moments == "float32" else 2 * BF16
    _close(_np(tp), jp, 1e-5 if moments == "float32" else 1e-2)
    _close(_np(ts.m), js.m, rtol)
    _close(_np(ts.v), js.v, rtol)


@pytest.mark.parametrize("chunk", [1, 7, 12])
def test_adamw_update_in_chunks_equals_whole_leaves(monkeypatch, chunk):
    """The update passes over each leaf in blocks of rows of at most
    ``UPDATE_CHUNK`` elements (one row where a row is larger: 1 and 7 split
    ``w``'s rows of 5, 12 takes two rows a block, a 0-d leaf stays whole);
    the arithmetic is elementwise, so four steps give the whole-leaf
    update's params and moments bit for bit, and the reference's within
    the bounds above."""
    p0 = _tree(0)
    runs = []
    for size in (chunk, 1 << 30):
        monkeypatch.setattr(topt.adamw, "UPDATE_CHUNK", size)
        tp = _port_tree(p0)
        ts = topt.adamw_init(tp, torch.bfloat16)
        lr = topt.cosine_schedule(0.1, 2, 6)
        for i in range(4):
            tp, ts = topt.adamw_update(tp, _port_tree(_tree(10 + i)), ts,
                                       lr=lr(ts.step), weight_decay=0.1)
        runs.append([tp, ts.m, ts.v])
    for got, want in zip(*runs):
        for g, w in zip(tree_leaves(got), tree_leaves(want)):
            assert torch.equal(g, w)
    jp = jax.tree.map(jnp.asarray, p0)
    js = jopt.adamw_init(jp, jnp.bfloat16)
    jlr = jopt.cosine_schedule(0.1, 2, 6)
    for i in range(4):
        jp, js = jopt.adamw_update(jp, jax.tree.map(jnp.asarray,
                                                    _tree(10 + i)), js,
                                   lr=jlr(js.step), weight_decay=0.1)
    _close(_np(runs[0][0]), jp, 1e-2)
    _close(_np(runs[0][1]), js.m, 2 * BF16)


def test_adamw_bf16_params_stay_bf16():
    p = {"w": torch.ones(8, dtype=torch.bfloat16)}
    s = topt.adamw_init(p, torch.bfloat16)
    new, _ = topt.adamw_update(p, {"w": torch.ones(8, dtype=torch.bfloat16)},
                               s, lr=torch.tensor(0.1))
    assert new["w"].dtype == torch.bfloat16 and new["w"] is p["w"]
    jnew, _ = jopt.adamw_update({"w": jnp.ones(8, jnp.bfloat16)},
                                {"w": jnp.ones(8, jnp.bfloat16)},
                                jopt.adamw_init({"w": jnp.ones(8, jnp.bfloat16)},
                                                jnp.bfloat16),
                                lr=jnp.float32(0.1))
    np.testing.assert_array_equal(new["w"].float().numpy(),
                                  np.asarray(jnew["w"], np.float32))


@pytest.mark.parametrize("max_norm", [1.0, 100.0], ids=["clipped",
                                                          "under"])
def test_clip_by_global_norm_matches_reference(max_norm):
    g = _tree(3)
    jc, jn = jopt.clip_by_global_norm(jax.tree.map(jnp.asarray, g),
                                      max_norm)
    tc, tn = topt.clip_by_global_norm(_port_tree(g), max_norm)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    np.testing.assert_allclose(float(topt.global_norm(tc)),
                               float(jopt.global_norm(jc)), rtol=1e-6)
    _close(_np(tc), jc, 1e-6)


def test_cosine_schedule_matches_reference():
    j, t = jopt.cosine_schedule(3e-4, 10, 110), topt.cosine_schedule(
        3e-4, 10, 110)
    for step in (0, 1, 5, 9, 10, 11, 37, 60, 109, 110, 200):
        np.testing.assert_allclose(
            float(t(torch.tensor(step, dtype=torch.int32))),
            float(j(jnp.int32(step))), rtol=1e-6, atol=1e-12,
            err_msg=str(step))


def test_compress_int8_matches_reference():
    """Codes and scale equal; halves round to even as ``jnp.round``."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal(1000).astype(np.float32)
    x[:4] = [127.0, 0.5, 1.5, -2.5]        # scale 1: .5 ties round to even
    jq, js = jopt.compress_int8(jnp.asarray(x))
    tq, ts = topt.compress_int8(torch.tensor(x))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert tq[1:4].tolist() == [0, 2, -2]
    assert float(ts) == float(js)
    np.testing.assert_array_equal(
        topt.decompress_int8(tq, ts).numpy(),
        np.asarray(jopt.decompress_int8(jq, js)))


def test_compressed_accumulator_matches_reference():
    """Three microbatches through the int8 + error-feedback accumulator:
    codes, scales and residuals, and the mean it returns."""
    j = jopt.CompressedAccumulator
    t = topt.CompressedAccumulator
    p = _tree(0)
    ja, ta = j.init(jax.tree.map(jnp.asarray, p)), t.init(_port_tree(p))
    for i in range(3):
        g = _tree(20 + i)
        ja = j.add(ja, jax.tree.map(jnp.asarray, g))
        ta = t.add(ta, _port_tree(g))
    for key in ("w", "s"):
        np.testing.assert_array_equal(ta[key]["q"].numpy(),
                                      np.asarray(ja[key]["q"]))
        np.testing.assert_allclose(float(ta[key]["scale"]),
                                   float(ja[key]["scale"]), rtol=1e-6)
        np.testing.assert_allclose(ta[key]["err"].numpy(),
                                   np.asarray(ja[key]["err"]), atol=1e-6)
    _close(_np(t.value(ta, 3)), j.value(ja, 3), 1e-6)


@pytest.mark.parametrize("n_ranks,width", [(2, 4), (4, 33), (8, 64),
                                           (3, 7)])
@pytest.mark.parametrize("feedback", [False, True])
def test_compressed_psum_matches_reference(n_ranks, width, feedback):
    """The reference's ``compressed_psum`` under ``jax.vmap(axis_name=
    "dp")`` against the port's on the rank-stacked ``[n, width]`` under
    ``ranks.bind_axis``: the mean on every rank and each rank's residual
    equal (the same f32 operations on the same int8 codes and int32 sum),
    and the mean within the shared grid's half step, ``scale / 2``, of the
    exact one (tests/test_property.py's bound)."""
    from repro_torch.core import ranks
    rng = np.random.default_rng(n_ranks * 100 + width)
    xs = rng.standard_normal((n_ranks, width)).astype(np.float32)
    err = (rng.standard_normal((n_ranks, width)) * 1e-3).astype(np.float32) \
        if feedback else np.zeros_like(xs)
    jout, jerr = jax.vmap(lambda x, e: jopt.compressed_psum(x, "dp", e),
                          axis_name="dp")(jnp.asarray(xs), jnp.asarray(err))
    with ranks.bind_axis("dp", n_ranks):
        tout, terr = topt.compressed_psum(torch.from_numpy(xs), "dp",
                                          torch.from_numpy(err))
    assert tout.shape == xs.shape and terr.dtype == torch.float32
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(terr.numpy(), np.asarray(jerr))
    scale = np.abs(xs + err).max() / 127.0
    exact = (xs + err).mean(0)
    assert np.abs(tout.numpy() - exact).max() <= scale / 2 + 1e-7
    with pytest.raises(ValueError):
        with ranks.bind_axis("dp", n_ranks + 1):
            topt.compressed_psum(torch.from_numpy(xs), "dp")
