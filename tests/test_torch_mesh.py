"""Twins of the reference's mesh branches under its own mesh: the
context-parallel decode (attention and MLA), the resident-expert decode,
expert parallelism through ``moe_apply`` (both of ``_moe_ep``'s
branches), and the training loss and its gradients through ``_moe_ep``.

The reference runs once for the file in a subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=8`` on a
``(data=2, model=4)`` mesh, as ``tests/test_multidevice.py`` does, and
writes its outputs to an ``.npz``; the port runs the same params (the
reference's, carried over) and numpy-seeded inputs on its rank-stacked
mesh.  Each test also checks that the port took the mesh branch.

Tolerances: decode logits and caches within 1e-4 (the reference's own,
``tests/test_multidevice.py``), the expert-parallel MoE and the loss
within 5e-5 (ibid.), the gradients within 1e-4 (ibid., its pipeline's
gradients), all float32 summed in another order."""
import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.models import init_model as jinit  # noqa: E402
from repro.models.moe import moe_init as jmoe_init  # noqa: E402

from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.launch.steps import decode_rules  # noqa: E402
from repro_torch.models import (  # noqa: E402
    attention, decode_step, init_cache, mla, moe, prefill)
from repro_torch.parallel import Mesh, use_mesh  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
DECODE_TOL = dict(atol=1e-4, rtol=1e-4)
EP_TOL = dict(atol=5e-5, rtol=5e-5)
MESH = ((2, 4), ("data", "model"))

ATTN = dict(name="g", n_layers=2, d_model=64, n_heads=6, n_kv_heads=2,
            d_ff=128, vocab=97, q_block=8)
MOE = dict(name="m", family="moe", n_layers=2, d_model=64, n_heads=4,
           n_kv_heads=4, d_ff=128, vocab=97, n_experts=8,
           n_experts_per_tok=2, moe_d_ff=96, moe_backend="lcx", q_block=8)
# (name, config, B, S, Smax, ticks)
DECODE_CASES = {
    # 2 KV heads cannot split 4 ways: the cache is sequence-sharded, and
    # the two ticks write rows 15 and 16, on ranks 1 and 2
    "attn": ("attn", 4, 15, 32, 2),
    # MLA's latent cache is always sequence-sharded; its experts are
    # resident on (model, data)
    "mla": ("mla", 4, 15, 32, 2),
    # capacity(cfg, 16) = 8 < decode_capacity = 16: tokens drop
    "res16": ("res16", 16, 16, 32, 1),
}
# (name, capacity factor, S) of x [4, S, 64]: S = 16 and 64 are
# sequence-sharded over model, 61 token-sliced; at capacity factor 1.0 a
# rank's 32 or 31 tokens have capacity 8 a expert, and tokens drop
EP_CASES = (("ep16", 16.0, 16), ("epdrop", 1.0, 64), ("ep61", 1.0, 61))
# (name, capacity factor, S) of a [4, S] batch through ``loss_fn`` and its
# gradients: S = 16 sequence-sharded with tokens dropped, S = 15
# token-sliced and padded
LOSS_CASES = (("loss16", 1.0, 16), ("loss15", 16.0, 15))

REFERENCE = '''
import dataclasses, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.compat import make_mesh
from repro.configs.base import ModelConfig, get_smoke_config
from repro.launch.steps import cache_dims, decode_rules
from repro.models import decode_step, init_cache, init_model, prefill
from repro.models.model import abstract_init
from repro.models.model import loss_fn
from repro.models.moe import moe_apply, moe_init
from repro.parallel.sharding import param_shardings, use_mesh
mesh = make_mesh({mesh_shape}, {mesh_axes})
f32 = dict(dtype=jnp.float32, param_dtype=jnp.float32)
out = {{}}


def decode_case(name, cfg, B, S, SMAX, ticks):
    ref_cfg = (dataclasses.replace(cfg, moe_backend="sort")
               if cfg.n_experts else cfg)
    params = jax.jit(lambda k: init_model(k, cfg)[0])(jax.random.PRNGKey(0))
    dims = abstract_init(cfg)[1]
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (B, S))
    caches = init_cache(cfg, B, SMAX)
    lg, caches = jax.jit(lambda p, t, c: prefill(ref_cfg, p, t, c))(
        params, jnp.asarray(toks, jnp.int32), caches)
    nxt = jnp.argmax(lg[:, -1], -1)[:, None].astype(jnp.int32)
    with use_mesh(mesh, decode_rules(cfg, mesh)):
        ps = param_shardings(dims, params, mesh)
        cproto = jax.eval_shape(lambda: init_cache(cfg, B, SMAX))
        cs = param_shardings(cache_dims(cfg, cproto), cproto, mesh)
        tok_s = NamedSharding(mesh, P("data", None))
        step = jax.jit(lambda p, t, c, l: decode_step(cfg, p, t, c, l),
                       in_shardings=(ps, tok_s, cs,
                                     NamedSharding(mesh, P())),
                       out_shardings=(None, cs))
        p_s, c_s = jax.device_put(params, ps), jax.device_put(caches, cs)
        for i in range(ticks):
            got, c_s = step(p_s, jax.device_put(nxt, tok_s), c_s,
                            jnp.int32(S + i))
            out[f"{{name}}_logits{{i}}"] = np.asarray(got)
            nxt = jnp.argmax(got[:, -1], -1)[:, None].astype(jnp.int32)
    flat, _ = jax.tree_util.tree_flatten_with_path(c_s)
    for k, v in flat:
        out[f"{{name}}_cache" + jax.tree_util.keystr(k)] = np.asarray(v)


configs = {{
    "attn": ModelConfig(**{attn}, **f32),
    "mla": dataclasses.replace(get_smoke_config("deepseek-v3-671b"),
                               moe_backend="lcx"),
    "res16": ModelConfig(**{moe}, capacity_factor=1.0,
                         n_shared_experts=1, **f32),
}}
for name, (cfg_name, B, S, SMAX, ticks) in {decode_cases}.items():
    decode_case(name, configs[cfg_name], B, S, SMAX, ticks)

ep = ModelConfig(**{moe}, capacity_factor=16.0, **f32)
mp, _ = moe_init(jax.random.PRNGKey(3), ep)
for name, cf, S in {ep_cases}:
    c = dataclasses.replace(ep, capacity_factor=cf)
    x = np.random.default_rng(2).standard_normal((4, S, 64)).astype(
        np.float32)
    with use_mesh(mesh):
        y, aux = jax.jit(lambda p, x: moe_apply(c, p, x))(mp, jnp.asarray(x))
    out[name + "_y"], out[name + "_aux"] = np.asarray(y), np.asarray(aux)

for name, cf, S in {loss_cases}:
    c = ModelConfig(**{moe}, capacity_factor=cf, **f32)
    lp = jax.jit(lambda k: init_model(k, c)[0])(jax.random.PRNGKey(4))
    ldims = abstract_init(c)[1]
    toks = np.random.default_rng(3).integers(0, c.vocab, (4, S))
    batch = {{"tokens": jnp.asarray(toks, jnp.int32),
              "labels": jnp.asarray(np.roll(toks, -1, 1), jnp.int32)}}
    with use_mesh(mesh):
        ps = param_shardings(ldims, lp, mesh)
        bs = NamedSharding(mesh, P("data", None))
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p, b: loss_fn(c, p, b)[0]))(jax.device_put(lp, ps),
                                               jax.device_put(batch, bs))
    out[name + "_loss"] = np.asarray(loss)
    for k, v in jax.tree_util.tree_flatten_with_path(grads)[0]:
        out[name + "_grad" + jax.tree_util.keystr(k)] = np.asarray(v)
np.savez(sys.argv[1], **out)
'''


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's outputs under its 8-device mesh (one subprocess,
    ~30 s)."""
    d = tmp_path_factory.mktemp("mesh")
    script = d / "reference.py"
    script.write_text(textwrap.dedent(REFERENCE).format(
        mesh_shape=MESH[0], mesh_axes=MESH[1], attn=ATTN, moe=MOE,
        decode_cases=DECODE_CASES, ep_cases=EP_CASES,
        loss_cases=LOSS_CASES))
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = str(SRC) + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, str(script), str(d / "ref.npz")],
                         capture_output=True, text=True, env=env,
                         timeout=600)
    assert out.returncode == 0, f"STDOUT:\n{out.stdout}\nERR:\n{out.stderr}"
    return dict(np.load(d / "ref.npz"))


def _cfgs(name):
    """(the reference's config, the port's) of a decode case."""
    f32j = dict(dtype=jnp.float32, param_dtype=jnp.float32)
    f32t = dict(dtype=torch.float32, param_dtype=torch.float32)
    if name == "mla":
        return (dataclasses.replace(
                    jbase.get_smoke_config("deepseek-v3-671b"),
                    moe_backend="lcx"),
                dataclasses.replace(
                    tbase.get_smoke_config("deepseek-v3-671b"),
                    moe_backend="lcx"))
    if name == "attn":
        return jbase.ModelConfig(**ATTN, **f32j), \
            tbase.ModelConfig(**ATTN, **f32t)
    kw = dict(capacity_factor=1.0, n_shared_experts=1)
    return jbase.ModelConfig(**MOE, **kw, **f32j), \
        tbase.ModelConfig(**MOE, **kw, **f32t)


def _counting(monkeypatch, module, name):
    """Count the calls of ``module.name`` (looked up at call time)."""
    calls = []
    fn = getattr(module, name)

    def counted(*a, **kw):
        calls.append(1)
        return fn(*a, **kw)

    monkeypatch.setattr(module, name, counted)
    return calls


def _port_caches(tree, prefix="", tensors=False):
    """{keystr name: array (or the tensor)} of the port's caches, under
    the reference's names."""
    out = {}
    for k, v in tree.items():
        name = f"{prefix}[{k!r}]"
        if isinstance(v, dict):
            out.update(_port_caches(v, name, tensors))
        else:
            out[name] = v if tensors else v.numpy().copy()
    return out


@pytest.mark.parametrize("case", list(DECODE_CASES))
def test_sharded_decode_matches_reference_mesh(case, ref, monkeypatch):
    """Prefill with no mesh, then decode ticks under the (data=2,
    model=4) mesh with ``decode_rules``: the logits of every tick and the
    caches after them within 1e-4 of the reference's, the greedy tokens
    equal, and the port took each mesh branch the case names."""
    _, B, S, SMAX, ticks = DECODE_CASES[case]
    jcfg, tcfg = _cfgs(case)
    jp = jax.jit(lambda k: jinit(k, jcfg)[0])(jax.random.PRNGKey(0))
    params = params_from_jax(tcfg, jax.tree.map(np.asarray, jp),
                             device="cpu")
    toks = np.random.default_rng(1).integers(0, tcfg.vocab, (B, S))
    sort_cfg = (dataclasses.replace(tcfg, moe_backend="sort")
                if tcfg.n_experts else tcfg)
    caches = init_cache(tcfg, B, SMAX, device="cpu")
    lg, caches = prefill(sort_cfg, params, torch.as_tensor(toks), caches)
    nxt = lg[:, -1].argmax(-1)[:, None]
    branches = {"attn": [(attention, "attn_decode_sharded")],
                "mla": [(mla, "_mla_decode_sharded"),
                        (moe, "_moe_resident_decode")],
                "res16": [(moe, "_moe_resident_decode")]}[case]
    calls = [_counting(monkeypatch, m, f) for m, f in branches]
    mesh = Mesh(*MESH)
    with use_mesh(mesh, decode_rules(tcfg, mesh)):
        for i in range(ticks):
            got, caches = decode_step(tcfg, params, nxt, caches, S + i)
            want = ref[f"{case}_logits{i}"]
            np.testing.assert_allclose(got.numpy(), want, **DECODE_TOL)
            nxt = got[:, -1].argmax(-1)[:, None]
            assert np.array_equal(nxt.numpy()[:, 0],
                                  want[:, -1].argmax(-1))
    n_layers = {"attn": 2, "mla": 3, "res16": 2}[case]
    n_moe = {"attn": 0, "mla": 2, "res16": 2}[case]
    for (m, f), c in zip(branches, calls):
        per_tick = n_moe if f == "_moe_resident_decode" else n_layers
        assert len(c) == per_tick * ticks, (f, len(c))
    port = _port_caches(caches)
    for name, want in ref.items():
        if name.startswith(f"{case}_cache"):
            np.testing.assert_allclose(port[name[len(case) + 6:]], want,
                                       **DECODE_TOL)


def test_resident_decode_routes_all_tokens_at_capacity():
    """At B = 16 and capacity factor 1.0 the mesh's resident decode uses
    ``capacity(cfg, 16)`` = 8, not ``decode_capacity`` = 16, as the
    reference's mesh path does: it equals the sort path at that capacity
    bit for bit, and differs from the meshless decode, which drops
    nothing."""
    _, tcfg = _cfgs("res16")
    tcfg = dataclasses.replace(tcfg, n_shared_experts=0)
    assert moe.capacity(tcfg, 16) == 8 < moe.decode_capacity(tcfg, 16)
    gen = torch.Generator().manual_seed(0)
    p = moe.moe_init(gen, tcfg, torch.device("cpu"))
    # tokens alike, so they choose alike and overflow capacity 8
    x = torch.randn(1, 1, tcfg.d_model, generator=gen) \
        + 0.1 * torch.randn(16, 1, tcfg.d_model, generator=gen)
    ids = moe.route(tcfg, p["router"], x[:, 0])[0]
    assert int(torch.bincount(ids.reshape(-1)).max()) > 8
    mesh = Mesh(*MESH)
    with use_mesh(mesh, decode_rules(tcfg, mesh)):
        y, _ = moe.moe_apply(tcfg, p, x, decode=True)
    sort, _ = moe._moe_sort_local(tcfg, p, x[:, 0])
    assert torch.equal(y[:, 0], sort)
    meshless, _ = moe.moe_apply(tcfg, p, x, decode=True)
    assert not torch.allclose(y, meshless)


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


@pytest.mark.parametrize("lengths", [[3, 8, 17, 31], [0, 7, 8, 32]])
@pytest.mark.parametrize("case", ["attn", "mla"])
def test_sharded_decode_takes_per_sequence_lengths(case, lengths):
    """Each sequence has its own length, so its own owning shard: the
    context-parallel decode gives the meshless decode's logits and cache
    rows (within 1e-5) for every sequence in range; a length at ``Smax``
    writes no row under the mesh (the reference's in-range test), where
    the meshless decode clamps it to the last row."""
    from repro_torch.models import init_model
    _, tcfg = _cfgs(case)
    gen = torch.Generator().manual_seed(5)
    params = init_model(gen, tcfg, device="cpu")
    SMAX = 32
    caches = init_cache(tcfg, 4, SMAX, device="cpu")
    for t in _port_caches(caches, tensors=True).values():
        t.copy_(torch.randn(t.shape, generator=gen))
    before = _clone(caches)
    plain = _clone(caches)
    toks = torch.randint(0, tcfg.vocab, (4, 1), generator=gen)
    lens = torch.tensor(lengths)
    want, plain = decode_step(tcfg, params, toks, plain, lens)
    mesh = Mesh(*MESH)
    with use_mesh(mesh, decode_rules(tcfg, mesh)):
        got, caches = decode_step(tcfg, params, toks, caches, lens)
    ok = (lens < SMAX).numpy()
    np.testing.assert_allclose(got.numpy()[ok], want.numpy()[ok],
                               atol=1e-5, rtol=1e-5)
    before, plain = _port_caches(before), _port_caches(plain)
    for name, ours in _port_caches(caches).items():
        ax = 1 if name.startswith("['stack']") else 0
        o, t, b = (np.moveaxis(a, ax, 0) for a in
                   (ours, plain[name], before[name]))
        np.testing.assert_allclose(o[ok], t[ok], atol=1e-5, rtol=1e-5)
        assert np.array_equal(o[~ok], b[~ok]), name


@pytest.mark.parametrize("name,cf,S", EP_CASES)
def test_moe_ep_through_moe_apply_matches_reference_mesh(name, cf, S, ref,
                                                         monkeypatch):
    """``moe_apply`` with the ``lcx`` backend under the mesh takes
    ``_moe_ep``: sequence-sharded over ``model`` (S = 16, 64) or
    token-sliced and padded (S = 61), the batch split over ``data``.
    Output within 5e-5 and the aux loss within 1e-6 of the reference's
    under its mesh.  At capacity factor 1.0 tokens drop, and the
    data-axis split matters: each rank's capacity counts its own tokens,
    and a mesh with no data axis gives another result."""
    jc = jbase.ModelConfig(**MOE, capacity_factor=cf, dtype=jnp.float32,
                           param_dtype=jnp.float32)
    tc = tbase.ModelConfig(**MOE, capacity_factor=cf, dtype=torch.float32,
                           param_dtype=torch.float32)
    mp, _ = jmoe_init(jax.random.PRNGKey(3), jc)
    p = jax.tree.map(lambda a: torch.from_numpy(np.asarray(a)), mp)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (4, S, 64)).astype(np.float32))
    calls = _counting(monkeypatch, moe, "_moe_ep")
    with use_mesh(Mesh(*MESH)):
        y, aux = moe.moe_apply(tc, p, x)
    assert len(calls) == 1
    np.testing.assert_allclose(y.numpy(), ref[name + "_y"], **EP_TOL)
    np.testing.assert_allclose(float(aux), float(ref[name + "_aux"]),
                               atol=1e-6, rtol=1e-6)
    if name == "epdrop":
        # rank (data 0, model 0) holds x[:2, :16]: 32 tokens, capacity 8
        ids = moe.route(tc, p["router"], x[:2, :16].reshape(-1, 64))[0]
        assert int(torch.bincount(ids.reshape(-1)).max()) > \
            moe.capacity(tc, 32) == 8
        with use_mesh(Mesh((4,), ("model",))):
            y1, _ = moe.moe_apply(tc, p, x)
        assert not np.allclose(y1.numpy(), ref[name + "_y"], atol=1e-3)


@pytest.mark.parametrize("name,cf,S", LOSS_CASES)
def test_loss_grads_through_moe_ep_match_reference_mesh(name, cf, S, ref,
                                                        monkeypatch):
    """``loss_fn`` of an ``lcx`` MoE model under the (data=2, model=4)
    mesh trains through ``_moe_ep`` in every MoE layer: the loss within
    5e-5 and every gradient, leaf for leaf, within 1e-4 of the
    reference's ``jax.value_and_grad(loss_fn)`` under its mesh, at a
    capacity that drops tokens (S = 16) and on the token-sliced branch
    (S = 15).  The gradient is taken after the mesh's block has closed,
    so the rematerialised periods must recompute under the forward's
    mesh."""
    from repro_torch.models import loss_fn
    from repro_torch.models.common import (keyed_leaves, tree_leaves,
                                           tree_unflatten)
    jc = jbase.ModelConfig(**MOE, capacity_factor=cf, dtype=jnp.float32,
                           param_dtype=jnp.float32)
    tc = tbase.ModelConfig(**MOE, capacity_factor=cf, dtype=torch.float32,
                           param_dtype=torch.float32)
    jp = jax.jit(lambda k: jinit(k, jc)[0])(jax.random.PRNGKey(4))
    params = params_from_jax(tc, jax.tree.map(np.asarray, jp),
                             device="cpu")
    toks = np.random.default_rng(3).integers(0, tc.vocab, (4, S))
    batch = {"tokens": torch.as_tensor(toks),
             "labels": torch.as_tensor(np.roll(toks, -1, 1))}
    calls = _counting(monkeypatch, moe, "_moe_ep")
    leaves = list(tree_leaves(params))
    for t in leaves:
        t.requires_grad_(True)
    with use_mesh(Mesh(*MESH)):
        loss = loss_fn(tc, params, batch)[0]
    assert len(calls) == tc.n_layers
    # outside the mesh's block: remat "full" recomputes each period in the
    # backward under the mesh of its forward, through _moe_ep again
    assert tc.remat == "full"
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    assert len(calls) == 2 * tc.n_layers
    np.testing.assert_allclose(float(loss), float(ref[name + "_loss"]),
                               **EP_TOL)
    gtree = tree_unflatten(params, list(grads))
    port = {k: (torch.stack(t) if isinstance(t, list) else t).numpy()
            for k, t in keyed_leaves(gtree)}
    want = {k[len(name) + 5:]: v for k, v in ref.items()
            if k.startswith(name + "_grad")}
    assert set(port) == set(want)
    for k in port:
        np.testing.assert_allclose(port[k], want[k], atol=1e-4, rtol=1e-4,
                                   err_msg=k)
