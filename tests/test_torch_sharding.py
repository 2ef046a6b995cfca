"""Twins of tests/test_sharding_rules.py: the port's logical-axis rules
(``repro_torch.parallel.sharding``) give the reference's specs, compared
as tuples, on the same abstract meshes; plus ``_pick_chunks``, the
resident-expert plan, the per-architecture rules and cache dims of
``launch/steps.py``, and ``param_shardings`` over every architecture's
params.  Specs are data: they are held exactly."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.model import abstract_init as jabstract  # noqa: E402
from repro.models.model import init_cache as jinit_cache  # noqa: E402
from repro.parallel import sharding as js  # noqa: E402

from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.model import abstract_init as tabstract  # noqa: E402
from repro_torch.models.model import init_cache as tinit_cache  # noqa: E402
from repro_torch.parallel import sharding as ts  # noqa: E402

MESHES = {"mesh2": ((16, 16), ("data", "model")),
          "mesh3": ((2, 16, 16), ("pod", "data", "model")),
          "small": ((2, 4), ("data", "model")),
          "pipe": ((4, 2), ("pipe", "data"))}


def _meshes(name):
    shape, axes = MESHES[name]
    return js.abstract_mesh(shape, axes), ts.abstract_mesh(shape, axes)


def _spec_pair(dims, shape, mesh, rules=None):
    jm, tm = _meshes(mesh)
    jr = None if rules is None else {**js.DEFAULT_RULES, **rules}
    tr = None if rules is None else {**ts.DEFAULT_RULES, **rules}
    return (tuple(js.logical_spec(dims, shape, jm, jr)),
            tuple(ts.logical_spec(dims, shape, tm, tr)))


def test_default_rules_match_reference():
    assert ts.DEFAULT_RULES == js.DEFAULT_RULES


def test_mesh_reads_like_reference():
    jm, tm = _meshes("mesh3")
    assert tuple(tm.axis_names) == tuple(jm.axis_names)
    assert dict(tm.shape) == dict(jm.shape)
    assert tm.size == 512 and tm == ts.Mesh((2, 16, 16),
                                            ("pod", "data", "model"))


# -- the cases of tests/test_sharding_rules.py --------------------------------
@pytest.mark.parametrize("dims,shape,mesh,rules,want", [
    # batch takes pod and data; embed's data is taken -> dropped
    (("batch", None, "embed"), (256, 4096, 896), "mesh3", None,
     (("pod", "data"),)),
    # 14 q-heads cannot shard over model=16; 32 can
    (("q_heads",), (14,), "mesh2", {"q_heads": ("model",)}, ()),
    (("q_heads",), (32,), "mesh2", {"q_heads": ("model",)}, ("model",)),
    # axis prefixes: both, pod only, nothing
    (("batch",), (32,), "mesh3", None, (("pod", "data"),)),
    (("batch",), (2,), "mesh3", None, ("pod",)),
    (("batch",), (3,), "mesh3", None, ()),
    # FSDP x TP
    (("embed", "mlp"), (4096, 16384), "mesh2", None, ("data", "model")),
    (("experts", "embed", "moe_mlp"), (256, 7168, 2048), "mesh2", None,
     ("model", "data")),
    # seq wins model, vocab drops
    (("seq", "vocab"), (4096, 151936), "mesh2", None, ("model",)),
    # no shape: no divisibility filter
    (("embed", "mlp"), None, "small", None, ("data", "model")),
], ids=lambda v: str(v))
def test_logical_spec_matches_reference(dims, shape, mesh, rules, want):
    ref, port = _spec_pair(dims, shape, mesh, rules)
    assert port == ref == want


def test_rule_override_via_use_mesh():
    jm, tm = _meshes("mesh2")
    with ts.use_mesh(None):
        pass
    for s, m in ((js, jm), (ts, tm)):
        with s.use_mesh(m, {"cache_seq": ("model",)}):
            assert s.active_rules()["cache_seq"] == ("model",)
            assert tuple(s.logical_spec(("cache_batch", "cache_seq"),
                                        (32, 32768), m)) == \
                ("data", "model")
            # batch 8 cannot shard over data=16 -> dropped
            assert tuple(s.logical_spec(("cache_batch", "cache_seq"),
                                        (8, 32768), m)) == (None, "model")
        assert s.active_rules().get("cache_seq") == ()
        assert s.active_mesh() is None


def test_dp_axes():
    for name, want in (("mesh3", ("pod", "data")), ("mesh2", ("data",)),
                       ("pipe", ("data",))):
        jm, tm = _meshes(name)
        assert ts.dp_axes(tm) == js.dp_axes(jm) == want
    assert ts.ep_axis_name() == js.ep_axis_name() == "model"


def test_no_mesh_is_noop():
    ts.set_active_mesh(None)
    x = torch.ones(4, 4)
    assert ts.constrain(x, ("batch", None)) is x
    assert ts.logical_spec(("batch", None), (4, 4)) == ts.P() == ()


def test_constrain_under_mesh_changes_nothing():
    """The reference's constraint pins a layout; the port's ranks share
    one card, so its input comes back as it is."""
    _, tm = _meshes("small")
    x = torch.arange(8.0).reshape(4, 2)
    with ts.use_mesh(tm):
        assert ts.constrain(x, ("batch", "embed")) is x


def test_bound_axes_are_skipped():
    """An axis bound by ``ranks.bind_axis`` (manual in the reference's
    region) is never chosen, as the reference skips its trace's bound
    axes."""
    from repro_torch.core import ranks
    _, tm = _meshes("small")
    with ranks.bind_axis("model", 4):
        assert tuple(ts.logical_spec(("embed", "mlp"), (64, 64), tm)) == \
            ("data",)
    with ranks.bind_axis("data", 2):
        assert tuple(ts.logical_spec(("batch", "mlp"), (8, 64), tm)) == \
            (None, "model")


@pytest.mark.parametrize("s,block,tp", [
    (4672, 256, 16), (33344, 256, 16), (4096, 256, 16), (97, 16, 16),
    (1024, 256, 4), (15, 8, 4), (600, 128, 8), (1, 256, 16)])
def test_pick_chunks_matches_reference(s, block, tp):
    got = tattn._pick_chunks(s, block, tp)
    assert got == jattn._pick_chunks(s, block, tp)
    nq, bq = got
    assert nq * bq == s


def test_tp_size_reads_the_model_axis():
    _, tm = _meshes("small")
    assert tattn._tp_size() == 1
    with ts.use_mesh(tm):
        assert tattn._tp_size() == 4
    with ts.use_mesh(_meshes("pipe")[1]):
        assert tattn._tp_size() == 1


def test_pick_chunks_tp_aligned():
    nq, bq = tattn._pick_chunks(4672, 256, 16)
    assert nq % 16 == 0 and nq * bq == 4672
    nq2, bq2 = tattn._pick_chunks(33344, 256, 16)
    assert nq2 % 16 == 0 and nq2 * bq2 == 33344 and bq2 >= 64
    assert tattn._pick_chunks(4096, 256, 16) == (16, 256)
    nq3, bq3 = tattn._pick_chunks(97, 16, 16)
    assert nq3 * bq3 == 97


def test_resident_plan_budget():
    jm, tm = _meshes("mesh2")
    # dsv3: 256 experts / 256 ranks, small experts -> resident
    assert set(tmoe.resident_plan(tbase.get_config("deepseek-v3-671b"),
                                  tm)) == {"data", "model"}
    # jamba: 16 fat experts -> over budget -> stream
    assert tmoe.resident_plan(tbase.get_config("jamba-1.5-large-398b"),
                              tm) is None
    # dense arch: no experts
    assert tmoe.resident_plan(tbase.get_config("qwen2-0.5b"), tm) is None
    assert tmoe.RESIDENT_BUDGET_BYTES == jmoe.RESIDENT_BUDGET_BYTES \
        == 6 * 1024 ** 3


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", tbase.ARCH_IDS)
def test_resident_plan_and_rules_match_reference(arch, mesh):
    """``resident_axes``, ``resident_plan``, ``arch_rules`` (train and
    decode) and ``decode_rules`` of every architecture on every mesh."""
    jm, tm = _meshes(mesh)
    jc, tc = jbase.get_config(arch), tbase.get_config(arch)
    if jc.n_experts:
        assert tmoe.resident_axes(tm, tc.n_experts) == \
            jmoe.resident_axes(jm, jc.n_experts)
    assert tmoe.resident_plan(tc, tm) == jmoe.resident_plan(jc, jm)
    assert tsteps.decode_rules(tc, tm) == jsteps.decode_rules(jc, jm)
    for kind in ("train", "decode"):
        assert tsteps.arch_rules(tc, tm, kind) == \
            jsteps.arch_rules(jc, jm, kind)


def test_deepseek_cut_to_five_layers_is_resident():
    """DeepSeek-V3 cut to 5 of 61 layers (its 2 MoE layers) on the
    (data=2, model=4) mesh: 32 experts a rank, a slab of 5,637,144,576
    bytes, under the 6 GiB budget."""
    import dataclasses
    cfg = dataclasses.replace(tbase.get_config("deepseek-v3-671b"),
                              n_layers=5)
    _, tm = _meshes("small")
    assert tmoe.resident_axes(tm, cfg.n_experts) == (("model", "data"), 8)
    assert tmoe.resident_plan(cfg, tm) == ("model", "data")
    slab = 32 * 3 * cfg.d_model * cfg.moe_d_ff * 2 * 2
    assert slab == 5_637_144_576 < tmoe.RESIDENT_BUDGET_BYTES


def _ref_specs(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda t: hasattr(t, "spec"))
    return {jax.tree_util.keystr(k): tuple(v.spec) for k, v in flat}


def _port_specs(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}[{k!r}]"
        if isinstance(v, dict):
            out.update(_port_specs(v, name))
        else:
            assert isinstance(v, ts.NamedSharding)
            out[name] = tuple(v.spec)
    return out


@pytest.mark.parametrize("mesh", ["mesh2", "small"])
@pytest.mark.parametrize("arch", tbase.ARCH_IDS)
def test_param_shardings_match_reference(arch, mesh):
    """Every parameter's spec of every architecture, from the logical
    dims and full-size shapes (the port's list of periods counts as one
    stacked leaf)."""
    jm, tm = _meshes(mesh)
    jc, tc = jbase.get_config(arch), tbase.get_config(arch)
    jproto, jdims = jabstract(jc)
    tproto, tdims = tabstract(tc)
    ref = _ref_specs(js.param_shardings(jdims, jproto, jm))
    port = _port_specs(ts.param_shardings(tdims, tproto, tm))
    assert port == ref


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "deepseek-v3-671b",
                                  "mamba2-130m", "jamba-1.5-large-398b"])
def test_cache_dims_and_specs_match_reference(arch):
    """``cache_dims`` and the cache's specs under ``decode_rules``
    (sequence-sharded for qwen2's 2 KV heads and MLA's latent cache)."""
    jm, tm = _meshes("small")
    jc, tc = jbase.get_smoke_config(arch), tbase.get_smoke_config(arch)
    jproto = jax.eval_shape(lambda: jinit_cache(jc, 4, 32))
    tcaches = tinit_cache(tc, 4, 32, device="meta")
    jdims, tdims = jsteps.cache_dims(jc, jproto), \
        tsteps.cache_dims(tc, tcaches)
    assert tdims == jax.tree.map(lambda t: t, jdims,
                                 is_leaf=lambda t: isinstance(t, tuple))
    with js.use_mesh(jm, jsteps.decode_rules(jc, jm)):
        ref = _ref_specs(js.param_shardings(jdims, jproto, jm))
    with ts.use_mesh(tm, tsteps.decode_rules(tc, tm)):
        port = _port_specs(ts.param_shardings(tdims, tcaches, tm))
    assert port == ref


def test_mesh_constructors():
    m = tmesh.make_production_mesh()
    assert dict(m.shape) == {"data": 16, "model": 16}
    m3 = tmesh.make_production_mesh(multi_pod=True)
    assert m3.axis_names == ("pod", "data", "model") and m3.size == 512
    assert tmesh.make_mesh((2, 4), ("data", "model")) == \
        ts.Mesh((2, 4), ("data", "model"))
    # one device (or none: this CPU), as the reference's one JAX device
    assert tmesh.make_host_mesh() is None
    with pytest.raises(ValueError):
        ts.Mesh((2, 4), ("data",))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("b", [1, 2, 3, 4, 8, 32, 64])
def test_dp_prefix_matches_reference(mesh, b):
    """The batch spec of the context-parallel decode: the reference's
    quirk included (on a mesh with no ``pod`` axis the prefix stops at
    once, so the batch is not split)."""
    jm, tm = _meshes(mesh)
    assert tattn._dp_prefix(tm, b) == jattn._dp_prefix(jm, b)
