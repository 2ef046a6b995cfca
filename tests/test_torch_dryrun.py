"""The port's dry run against the reference's: the shape cells, the step
bundles (prototype shapes and dtypes, donation and every argument's
``PartitionSpec``), the counted per-device matmul FLOPs, the collective
cost model and ``model_flops``; the walker on analytically known
programs (as ``tests/test_roofline.py`` holds the reference's HLO
walker); and ``run_cell`` end to end.

The reference runs once for the file in a subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=8`` on a
``(data=2, model=4)`` mesh (as ``tests/test_torch_mesh.py``), lowers and
compiles each bundle and reports its input shardings and
``hlo_walk.walk(compiled.as_text()).flops``.  The port builds the same
bundles with prototypes on ``meta`` and counts them with
``analysis.hlo_walk.walk``.

Tolerances (per-device matmul FLOPs, smoke configs at S = 64, a multiple
of ``q_block`` = 16):

- prefill within 2% on (data=2, model=4);
- decode within 2% on (data=2, model=4) and on (data=8, model=1).  On
  (2, 4) the reference repeats work on several devices: its
  context-parallel decode attention (a ``shard_map`` over ``model``)
  runs on both data ranks, and the output projection after it on all
  four model ranks.  The walker counts both so (the bound region and
  ``ranks.replicated``); counted as a balanced share they would give
  73% of the reference's count for the dense and VLM configs;
- train within 3%: both recompute each period's forward under remat,
  and XLA's own rematerialization may keep or drop a dot that the
  eager step recomputes (measured: at most 1.3%, qwen3-moe).
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.analysis import roofline as jroofline  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro.models import abstract_init as jabstract  # noqa: E402

from repro_torch.analysis import roofline  # noqa: E402
from repro_torch.analysis.hlo_walk import walk  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.core import ranks  # noqa: E402
import repro_torch.core as lcx  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.steps import StepBundle, build_bundle  # noqa: E402
from repro_torch.models import abstract_init  # noqa: E402
from repro_torch.optim import AdamWState  # noqa: E402
from repro_torch.parallel import Mesh, NamedSharding  # noqa: E402
from repro_torch.parallel import PartitionSpec as P  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
FAMILIES = {"dense": "qwen2-0.5b", "moe": "qwen3-moe-30b-a3b",
            "mla": "deepseek-v3-671b", "hybrid": "jamba-1.5-large-398b",
            "vlm": "llava-next-mistral-7b", "audio": "hubert-xlarge"}
KINDS = {"dense": ("train", "prefill", "decode"),
         "moe": ("train", "prefill", "decode"),
         "mla": ("prefill", "decode"), "hybrid": ("prefill", "decode"),
         "vlm": ("prefill", "decode"), "audio": ("prefill",)}
S, B, Q_BLOCK = 64, 4, 16
MESH = ((2, 4), ("data", "model"))
DATA_MESH = ((8, 1), ("data", "model"))
PREFILL_TOL, DECODE_TOL, TRAIN_TOL = 0.02, 0.02, 0.03

REFERENCE = '''
import dataclasses, json, sys
import jax
from repro.analysis.hlo_walk import walk
from repro.compat import make_mesh
from repro.configs.base import get_smoke_config
from repro.launch.steps import arch_rules, build_bundle, cache_dims
from repro.models import abstract_init
from jax.sharding import NamedSharding
from repro.parallel.sharding import logical_spec, param_shardings, use_mesh

def spec(s):
    parts = [p if p is None or isinstance(p, str) else list(p)
             for p in s.spec]
    while parts and parts[-1] is None:
        parts.pop()
    return parts

cases, out = json.loads(sys.argv[1]), {}
for name, arch, kind, shape, batch in cases:
    mesh = make_mesh(tuple(shape), ("data", "model"))
    cfg = dataclasses.replace(get_smoke_config(arch), q_block=%(q)d)
    with use_mesh(mesh, arch_rules(cfg, mesh, kind)):
        b = build_bundle(cfg, mesh, kind, %(s)d, batch)
        c = b.fn.lower(*b.args).compile()
        # the params', tokens' and caches' shardings as the builder
        # makes them: the compiled step reports None for an input it
        # never reads (MTP's params in prefill, audio's tokens)
        proto, dims = abstract_init(cfg)
        built = {"[0]": param_shardings(dims, proto, mesh)}
        if kind != "train":
            built["[1]"] = NamedSharding(mesh, logical_spec(
                ("batch", None), b.args[1].shape, mesh))
        if kind != "train" and b.donate:
            i = b.donate[0]
            built[f"[{i}]"] = param_shardings(
                cache_dims(cfg, b.args[i]), b.args[i], mesh)
    rec = {"flops": walk(c.as_text()).flops, "donate": list(b.donate)}
    if shape == [2, 4]:
        flat = jax.tree_util.tree_flatten_with_path
        key = jax.tree_util.keystr
        rec["args"] = {key(k): [list(a.shape), str(a.dtype)]
                       for k, a in flat(b.args)[0]}
        built = {pre + key(k): s for pre, tree in built.items()
                 for k, s in flat(tree)[0]}
        got = flat(c.input_shardings[0], is_leaf=lambda x: x is None)[0]
        rec["specs"] = {key(k): spec(s or built[key(k)]) for k, s in got}
    out[name] = rec
json.dump(out, open(sys.argv[2], "w"))
''' % {"q": Q_BLOCK, "s": S}


def _cases():
    out = []
    for fam, arch in FAMILIES.items():
        for kind in KINDS[fam]:
            out.append((f"{fam}/{kind}", arch, kind, list(MESH[0]), B))
            if kind == "decode":
                out.append((f"{fam}/{kind}/data", arch, kind,
                            list(DATA_MESH[0]), 8))
    return out


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("dryrun") / "reference.json"
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(REFERENCE),
                        json.dumps(_cases()), str(path)], env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads(path.read_text())


def _bundle(fam, kind, mesh=MESH, batch=B):
    cfg = dataclasses.replace(tbase.get_smoke_config(FAMILIES[fam]),
                              q_block=Q_BLOCK)
    return build_bundle(cfg, Mesh(*mesh), kind, S, batch)


def _named(tree, prefix):
    """(reference name, leaf) pairs of a bundle's argument or sharding
    tree: the port's ``params["stack"]`` list as one stacked leaf."""
    if isinstance(tree, (torch.Tensor, NamedSharding)):
        yield prefix, tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _named(tree[k], f"{prefix}[{k!r}]")
    elif isinstance(tree, list):
        per = [list(_named(t, prefix)) for t in tree]
        for i, (name, _) in enumerate(per[0]):
            yield name, [p[i][1] for p in per]
    elif isinstance(tree, AdamWState):
        for i, f in enumerate(dataclasses.fields(tree)):
            yield from _named(getattr(tree, f.name),
                              f"{prefix}[<flat index {i}>]")
    else:
        raise TypeError(f"{prefix}: {type(tree)}")


def _spec(s):
    if isinstance(s, list):
        s = s[0]
    return [p if p is None or isinstance(p, str) else list(p)
            for p in s.spec]


def _proto(t):
    if isinstance(t, list):
        return [[len(t)] + list(t[0].shape), str(t[0].dtype)[6:]]
    return [list(t.shape), str(t.dtype)[6:]]


def test_cells_equal_reference():
    assert tbase.cells() == jbase.cells()
    assert len(tbase.cells()) == 31
    assert tbase.SHAPES == jbase.SHAPES
    assert tbase.LONG_OK == jbase.LONG_OK
    assert tbase.ENCODER_ONLY == jbase.ENCODER_ONLY


@pytest.mark.parametrize("case", [f"{f}/{k}" for f in FAMILIES
                                  for k in KINDS[f]])
def test_bundle_matches_reference(reference, case):
    """Every prototype's shape and dtype (on ``meta``), the donated
    arguments and every argument's ``PartitionSpec`` (for an input the
    compiled step never reads, MTP's params in prefill or audio's
    tokens, the one the reference's builder makes)."""
    fam, kind = case.split("/")
    want = reference[case]
    b = _bundle(fam, kind)
    assert isinstance(b, StepBundle) and list(b.donate) == want["donate"]
    assert len(b.shardings) == len(b.args)
    args = {n: t for i, a in enumerate(b.args)
            for n, t in _named(a, f"[{i}]")}
    for t in args.values():
        assert (t[0] if isinstance(t, list) else t).device.type == "meta"
    assert {n: _proto(t) for n, t in args.items()} == want["args"]
    specs = {n: _spec(s) for i, s in enumerate(b.shardings)
             for n, s in _named(s, f"[{i}]")}
    assert specs == want["specs"]


def _port_flops(fam, kind, mesh=MESH, batch=B):
    b = _bundle(fam, kind, mesh, batch)
    return walk(b.fn, *b.args, ranks=b.mesh.size,
                shardings=b.shardings).flops


@pytest.mark.parametrize("case", [f"{f}/{k}" for f in FAMILIES
                                  for k in KINDS[f]])
def test_counted_flops_match_reference_walk(reference, case):
    fam, kind = case.split("/")
    got, want = _port_flops(fam, kind), reference[case]["flops"]
    if kind == "prefill":
        assert got == pytest.approx(want, rel=PREFILL_TOL)
    elif kind == "train":
        assert got == pytest.approx(want, rel=TRAIN_TOL)
    else:
        assert got == pytest.approx(want, rel=DECODE_TOL)
        got = _port_flops(fam, kind, DATA_MESH, 8)
        assert got == pytest.approx(reference[case + "/data"]["flops"],
                                    rel=DECODE_TOL)


@pytest.mark.parametrize("kind", ["all-gather", "reduce-scatter",
                                  "all-reduce", "all-to-all",
                                  "collective-permute", "other"])
def test_wire_equals_reference(kind):
    for nbytes in (0, 4, 4096, 12345):
        for g in (1, 2, 3, 16):
            assert roofline._wire(kind, nbytes, g) == \
                jroofline._wire(kind, nbytes, g)


@pytest.mark.parametrize("arch", sorted(FAMILIES.values())
                         + ["mamba2-130m"])
def test_model_flops_equal_reference(arch):
    jcfg, tcfg = jbase.get_config(arch), tbase.get_config(arch)
    jproto = jax.eval_shape(lambda: jabstract(jcfg)[0])
    tproto, _ = abstract_init(tcfg)
    for kind, s, b in (("train", 4096, 256), ("prefill", 32768, 32),
                       ("decode", 32768, 128)):
        assert roofline.model_flops(tcfg, tproto, kind, s, b) == \
            jroofline.model_flops(jcfg, jproto, kind, s, b)


def test_walk_plain_matmul():
    a = torch.empty((512, 512), device="meta")
    t = walk(lambda x, y: x @ y, a, a)
    assert t.flops == 2 * 512 ** 3
    assert t.dot_bytes == 3 * 512 * 512 * 4


def test_walk_counts_every_iteration_of_a_loop():
    """An eager loop is unrolled: 7 layers count 7 times, nested loops
    their product (``tests/test_roofline.py``'s scan cases)."""
    a = torch.empty((256, 256), device="meta")
    ws = torch.empty((7, 256, 256), device="meta")

    def layers(x, w):
        for i in range(w.shape[0]):
            x = x @ w[i]
        return x

    assert walk(layers, a, ws).flops == 7 * 2 * 256 ** 3

    def nested(x, w):
        for i in range(w.shape[0]):
            for _ in range(3):
                x = x @ w[i]
        return x

    b = torch.empty((128, 128), device="meta")
    assert walk(nested, b, torch.empty((5, 128, 128), device="meta")
                ).flops == 5 * 3 * 2 * 128 ** 3


def test_walk_counts_region_and_replicated_work_per_device():
    """Inside a bound region (the reference's ``shard_map``) a device does
    one rank's share of the bound axes, repeated on every rank of the
    others; a value the region hands out as replicated is worked on by
    every rank of its axes, unless a sharded param the op reads splits
    them."""
    m = k = n = 64
    x = torch.empty((4, m, k), device="meta")
    w = torch.empty((k, n), device="meta")
    mesh = Mesh((2, 4), ("data", "model"))

    def step(x, w):
        with ranks.bind_axis("model", 4):
            y = ranks.replicated((x @ w).sum(0))      # one [m, n] a rank
        return y @ w

    one = 2 * m * n * k
    for spec, after in ((P("data"), one * 4 / 8), (P(None, "model"),
                                                   one / 8)):
        t = walk(step, x, w, ranks=8, shardings=(
            NamedSharding(mesh, P()), NamedSharding(mesh, spec)))
        assert t.flops == one + after
    assert walk(step, x, w, ranks=1).flops == 4 * one + one


def test_walk_prices_lcx_collectives_once():
    """A ring all-reduce over 4 ranks counts as one all-reduce (its puts
    are not counted again), an all-to-all as one all-to-all; per rank,
    as the reference's cost model prices them."""
    n, per = 4, (1024,)
    x = torch.zeros((n,) + per)
    nbytes = 1024 * 4
    lcx.init()
    with ranks.bind_axis("x", n):
        dev = lcx.Device(axis="x")
        t = walk(lambda v: lcx.all_reduce(v, device=dev, backend="ring"),
                 x, ranks=n)
        assert t.coll_by_kind == {"all-reduce": 2 * nbytes * 3 / 4}
        assert t.n_coll == 1
        assert t.collectives == [roofline.CollectiveOp(
            kind="all-reduce", dtype="float32", shape=per, bytes=nbytes,
            group=n, wire_bytes=2 * nbytes * 3 / 4)]
        t = walk(lambda v: lcx.all_to_all_x(v).device(dev)(), x, ranks=n)
        assert t.coll_by_kind == {"all-to-all": nbytes * 3 / 4}
        t = walk(lambda v: lcx.all_gather_x(v).device(dev)(), x, ranks=n)
        assert t.coll_by_kind == {"all-gather": n * nbytes * 3 / 4}


def test_unknown_step_kind_raises():
    with pytest.raises(ValueError, match="unknown step kind"):
        build_bundle(tbase.get_smoke_config("qwen2-0.5b"),
                     Mesh(*MESH), "serve", S, B)


def test_run_cell_end_to_end_on_cpu():
    """One production cell, cut to 2 layers, counted on ``meta``: the
    report's fields, positive terms on the H100's constants, and the
    per-device argument bytes the shardings give."""
    rec = dryrun.run_cell("qwen2-0.5b", "decode_32k", verbose=False,
                          overrides={"n_layers": 2})
    assert rec["ok"] and rec["mesh"] == "16x16" and rec["chips"] == 256
    assert rec["compute_s"] > 0 and rec["memory_s"] > 0
    assert rec["collective_is_lower_bound"]
    assert rec["bottleneck"] in ("compute", "memory", "collective")
    assert rec["memory_analysis"]["argument_size_in_bytes"] > 0
    assert "peak_memory_in_bytes" not in rec["memory_analysis"]
    assert rec["t_build_s"] >= 0 and rec["t_count_s"] > 0
    summary = roofline.RooflineReport(**{
        k: rec[k] for k in roofline.RooflineReport.__dataclass_fields__}
    ).summary()
    assert "qwen2-0.5b" in summary and "decode_32k" in summary


def test_dryrun_cli_reports_a_failed_cell(tmp_path):
    """A cell that fails is written with ``ok: false`` and its error,
    and the exit code is 1."""
    out = tmp_path / "cells.jsonl"
    env = dict(os.environ, PYTHONPATH=str(SRC))
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                        "--arch", "qwen2-0.5b", "--shape", "decode_32k",
                        "--override", "n_layers=2", "--override",
                        "n_kv_heads=3", "--out", str(out)],
                       env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 1, r.stdout[-2000:] + r.stderr[-2000:]
    (rec,) = [json.loads(line) for line in out.read_text().splitlines()]
    assert rec["ok"] is False and rec["error"]
    assert "dry-run complete: 0/1 cells OK" in r.stdout
