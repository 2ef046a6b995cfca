"""Multi-pod dry run: build and count every (architecture x input shape)
step on the production meshes, print its per-device memory and the
roofline terms on one H100's constants (the port of
``repro/launch/dryrun.py``).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-0.5b \\
        --shape train_4k [--multi-pod]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all \\
        --out results/dryrun.jsonl

Where the reference lowers and compiles each step for 256 or 512 TPU
chips, the port builds the step's bundle (``launch/steps.py``) with
prototypes on the ``meta`` device, every rank of the mesh stacked, and
runs it once under the counting walker (``analysis/hlo_walk.py``):
nothing is allocated and nothing is computed, so it needs no card.
``t_build_s`` is the time to build the bundle, ``t_count_s`` the time of
the counted meta run (the reference's ``t_lower_s`` and
``t_compile_s``).  A cell that fails is printed and written with
``ok: false`` and its error, and the exit code is 1 when any cell
failed.
"""
import argparse
import ast
import dataclasses
import json
import sys
import time
import traceback
from typing import Any, Dict, Optional

from repro_torch.analysis.roofline import analyze_compiled, count_step
from repro_torch.configs.base import SHAPES, cells, get_config
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import build_bundle
from repro_torch.models import abstract_init


def run_cell(arch: str, shape: str, *, multi_pod: bool = False,
             verbose: bool = True,
             overrides: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    mesh = make_production_mesh(multi_pod=multi_pod)
    mesh_name = "2x16x16" if multi_pod else "16x16"
    chips = mesh.size
    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    info = SHAPES[shape]
    kind = info["kind"]

    t0 = time.perf_counter()
    bundle = build_bundle(cfg, mesh, kind, info["seq_len"],
                          info["global_batch"])
    t_build = time.perf_counter() - t0
    counted = count_step(bundle, t_build_s=t_build)
    params_proto, _ = abstract_init(cfg)
    report = analyze_compiled(
        counted, arch=arch, shape=shape, mesh_name=mesh_name,
        chips=chips, cfg=cfg, params_proto=params_proto, kind=kind,
        seq_len=info["seq_len"], global_batch=info["global_batch"])
    rec = report.to_dict()
    rec.update({"t_build_s": t_build, "t_count_s": counted.t_count_s,
                "n_ops": counted.totals.n_ops, "kind": kind, "ok": True})
    if verbose:
        mem = rec["memory_analysis"]
        by_kind = {k: round(v / 2**20, 1)
                   for k, v in rec["collectives_by_kind"].items()}
        print(report.summary())
        print(f"    build={t_build:.1f}s count={counted.t_count_s:.1f}s "
              f"ops={counted.totals.n_ops} "
              f"args={mem.get('argument_size_in_bytes', 0)/2**30:.2f}GiB "
              f"out={mem.get('output_size_in_bytes', 0)/2**30:.2f}GiB "
              f"ncoll={rec['n_collectives']} by_kind={by_kind}MiB")
        sys.stdout.flush()
    return rec


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--arch")
    p.add_argument("--shape")
    p.add_argument("--multi-pod", action="store_true")
    p.add_argument("--both-meshes", action="store_true")
    p.add_argument("--all", action="store_true")
    p.add_argument("--out", default=None)
    p.add_argument("--override", action="append", default=[],
                   help="cfg override key=value (python literal)")
    args = p.parse_args()

    overrides: Dict[str, Any] = {}
    for ov in args.override:
        k, v = ov.split("=", 1)
        try:
            overrides[k] = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            overrides[k] = v

    todo = []
    if args.all:
        for arch, shape in cells():
            todo.append((arch, shape, False))
            todo.append((arch, shape, True))
    else:
        meshes = [False, True] if args.both_meshes else [args.multi_pod]
        for mp in meshes:
            todo.append((args.arch, args.shape, mp))

    out_f = open(args.out, "a") if args.out else None
    n_ok = 0
    try:
        for arch, shape, mp in todo:
            t0 = time.perf_counter()
            try:
                rec = run_cell(arch, shape, multi_pod=mp,
                               overrides=overrides or None)
                n_ok += 1
            except Exception as e:  # noqa: BLE001  (recorded per cell)
                rec = {"arch": arch, "shape": shape,
                       "mesh": "2x16x16" if mp else "16x16", "ok": False,
                       "error": f"{type(e).__name__}: {e}"}
                print(f"FAIL {arch} {shape} mp={mp}: {rec['error']}")
                traceback.print_exc()
            rec["t_cell_s"] = time.perf_counter() - t0
            if out_f:
                out_f.write(json.dumps(rec) + "\n")
                out_f.flush()
    finally:
        if out_f:
            out_f.close()
    print(f"dry-run complete: {n_ok}/{len(todo)} cells OK")
    if n_ok < len(todo):
        sys.exit(1)


if __name__ == "__main__":
    main()
