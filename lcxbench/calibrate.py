"""The readings that a cell's correctness limit is set from.

    python3 lcxbench/calibrate.py --workload <cell> --seconds <s> --seeds 11 12 13

For each seed, one whole run of the cell as ``run.py`` makes it (weights
drawn anew from that seed), then on the same sample of served tokens the
program's readings and the control's (the reference with its matrix
products in float8 e4m3 in the program's place), and the control judged
by the cell's limits in the program's place (``check.judge``).  One JSON
line a seed: the program's checks and verdict, the control's, every
reading of both, and ``widest``: the program's ten widest gaps, each
with whether its expert sets differed from the reference's there;
with ``--dump`` each served position's gaps, the reference's routing
margin and whether the program's sets agreed, to a file.
Needs the card; the benchmark's own runs never run the control.
"""
import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0:1] = [ROOT, os.path.join(ROOT, "src")]


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--dump", default=None,
                   help="a file for each served position's readings, one "
                        "JSON line a seed")
    a = p.parse_args()
    from lcxbench import env
    env.setup(ROOT)
    import torch
    from lcxbench import bench, harness
    cell = bench.cell(a.workload)
    for seed in a.seeds:
        res, _ = harness.run(cell, seed, a.seconds, False, "cuda",
                             time.perf_counter(), control=True)
        ctl = res["control"]
        pos = ctl["readings"].pop("positions", None)
        if a.dump:
            with open(a.dump, "a") as f:
                f.write(json.dumps({"seed": seed, "positions": pos}) + "\n")
        print(json.dumps({"seed": seed, "correct": res["correct"],
                          "checks": res["checks"],
                          "control_correct": ctl["correct"],
                          "control_checks": ctl["checks"],
                          "readings": ctl["readings"],
                          "metrics": res["metrics"]}), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
