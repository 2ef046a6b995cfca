"""The knee of an open-loop cell: one set-up, then one window at each of
a few fixed rates, the engine drained between them.

    python3 lcxbench/sweep.py --workload <cell> --seconds <s> --seed <n> --rates 1 2 3

The set-up is the harness's (``harness.build``) and the numbers are the
cell's own readers (``metrics/``), so the knee and the cells share one
yardstick.  Per rate, one JSON line: requests due, the share of them
finished by the close, the backlog at the close (queued; submitted and
not finished), and the readers' time to first token p90, gap p95 and
output tokens per second.  The knee is the highest rate whose backlog
does not grow through the window.  Needs the card.
"""
import argparse
import copy
import dataclasses
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0:1] = [ROOT, os.path.join(ROOT, "src")]

READ = ("ttft_p90_ms", "itl_p95_ms", "output_tokens_per_s")


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--rates", type=float, nargs="+", required=True)
    a = p.parse_args()
    from lcxbench import env
    env.setup(ROOT)
    from lcxbench import bench, harness, readers
    from lcxbench.serve import Window
    from lcxbench.traffic import Traffic
    cell = bench.cell(a.workload)
    eng, _, _ = harness.build(cell, a.seed, "cuda")
    for rate in a.rates:
        mix = copy.deepcopy(cell.mix)
        mix["rate_rps"] = rate
        t0 = time.perf_counter()
        w = Window(eng, Traffic(mix, a.seed, a.seconds,
                                cell.cfg["vocab_size"]), a.seconds).run()
        run = harness.Run(dataclasses.replace(cell, mix=mix), w, 0.0)
        due = w.due_in_window()
        done = [r for r in due if r.ereq.done and r.times
                and r.times[-1] <= w.close]
        line = {"rate_rps": rate, "due": len(due),
                "finished_share": len(done) / max(1, len(due)),
                "queued_at_close": w.backlog_at_close[0],
                "unfinished_at_close": w.backlog_at_close[1]}
        line.update({m: readers.reader(m)(run) for m in READ})
        eng.run_until_drained()
        line["wall_s"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
