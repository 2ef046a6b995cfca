"""The benchmark's command.

    python3 lcxbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with an NVIDIA H100; see
``lcxbench/README.md``.
"""
import os
import sys
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the checkout's root and the program's sources, not this directory
sys.path[0:1] = [ROOT, os.path.join(ROOT, "src")]

if __name__ == "__main__":
    from lcxbench import env
    env.setup(ROOT)
    from lcxbench.harness import main
    sys.exit(main(sys.argv[1:], T_START))
