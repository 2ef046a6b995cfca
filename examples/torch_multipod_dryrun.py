"""Multi-pod launch example on the PyTorch port: build and count one
architecture's step for the production meshes (single pod 16x16 and two
pods 2x16x16) and print the roofline breakdown on one H100's constants,
the flow a cluster launcher runs before committing the devices.

Run:  PYTHONPATH=src python examples/torch_multipod_dryrun.py [arch]
      [shape] [key=value ...]

The port of ``examples/multipod_dryrun.py``.  The ranks are stacked on
the ``meta`` device, so it needs no card (and sets no device count).
Each ``key=value`` overrides a config field (a Python literal), as the
dry run's ``--override`` does.
"""
import ast
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.launch.dryrun import run_cell  # noqa: E402


def main():
    arch = sys.argv[1] if len(sys.argv) > 1 else "qwen2-0.5b"
    shape = sys.argv[2] if len(sys.argv) > 2 else "train_4k"
    overrides = {}
    for ov in sys.argv[3:]:
        k, v = ov.split("=", 1)
        overrides[k] = ast.literal_eval(v)
    print(f"== {arch} {shape} : single pod (16x16 = 256 ranks) ==")
    run_cell(arch, shape, multi_pod=False, overrides=overrides or None)
    print(f"== {arch} {shape} : two pods (2x16x16 = 512 ranks) ==")
    run_cell(arch, shape, multi_pod=True, overrides=overrides or None)
    print("multipod_dryrun OK")


if __name__ == "__main__":
    main()
