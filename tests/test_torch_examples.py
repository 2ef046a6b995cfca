"""The port's example scripts (``examples/torch_*.py``) on the CPU at
their smallest sizes, each in a child process: each exits 0, prints its
``... OK`` line after the asserts of the reference's script it ports
(the ring all-reduce's sum, greedy consistency of the served hybrid
against token-by-token ``apply_model``, the loss falling across an
injected failure that is recovered), and never loads ``jax``."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
# run the script as __main__, then report whether jax was ever imported
RUNNER = ("import runpy, sys; script = sys.argv[1]; sys.argv = sys.argv[1:];"
          " runpy.run_path(script, run_name='__main__');"
          " print('JAX LOADED' if 'jax' in sys.modules else 'NO JAX')")

CASES = {
    "torch_quickstart.py": (["--ranks", "4"], "quickstart OK"),
    "torch_serve_lm.py": (["--requests", "3"], "serve_lm OK"),
    "torch_train_lm.py": (["--steps", "40", "--d-model", "32",
                           "--layers", "1"], "train_lm OK"),
}


@pytest.mark.parametrize("script", sorted(CASES))
def test_example_runs_on_cpu_without_jax(script):
    args, ok = CASES[script]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run(
        [sys.executable, "-c", RUNNER, str(ROOT / "examples" / script),
         "--device", "cpu", *args],
        env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    lines = r.stdout.splitlines()
    assert ok in lines, r.stdout[-2000:]
    assert lines[-1] == "NO JAX"
    if script == "torch_serve_lm.py":
        assert "greedy consistency OK" in lines
    if script == "torch_train_lm.py":
        assert "1 failure(s) recovered" in r.stdout


@pytest.mark.parametrize("script", sorted(CASES))
def test_example_without_cuda_raises_unless_cpu_is_asked(script):
    """On the card by default: with no CUDA and no ``--device cpu`` the
    script stops with the port's message (skipped where a card is
    present)."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = subprocess.run([sys.executable, str(ROOT / "examples" / script)],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and "CUDA is not available" in r.stderr
