"""Nothing the benchmark runs loads JAX or the JAX package: top-level
module names compared whole, so the program ``repro_torch`` passes and
``repro`` does not; the plain references import nothing of the program."""
import ast
import os
import subprocess
import sys
from pathlib import Path

from lcxbench import isolation

HERE = Path(__file__).resolve().parents[1]


def test_top_level_names_compared_whole():
    assert isolation.forbidden(["repro_torch", "repro_torch.models",
                                "reprox", "jaxtyping", "flaxen"]) == []
    assert isolation.forbidden(["repro.core.ops", "jax.numpy", "jaxlib",
                                "flax.linen", "repro_torch"]) == [
        "flax", "jax", "jaxlib", "repro"]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield "." * node.level + (node.module or "")


def test_references_import_only_torch_and_the_standard_library():
    allowed = {"torch", "math", "typing", "__future__", "numpy"}
    for f in sorted((HERE / "reference").glob("*.py")):
        for name in _imports(f):
            assert name.startswith(".") or name.split(".")[0] in allowed, \
                (f.name, name)


def test_a_run_loads_no_jax():
    code = ("from lcxbench.tests import smoke\n"
            "from lcxbench import harness, isolation\n"
            "c = smoke.StepClock()\n"
            "res, _ = harness.run(smoke.cell('internlm2-20b', 'closed'), 1,"
            " 0.3, False, 'cpu', 0.0, clock=c, sleep=c.sleep)\n"
            "assert res['attempted'] > 0, res\n"
            "print(isolation.loaded())\n")
    root = HERE.parent
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(root), str(root / "src")]))
    out = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
