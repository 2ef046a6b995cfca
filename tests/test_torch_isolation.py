"""The port stands alone: no module of ``src/repro_torch``, no
``examples/torch_*.py`` and not ``chip_smoke.py`` imports JAX or the JAX
package, and the port's entry points run on the card unless the caller
asks for the CPU (the dry run, which only counts on ``meta``, needs no
card)."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = {"jax", "jaxlib", "repro"}


def _port_files():
    return (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
            + sorted((ROOT / "examples").glob("torch_*.py")))


def _modules():
    out = []
    for p in sorted(PORT.rglob("*.py")):
        rel = p.relative_to(PORT.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        out.append(".".join(parts))
    return out


def _imports(path):
    """Top-level names of every absolute import in ``path``."""
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0], node.lineno


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [(name, line) for name, line in _imports(path) if name in FORBIDDEN]
    assert not bad, f"{path}: imports {bad}"


def test_importing_every_port_module_loads_no_jax():
    code = ("import importlib, sys\n"
            f"for m in {_modules()!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(k for k in sys.modules\n"
            "             if k.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
            "print(len(sys.modules), bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here: the entry points run on it")


def test_resolve_device_defaults_to_cuda_and_raises(no_cuda):
    from repro_torch.device import on_hopper, resolve_device
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    assert not on_hopper()


def test_init_model_without_device_raises(no_cuda):
    from repro_torch.configs.qwen2_0_5b import smoke
    from repro_torch.models import init_cache, init_model
    with pytest.raises(RuntimeError, match="CUDA"):
        init_model(torch.Generator(), smoke())
    with pytest.raises(RuntimeError, match="CUDA"):
        init_cache(smoke(), 1, 8)


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b",
                                  "jamba-1.5-large-398b"])
def test_moe_entry_points_without_device_raise(no_cuda, arch):
    """The MoE slice's configs: init_model, init_cache and
    ``launch/serve.py`` default to the card."""
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.models import init_cache, init_model
    cfg = get_smoke_config(arch)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_model(torch.Generator(), cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_cache(cfg, 1, 8)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                        "--arch", arch], env=env, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode != 0 and "CUDA is not available" in r.stderr


def test_moe_serve_cli_runs_on_cpu_when_asked():
    """``launch/serve.py --arch qwen3-moe-30b-a3b --device cpu`` serves
    the smoke config through the MoE path."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                        "--arch", "qwen3-moe-30b-a3b", "--device", "cpu",
                        "--requests", "3", "--max-new", "4"], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "served 3 requests, 12 tokens" in r.stdout


def test_params_from_jax_without_device_raises(no_cuda):
    import jax
    from repro.configs.qwen2_0_5b import smoke as jsmoke
    from repro.models import init_model as jinit
    from repro_torch.configs.qwen2_0_5b import smoke
    from repro_torch.convert import params_from_jax
    jp, _ = jinit(jax.random.PRNGKey(0), jsmoke())
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_jax(smoke(), jax.tree.map(np.asarray, jp))


def test_serving_engine_without_device_raises(no_cuda):
    from repro_torch.configs.qwen2_0_5b import smoke
    from repro_torch.serving import ServeConfig, ServingEngine
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(smoke(), {}, ServeConfig(n_slots=1, max_seq=8))


def test_failover_engine_and_reshard_without_device_raise(no_cuda):
    """The failover path and elastic_reshard default to the card too."""
    from repro_torch.configs.qwen2_0_5b import smoke
    from repro_torch.runtime import elastic_reshard
    from repro_torch.serving import ServeConfig, ServingEngine
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(smoke(), {}, ServeConfig(n_slots=1, max_seq=8),
                      failover=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        elastic_reshard({"w": torch.zeros(2)}, {"w": None})


def test_chip_smoke_refuses_without_cuda_or_repo(no_cuda, tmp_path):
    """It exits non-zero and prints no result where CUDA is absent, and
    in a directory that holds chip_smoke.py and nothing else."""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    here = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          env=env, capture_output=True, text=True,
                          timeout=120, cwd=ROOT)
    alone_dir = tmp_path / "alone"
    alone_dir.mkdir()
    (alone_dir / "chip_smoke.py").write_text(
        (ROOT / "chip_smoke.py").read_text())
    alone = subprocess.run([sys.executable, "chip_smoke.py"], env=env,
                           capture_output=True, text=True, timeout=120,
                           cwd=alone_dir)
    for r in (here, alone):
        assert r.returncode != 0
        assert '"ok"' not in r.stdout


def test_train_entry_points_without_device_raise(no_cuda):
    """The Trainer, the data loader and ``launch/train.py`` default to
    the card."""
    from repro_torch.configs.qwen2_0_5b import smoke
    from repro_torch.data import DataLoader, SyntheticLMDataset
    from repro_torch.runtime import TrainConfig, Trainer
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(smoke(), TrainConfig(seq_len=8, global_batch=2))
    with pytest.raises(RuntimeError, match="CUDA"):
        DataLoader(SyntheticLMDataset(vocab=8, seq_len=4, global_batch=1))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                        "--arch", "qwen2-0.5b", "--smoke", "--steps", "1"],
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and "CUDA is not available" in r.stderr


def test_new_modules_are_held_to_the_rule():
    """The dry run's modules and the example scripts are among the files
    the import rule checks."""
    names = {str(p.relative_to(ROOT)) for p in _port_files()}
    assert {"src/repro_torch/analysis/hlo_walk.py",
            "src/repro_torch/launch/dryrun.py",
            "examples/torch_quickstart.py", "examples/torch_serve_lm.py",
            "examples/torch_train_lm.py",
            "examples/torch_multipod_dryrun.py"} <= names


@pytest.mark.parametrize("argv", [
    ["-m", "repro_torch.launch.dryrun", "--arch", "qwen2-0.5b", "--shape",
     "decode_32k", "--override", "n_layers=2"],
    [str(ROOT / "examples" / "torch_multipod_dryrun.py"), "qwen2-0.5b",
     "decode_32k", "n_layers=2"]], ids=["dryrun", "multipod_example"])
def test_dryrun_needs_no_cuda(argv):
    """The dry run counts on ``meta``: with no card visible and no
    ``--device`` it runs to its end and loads no JAX."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    code = ("import runpy, sys; sys.argv = sys.argv[1:]; "
            "m = sys.argv[1] if sys.argv[0] == '-m' else None; "
            "sys.argv = sys.argv[1:] if m else sys.argv; "
            "runpy.run_module(m, run_name='__main__') if m else "
            "runpy.run_path(sys.argv[0], run_name='__main__')")
    code += ("\nbad = [k for k in sys.modules if k.split('.')[0] in "
             "('jax', 'jaxlib', 'repro')]\nassert not bad, bad")
    r = subprocess.run([sys.executable, "-c", code, *argv], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert "decode_32k" in r.stdout


def test_new_entry_points_without_device_raise(no_cuda):
    """The bundles' steps and the walker run wherever their tensors are,
    but the entry points that place tensors default to the card:
    ``DataLoader`` with shardings, ``restore_checkpoint`` with
    shardings."""
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.data import DataLoader, SyntheticLMDataset
    from repro_torch.parallel import Mesh, NamedSharding, PartitionSpec
    sh = NamedSharding(Mesh((2,), ("data",)), PartitionSpec("data"))
    with pytest.raises(RuntimeError, match="CUDA"):
        DataLoader(SyntheticLMDataset(vocab=8, seq_len=4, global_batch=2),
                   {"tokens": sh, "labels": sh})
    with pytest.raises(RuntimeError, match="CUDA"):
        restore_checkpoint("/nonexistent", {"a": torch.zeros(2)},
                           shardings={"a": sh})
