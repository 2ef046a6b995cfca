"""Build the port's CUDA sources into shared libraries and load them.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into
``build/lib<name>-<hash>.so`` (the hash is of the source and the shared
headers ``csrc/*.cuh``, so an edited source builds anew) and loaded with ``ctypes``: the sources have a plain C
interface and include no PyTorch header, which keeps a build to seconds.
A library builds at first use; :func:`build` starts one ``nvcc`` per
source, all at once.  Nothing here runs when the module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parent / "build"
SOURCES = ("flash_attention", "ssd_scan", "ring_allgather", "moe_gmm")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_LOADED: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then
    ``/usr/local/cuda/bin``."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha1(src.read_bytes() + headers
                          + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD / f"lib{name}-{digest}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, Path]:
    """Compile every source in ``names`` whose library is missing, with
    one ``nvcc`` process per source running in parallel.  Raises with the
    compiler's output if any fails; returns the library paths."""
    BUILD.mkdir(parents=True, exist_ok=True)
    out = {n: library_path(n) for n in names}
    todo = {n: p for n, p in out.items() if not p.exists()}
    procs = {}
    for n, p in todo.items():
        fd, tmp = tempfile.mkstemp(dir=BUILD, suffix=".so")
        os.close(fd)
        cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failures = []
    for n, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failures.append(f"nvcc {n}.cu exited {proc.returncode}:\n{log}")
            continue
        os.replace(tmp, out[n])
    if failures:
        raise RuntimeError("\n".join(failures))
    return out


def refuse_xla(backend: Optional[str], plain: str) -> None:
    """A wrapper given a tensor off the CPU launches its kernel or raises:
    the reference's ``backend="xla"`` (its plain path) raises there and
    names the plain function to call instead."""
    if backend == "xla":
        raise ValueError(f'backend="xla" takes the plain version on CPU '
                         f"tensors only; call {plain} for it on this "
                         f"device")


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    if name not in _LOADED:
        path = build((name,))[name]
        _LOADED[name] = ctypes.CDLL(str(path))
    return _LOADED[name]
