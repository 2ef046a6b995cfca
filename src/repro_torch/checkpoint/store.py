"""Checkpointing: atomic, async, resumable, in the reference's format.

The port of ``repro/checkpoint/store.py``; the two packages read each
other's checkpoints.  Layout::

    <dir>/step_000123/
        leaf_00000.npy ...        one file per leaf of the reference's tree
        manifest.json             leaf names/shapes/dtypes, step, extra
        COMMIT                    written last: presence marks validity

Writes go to ``step_N.tmp`` and are renamed only after COMMIT exists, so
a crash mid-write never corrupts the restore path (the trainer restarts
from :func:`latest_step`).  :class:`AsyncCheckpointer` copies the tensors
to the host (blocking only for that) and writes the files on a thread.

Leaves are named and ordered as ``jax.tree_util.keystr`` names the
reference's tree (``models.common.keyed_leaves``): the port's
``params["stack"]`` list is written as the reference's stacked leaves
``[n_periods, ...]`` and read back into the list, and ``AdamWState`` is
``[<flat index 0|1|2>]``.  A bfloat16 leaf is written as the reference
writes it: raw 2-byte items under the ``.npy`` descr ``<V2`` (what numpy
records for ``ml_dtypes.bfloat16``) and manifest dtype ``"bfloat16"``,
built through a 16-bit integer view, so neither side needs
``ml_dtypes``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..models.common import PyTree, keyed_leaves

BF16 = "bfloat16"


def _numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def _host(tree: PyTree) -> Tuple[List[str], List[Tuple[np.ndarray, str]]]:
    """The names and host copies (array, manifest dtype) of ``tree``'s
    leaves in the reference's layout; a bfloat16 leaf's array holds its
    bits as int16."""
    names, host = [], []
    for name, leaf in keyed_leaves(tree):
        parts = leaf if isinstance(leaf, list) else [leaf]
        arr = [_numpy(t) for t in parts]
        dtype = BF16 if parts[0].dtype == torch.bfloat16 \
            else str(arr[0].dtype)
        names.append(name)
        host.append((np.stack(arr) if isinstance(leaf, list) else arr[0],
                     dtype))
    return names, host


def _save_npy(path: str, arr: np.ndarray, dtype: str) -> None:
    if dtype != BF16:
        np.save(path, arr)
        return
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": "<V2", "fortran_order": False,
                "shape": arr.shape})
        f.write(arr.tobytes())


def save_checkpoint(ckpt_dir: str, step: int, tree: PyTree,
                    extra: Optional[Dict[str, Any]] = None) -> str:
    names, host = _host(tree)
    return _write(ckpt_dir, step, names, host, extra)


def _write(ckpt_dir: str, step: int, names: List[str],
           host: List[Tuple[np.ndarray, str]],
           extra: Optional[Dict[str, Any]]) -> str:
    final = os.path.join(ckpt_dir, f"step_{step:09d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": [], "extra": extra or {}}
    for i, (name, (arr, dtype)) in enumerate(zip(names, host)):
        fname = f"leaf_{i:05d}.npy"
        _save_npy(os.path.join(tmp, fname), arr, dtype)
        manifest["leaves"].append(
            {"name": name, "file": fname, "shape": list(arr.shape),
             "dtype": dtype})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    with open(os.path.join(tmp, "COMMIT"), "w") as f:
        f.write("ok")
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def list_steps(ckpt_dir: str) -> List[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for d in os.listdir(ckpt_dir):
        full = os.path.join(ckpt_dir, d)
        if d.startswith("step_") and not d.endswith(".tmp") \
                and os.path.exists(os.path.join(full, "COMMIT")):
            out.append(int(d[len("step_"):]))
    return sorted(out)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = list_steps(ckpt_dir)
    return steps[-1] if steps else None


def _tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == BF16:                       # raw 2-byte items
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(arr)


def restore_checkpoint(ckpt_dir: str, target: PyTree,
                       step: Optional[int] = None,
                       shardings: Optional[PyTree] = None, *,
                       device: DeviceLike = None
                       ) -> Tuple[PyTree, int, Dict[str, Any]]:
    """Restore into the structure of ``target`` (its leaves give the
    shapes and dtypes; each stored leaf is cast to its target's dtype).

    ``shardings`` is the reference's tree of
    :class:`~repro_torch.parallel.NamedSharding` mirroring ``target``;
    every rank of the port's mesh lives on the one card, so it places
    every leaf there: on ``device``, by default the card (``"cuda"``).
    Without ``shardings`` the tensors go to ``device``, by default each
    target leaf's own.  A fourth positional argument is ``shardings``, as
    in the reference, never a device.  Raises ``KeyError`` for a leaf the
    checkpoint lacks and ``ValueError`` for a shape that differs, as the
    reference does."""
    if shardings is not None:
        _check_shardings(shardings)
        device = resolve_device(device)
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no committed checkpoint in {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:09d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    by_name = {e["name"]: e for e in manifest["leaves"]}
    dev = None if device is None else resolve_device(device)
    loaded: Dict[str, torch.Tensor] = {}
    for name, ref in keyed_leaves(target):
        if name not in by_name:
            raise KeyError(f"checkpoint missing leaf {name}")
        entry = by_name[name]
        arr = np.load(os.path.join(d, entry["file"]))
        first = ref[0] if isinstance(ref, list) else ref
        want = ((len(ref),) if isinstance(ref, list) else ()) \
            + tuple(first.shape)
        if tuple(arr.shape) != want:
            raise ValueError(
                f"leaf {name}: checkpoint shape {arr.shape} != target "
                f"{want}: restore requires matching global shapes")
        loaded[name] = _tensor(arr, entry["dtype"]).to(
            device=dev or first.device, dtype=first.dtype)
    return (_rebuild(target, loaded), step, manifest.get("extra", {}))


def _check_shardings(shardings: PyTree) -> None:
    """``shardings`` must be a tree of ``NamedSharding`` (a device passed
    where the reference passes shardings is refused, not read)."""
    from ..parallel.sharding import NamedSharding
    if isinstance(shardings, NamedSharding):
        return
    if isinstance(shardings, dict):
        for v in shardings.values():
            _check_shardings(v)
        return
    if isinstance(shardings, (list, tuple)):
        for v in shardings:
            _check_shardings(v)
        return
    if dataclasses.is_dataclass(shardings):
        for f in dataclasses.fields(shardings):
            _check_shardings(getattr(shardings, f.name))
        return
    raise TypeError(f"shardings must be a tree of NamedSharding, got "
                    f"{type(shardings).__name__} {shardings!r}; pass a "
                    f"device as device=")


def _rebuild(tree: PyTree, loaded: Dict[str, torch.Tensor],
             prefix: str = "", index: Optional[int] = None) -> PyTree:
    """``tree``'s structure with the loaded leaves (period ``index`` of a
    stacked leaf inside ``params["stack"]``)."""
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], loaded, f"{prefix}[{k!r}]", index)
                for k in sorted(tree)}
    if isinstance(tree, list):
        return [_rebuild(t, loaded, prefix, i) for i, t in enumerate(tree)]
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: _rebuild(getattr(tree, f.name), loaded,
                             f"{prefix}[<flat index {i}>]", index)
            for i, f in enumerate(dataclasses.fields(tree))})
    t = loaded[prefix]
    return t if index is None else t[index].clone()


class AsyncCheckpointer:
    """Copy to the host synchronously, write the files on a thread, keep
    the newest ``keep`` steps."""

    def __init__(self, ckpt_dir: str, keep: int = 3) -> None:
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, tree: PyTree,
             extra: Optional[Dict[str, Any]] = None) -> None:
        self.wait()
        names, host = _host(tree)           # D2H, blocking

        def work():
            try:
                _write(self.ckpt_dir, step, names, host, extra)
                self._gc()
            except BaseException as e:  # noqa: BLE001 - raised by wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def _gc(self) -> None:
        steps = list_steps(self.ckpt_dir)
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.ckpt_dir, f"step_{s:09d}"),
                          ignore_errors=True)

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
