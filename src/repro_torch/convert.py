"""Carry the reference's parameters over to the port.

:func:`params_from_jax` takes the JAX package's parameter tree as nested
dicts of numpy arrays (``jax.tree.map(np.asarray, params)`` on the
reference's side) and returns the port's parameters.  The layouts are
the same leaf for leaf, except that the reference stacks the periodic
body of the model along a leading ``[n_periods]`` dim of every leaf of
``"stack"``; the port keeps one dict per period in a list.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .device import DeviceLike, resolve_device

PyTree = Any


def _tensor(a: np.ndarray, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":      # ml_dtypes' bfloat16: same bits
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device)


def _map(tree: PyTree, fn) -> PyTree:
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def params_from_jax(cfg: Any, tree: Dict[str, Any], *,
                    device: DeviceLike = None) -> Dict[str, Any]:
    """The port's params from the reference's numpy tree, on ``device``
    (default ``"cuda"``; raises where CUDA is absent)."""
    dev = resolve_device(device)
    _, _, n_periods = cfg.scan_plan()
    out: Dict[str, Any] = {}
    for name, sub in tree.items():
        if name == "stack":
            out[name] = [_map(sub, lambda a, n=n: _tensor(np.asarray(a)[n],
                                                          dev))
                         for n in range(n_periods)]
        else:
            out[name] = _map(sub, lambda a: _tensor(a, dev))
    return out
