"""Kernel bounds: one file a hook of ``repro_torch.kernels.model_kernels``,
``lcxbench/kernels/<hook>.py``, found by the hook's name.  Each gives:

- ``marks``: substrings of the names of the device kernels one call of the
  hook runs;
- ``record(args, kwargs)``: a tuple of what is kept of one call, taken from
  the hook's arguments while the profiled sub-window runs; it must not wait
  for the card;
- ``bound_s(cfg, rec, ctx)``: the least time of that call, from
  ``counts``; ``ctx`` holds what the harness recorded before it (``route``:
  the expert ids of the last routing);
- optionally ``kernels_per_call`` (1 if absent): device kernels one call
  runs, all of whose names hold a mark.

``tracing.Tracer.install`` wraps every hook that has such a file and
records its calls under the hook's name; ``readers.kernel_roofline(run,
hook)`` reads them.
"""
from __future__ import annotations

import importlib
from pathlib import Path
from types import ModuleType
from typing import Optional

HERE = Path(__file__).resolve().parent


def for_hook(hook: str) -> Optional[ModuleType]:
    """The bounds file of ``hook``, or None where it has none."""
    if not (HERE / f"{hook}.py").is_file():
        return None
    return importlib.import_module(f"{__name__}.{hook}")
