"""Metric readers, found by name: ``lcxbench/metrics/<name>.py`` defines
``read(run)``, which returns the metric's value or None when the run holds
nothing for it to read (the harness then leaves the metric out).  ``run``
is a ``harness.Run``: the cell's configuration and mix, the window's
requests and ticks (``serve.Window``), the set-up time, the card's peak
of allocated memory and, in a traced run, the profiled sub-window
(``tracing.Profile``)."""
from __future__ import annotations

import importlib.util
from pathlib import Path
from typing import Callable, Dict, List, Optional

from . import kernels as kernel_bounds

METRICS = Path(__file__).resolve().parent / "metrics"
_CACHE: Dict[str, Callable] = {}


def reader(name: str) -> Callable:
    if name not in _CACHE:
        path = METRICS / f"{name}.py"
        if not path.is_file():
            raise FileNotFoundError(f"no reader for metric {name!r}: {path}")
        spec = importlib.util.spec_from_file_location(
            "lcxbench_metric_" + name.replace(".", "_").replace("-", "_"),
            path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _CACHE[name] = mod.read
    return _CACHE[name]


def host_ticks(run) -> List:
    """The window's ticks that ran with the profiler off: host timings of
    a traced run leave the profiled sub-window out."""
    return [t for t in run.window.window_ticks() if not t.profiled]


def kernel_roofline(run, hook: str) -> Optional[float]:
    """Sum of the bounds of ``hook``'s calls in the profiled sub-window
    over the device time of the kernels whose names hold one of its
    bounds file's ``marks`` (``lcxbench/kernels/``), in %.  The calls and
    the kernels (``kernels_per_call`` a call) are paired from the end (a
    profiler that lost any lost the first ones); None without both."""
    p = run.profile
    if p is None:
        return None
    bounds_file = kernel_bounds.for_hook(hook)
    per = getattr(bounds_file, "kernels_per_call", 1)
    bounds = launch_bounds(run.cfg, p.launches, hook)
    times = [(t - s) / 1e6 for name, s, t in sorted(p.kernels,
                                                   key=lambda k: k[1])
             if any(m in name for m in bounds_file.marks)]
    n = min(len(bounds), len(times) // per)
    if n == 0:
        return None
    return 100.0 * sum(bounds[-n:]) / sum(times[len(times) - n * per:])


def launch_bounds(cfg: Dict, launches, hook: str) -> List[float]:
    """The least time of each recorded call of ``hook``, in order."""
    bounds_file = kernel_bounds.for_hook(hook)
    out, ctx = [], {}
    for rec in launches:
        if rec[0] == "route":
            ctx["route"] = rec[1]
        elif rec[0] == hook:
            out.append(bounds_file.bound_s(cfg, rec[1:], ctx))
    return out
