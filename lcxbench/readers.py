"""Metric readers, found by name: ``lcxbench/metrics/<name>.py`` defines
``read(run)``, which returns the metric's value or None when the run holds
nothing for it to read (the harness then leaves the metric out).  ``run``
is a ``harness.Run``: the cell's configuration and mix, the window's
requests and ticks (``serve.Window``), the set-up time and, in a traced
run, the profiled sub-window (``tracing.Profile``)."""
from __future__ import annotations

import importlib.util
from pathlib import Path
from typing import Callable, Dict, List, Optional

from . import counts

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


def kernel_roofline(run, kind: str, marks) -> Optional[float]:
    """Sum of the bounds of ``kind``'s launches in the profiled
    sub-window over the device time of the kernels whose names hold one
    of ``marks``, in %.  The launches and the kernels are paired from the
    end (a profiler that lost any lost the first ones); None without
    both."""
    p = run.profile
    if p is None:
        return None
    bounds = launch_bounds(run.cfg, p.launches, kind)
    times = [(t - s) / 1e6 for name, s, t in sorted(p.kernels,
                                                   key=lambda k: k[1])
             if any(m in name for m in marks)]
    n = min(len(bounds), len(times))
    if n == 0:
        return None
    return 100.0 * sum(bounds[-n:]) / sum(times[-n:])


def launch_bounds(cfg: Dict, launches, kind: str) -> List[float]:
    """The least time of each recorded launch of ``kind``, in order."""
    out, ids = [], None
    for rec in launches:
        if rec[0] == "route":
            ids = rec[1]
        elif rec[0] == kind == "gmm":
            (e, c, d_in), (_, _, d_out) = rec[1], rec[2]
            n_e = ids.reshape(-1).bincount(minlength=e).clamp(max=c)
            rows, experts = int(n_e.sum()), int((n_e > 0).sum())
            out.append(counts.bound_s(*counts.gmm_work(rows, experts, d_in,
                                                        d_out)))
        elif rec[0] == kind == "flash":
            (b, sq, hq, d), (_, sk, hkv, _) = rec[1], rec[2]
            fl, nb = counts.flash_work(hq, hkv, sq, sk, d, rec[3])
            out.append(counts.bound_s(b * fl, b * nb))
    return out
