"""The traced run: a profiled sub-window, host spans and launch records.

In a ``--trace 1`` run the harness wraps, from outside the program, the
calls into each layer with ``torch.profiler.record_function`` spans:
``amt tick`` (``ServingEngine.tick``: the AMT executor's task graph over
its LCX runtime), ``admission/prefill`` (one request's admission task),
``decode`` (the decode task) with ``sampling`` inside it, and
``sleeping for arrivals``.  While the sub-window runs it also records,
in order, each routing (the router's expert ids) and each call of a
kernel hook that has a bounds file (``lcxbench/kernels/<hook>.py``), as
that file's ``record`` keeps it.

The sub-window is ``trace_ticks`` ticks (the mix file says how many)
from the middle of the window (see ``Tracer.before_tick``); a marker
kernel (``torch.cuda._sleep``) on each side bounds it on the card's own
clock.  The number of ticks keeps the profile well under the
~10^5 kernels after which ``torch.profiler`` records nothing.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import torch

from . import kernels as kernel_bounds

LABELS = ("amt tick", "admission/prefill", "decode", "sampling",
          "sleeping for arrivals")
MARKER = "lcxbench marker"
MARKER_CYCLES = 100_000          # ~50 us at the H100's clock
LATE_S = 5.0


@dataclasses.dataclass
class Profile:
    """What the profiled sub-window recorded, times in microseconds on
    the card's clock."""
    window_us: float
    kernels: List[Tuple[str, float, float]]     # (name, start, end)
    spans: List[Tuple[str, float, float]]       # host spans, shifted
    launches: List[Tuple]                       # in order, see Tracer

    def busy_us(self) -> float:
        """The union of the kernels' intervals."""
        total, end = 0.0, float("-inf")
        for _, s, e in sorted(self.kernels, key=lambda k: k[1]):
            if e <= end:
                continue
            total += e - max(s, end)
            end = e
        return total

    def idle_gaps(self) -> List[Tuple[float, float]]:
        """The stretches with no kernel running, inside the window."""
        gaps, end = [], 0.0
        for _, s, e in sorted(self.kernels, key=lambda k: k[1]):
            if s > end:
                gaps.append((end, s))
            end = max(end, e)
        if end < self.window_us:
            gaps.append((end, self.window_us))
        return gaps

    def label(self, t: float) -> str:
        """The innermost host span that holds time ``t``."""
        best, start = "harness", float("-inf")
        for name, s, e in self.spans:
            if s <= t < e and s > start:
                best, start = name, s
        return best


class Tracer:
    """Installs the spans and recorders on ``engine`` and its ``kernels``
    dict, and profiles ``ticks`` ticks from ``start_at`` seconds."""

    def __init__(self, engine, kernels: Dict, start_at: float, ticks: int,
                 sleep=time.sleep):
        self.engine, self.kernels, self._sleep = engine, kernels, sleep
        self.start_at, self.n_ticks = start_at, ticks
        self.recording = False
        self.launches: List[Tuple] = []
        self.state, self.done_ticks = "wait", 0
        self.prof = None
        self.profile: Optional[Profile] = None
        self._restore: List = []

    # -- spans and recorders --------------------------------------------
    @staticmethod
    def _spanned(label, fn):
        def wrapped(*a, **kw):
            with torch.profiler.record_function(label):
                return fn(*a, **kw)
        return wrapped

    def install(self) -> "Tracer":
        from repro_torch.models import moe
        from repro_torch.serving import engine as engine_mod
        eng = self.engine
        for name, label in (("tick", "amt tick"),
                            ("_admit_one", "admission/prefill"),
                            ("_decode_tick", "decode")):
            setattr(eng, name, self._spanned(label, getattr(eng, name)))
        self._patch(engine_mod, "sample_token",
                    self._spanned("sampling", engine_mod.sample_token))
        route = moe.route

        def recorded_route(cfg, router_p, x):
            out = route(cfg, router_p, x)
            if self.recording:
                self.launches.append(("route", out[0]))
            return out

        self._patch(moe, "route", recorded_route)
        for hook in self.kernels:
            bounds = kernel_bounds.for_hook(hook)
            if bounds is not None:
                self.kernels[hook] = self._recorded(hook, bounds,
                                                    self.kernels[hook])
        return self

    def _patch(self, module, name, value) -> None:
        self._restore.append((module, name, getattr(module, name)))
        setattr(module, name, value)

    def uninstall(self) -> None:
        for module, name, value in reversed(self._restore):
            setattr(module, name, value)
        self._restore = []

    def _recorded(self, hook, bounds, fn):
        def wrapped(*a, **kw):
            if self.recording:
                self.launches.append((hook, *bounds.record(a, kw)))
            return fn(*a, **kw)
        return wrapped

    def sleep(self, seconds: float) -> None:
        with torch.profiler.record_function("sleeping for arrivals"):
            self._sleep(seconds)

    # -- the sub-window -------------------------------------------------
    def _marker(self) -> None:
        if self.engine.device.type != "cuda":
            return
        torch.cuda.synchronize()
        with torch.profiler.record_function(MARKER):
            torch.cuda._sleep(MARKER_CYCLES)
            torch.cuda.synchronize()

    def before_tick(self, now: float) -> bool:
        """Called before each tick, ``now`` seconds into the window; True
        when the tick is profiled.  The sub-window opens at the first tick
        after ``start_at`` that admits a request, or at the first after
        ``start_at + LATE_S`` if none does."""
        if self.state == "wait" and now >= self.start_at and (
                self.engine.queue or now >= self.start_at + LATE_S):
            from torch.profiler import ProfilerActivity, profile
            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            self.prof.start()
            self._marker()
            self.state, self.recording = "active", True
        return self.state == "active"

    def after_tick(self, tick) -> None:
        if self.state == "active":
            self.done_ticks += 1
            if self.done_ticks >= self.n_ticks:
                self._stop()

    def window_closed(self) -> None:
        if self.state == "active":
            self._stop()
        self.state = "done"

    def _stop(self) -> None:
        self.recording = False
        self._marker()
        self.prof.stop()
        self.state = "done"

    # -- reading the profile -------------------------------------------
    def read(self) -> Optional[Profile]:
        """The sub-window's kernels and host spans, on the card's clock;
        None when nothing was profiled or no kernel was recorded."""
        if self.prof is None or self.done_ticks == 0:
            return None
        cuda = torch.autograd.DeviceType.CUDA
        kernels, spans, markers, host_marks = [], [], [], []
        for e in self.prof.events():
            name, s, t = e.name, e.time_range.start, e.time_range.end
            if e.device_type == cuda:
                if name in LABELS or name == MARKER:
                    continue           # the spans' device-side shadows
                if "spin_kernel" in name:
                    markers.append((s, t))
                else:
                    kernels.append((name, s, t))
            elif name in LABELS:
                spans.append((name, s, t))
            elif name == MARKER:
                host_marks.append((s, t))
        markers.sort()
        host_marks.sort()
        if len(markers) >= 2:
            lo, hi = markers[0][1], markers[-1][0]
        elif kernels:
            lo = min(k[1] for k in kernels)
            hi = max(k[2] for k in kernels)
        else:
            return None
        # host spans onto the card's clock: the marker kernel starts as
        # soon as it is launched, with the card idle
        shift = (markers[0][0] - host_marks[0][0]
                 if markers and host_marks else 0.0)
        kernels = [(n, s - lo, t - lo) for n, s, t in kernels
                   if s >= lo and t <= hi]
        spans = [(n, s + shift - lo, t + shift - lo) for n, s, t in spans]
        self.profile = Profile(hi - lo, kernels, spans, self.launches)
        return self.profile

    def breakdown(self) -> Optional[Dict]:
        """The device operations that took most time, and the idle time
        by what the host was doing, each at most 10, in seconds."""
        p = self.profile
        if p is None:
            return None
        ops: Dict[str, float] = {}
        for name, s, t in p.kernels:
            ops[name[:160]] = ops.get(name[:160], 0.0) + (t - s) / 1e6
        idle: Dict[str, float] = {}
        for s, t in p.idle_gaps():
            lab = p.label((s + t) / 2)
            idle[lab] = idle.get(lab, 0.0) + (t - s) / 1e6
        top = lambda d: [[k, v] for k, v in sorted(d.items(),
                                                   key=lambda kv: -kv[1])[:10]]
        return {"device_ops": top(ops), "idle_gaps": top(idle)}
