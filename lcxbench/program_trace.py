"""The program's own spans in a run: ``ServingEngine.trace``
(``repro_torch.trace``), which the readers find at
``run.window.engine.trace``.

``window_spans`` pairs the engine's ``engine.tick`` spans with the
window's ticks (``run.window.ticks``) from the end, since the warm-up's
ticks come first, and gives each tick the spans recorded inside it.  It
gives None when the engine records no spans, or when the trace's ring
dropped any span of those ticks.  ``host_ticks`` keeps the ticks that
``readers.host_ticks`` keeps: inside the window, not profiled.

``on_card`` puts the profiled ticks' spans onto the card's clock.  Each
tick's spans are shifted together so that its ``engine.tick`` span is
centred on the harness's ``amt tick`` span of the same tick in
``run.profile.spans``, which ``tracing.Tracer.read`` has already put on
the card's clock.  That span wraps ``tick()`` from outside, so the two
differ by the profiler's cost of entering and leaving it.  The profiled
ticks and the ``amt tick`` spans are paired from the end, as
``readers.kernel_roofline`` pairs launches.
"""
from __future__ import annotations

import bisect
from typing import Dict, Iterable, List, Optional, Tuple

Interval = Tuple[float, float]


def window_spans(run) -> Optional[List[Tuple[object, List]]]:
    """``(tick, spans)`` for each of the window's ticks, in order; a
    tick's spans are in the order they opened, its ``engine.tick`` span
    first."""
    trace = getattr(run.window.engine, "trace", None)
    ticks = run.window.ticks
    if trace is None or not trace.enabled or not ticks:
        return None
    records = list(trace.records)
    heads = [r for r in records if r.name == "engine.tick"]
    if len(heads) < len(ticks):
        return None
    heads = heads[-len(ticks):]
    first = heads[0].id
    spans = sorted((r for r in records if r.id >= first),
                   key=lambda r: r.id)
    if len(spans) != trace.opened - first:
        return None                    # the ring dropped some of them
    out, j = [], 0
    for tick, end in zip(ticks, [h.id for h in heads[1:]] + [trace.opened]):
        k = j
        while k < len(spans) and spans[k].id < end:
            k += 1
        out.append((tick, spans[j:k]))
        j = k
    return out


def host_ticks(run) -> Optional[List[Tuple[object, List]]]:
    """``window_spans`` of the ticks that started inside the window and
    ran with the profiler off."""
    pairs = window_spans(run)
    if pairs is None:
        return None
    return [(t, s) for t, s in pairs
            if t.start < run.window.close and not t.profiled]


def mean_span(run, name: str) -> Optional[float]:
    """Mean length in ms of the spans named ``name`` in ``host_ticks``."""
    pairs = host_ticks(run)
    v = [s.ns / 1e6 for _, spans in pairs or () for s in spans
         if s.name == name]
    return sum(v) / len(v) if v else None


def mean_self(run, name: str, child: str) -> Optional[float]:
    """Mean in ms, over the spans named ``name`` in ``host_ticks``, of
    each one's length less its own ``child`` spans'."""
    pairs = host_ticks(run)
    v = []
    for _, spans in pairs or ():
        for s in spans:
            if s.name == name:
                v.append((s.ns - sum(c.ns for c in spans if c.name == child
                                     and c.parent == s.id)) / 1e6)
    return sum(v) / len(v) if v else None


def on_card(run) -> Optional[List[Tuple[str, float, float]]]:
    """The profiled ticks' spans as ``(name, start, end)`` in
    microseconds on the card's clock (``tracing.Profile``'s), in the
    order they opened; None without a profile or spans."""
    p = run.profile
    pairs = window_spans(run) if p is not None else None
    if pairs is None:
        return None
    profiled = [spans for t, spans in pairs if t.profiled]
    amt = sorted((s, e) for n, s, e in p.spans if n == "amt tick")
    n = min(len(profiled), len(amt))
    if n == 0:
        return None
    out = []
    for spans, (s, e) in zip(profiled[-n:], amt[-n:]):
        head = spans[0]
        shift = (s + e) / 2 - (head.start + head.end) / 2e3
        out += [(x.name, x.start / 1e3 + shift, x.end / 1e3 + shift)
                for x in spans]
    return out


def overlap_us(a: Iterable[Interval], b: Iterable[Interval]) -> float:
    """The length the intervals of ``a`` and of ``b`` share; each list
    disjoint within itself."""
    a, b = sorted(a), sorted(b)
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_share_under(run, names: Tuple[str, ...]) -> Optional[float]:
    """The share of the profiled sub-window, in %, in which no kernel ran
    while the host was inside a program span named in ``names``."""
    spans = on_card(run)
    if spans is None or run.profile.window_us <= 0:
        return None
    inside = [(s, e) for n, s, e in spans if n in names]
    return 100.0 * overlap_us(run.profile.idle_gaps(), inside) \
        / run.profile.window_us


def idle_by_span(run) -> Optional[Dict[str, float]]:
    """The profiled sub-window's idle time in seconds by the innermost
    program span the host was in at each gap's middle (``harness``
    outside any), as ``tracing.Tracer.breakdown`` labels it by the
    harness's spans."""
    spans = on_card(run)
    if spans is None:
        return None
    spans.sort(key=lambda x: x[1])
    starts = [a for _, a, _ in spans]
    out: Dict[str, float] = {}
    for s, e in run.profile.idle_gaps():
        mid, best = (s + e) / 2, "harness"
        # the latest-starting span that holds ``mid`` is the innermost;
        # a tick's spans nest inside its ``engine.tick``, and ticks
        # follow one another
        for k in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
            name, a, b = spans[k]
            if mid < b:
                best = name
                break
            if name == "engine.tick":
                break
        out[best] = out.get(best, 0.0) + (e - s) / 1e6
    return out
