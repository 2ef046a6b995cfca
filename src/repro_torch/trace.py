"""In-memory spans of the program's own layers, on the host clock.

A :class:`Trace` records spans: a name, a start and an end from
``time.perf_counter_ns()``, the span's id and the id of the span open
around it when it started (one stack: the serving engine and the AMT
executor run on one thread), and attributes, which carry the counters
read at the same boundary (a request id, a prompt length, the tasks an
executor run took).  Records go into a ring of ``capacity`` spans; a span
pushed out of a full ring counts in ``dropped``.  ``Trace(enabled=False)``
hands out one shared no-op span and records nothing.  Nothing is written
anywhere: whoever holds the trace reads ``records``.

Two ways to record: ``with trace.span(name, **attrs) as s`` reads the
clock on entry and exit (``s.set(**attrs)`` adds counters before it
closes), and ``trace.add(name, start, end, **attrs)`` records a span whose
clock reads the caller made, under the span open at the call: consecutive
phases of one region then share the reads at their boundaries, so their
durations sum exactly to the region's.
"""
from __future__ import annotations

import collections
import time
from typing import Any, Deque, Dict, List, Optional

# Spans kept: a served tick records 8 spans and an admission 4, so a tick
# of 10 ms for a 51 s window and 60 s of drain, ~90,000 spans, fits.
CAPACITY = 1 << 17

now_ns = time.perf_counter_ns


class Span:
    """One span; also the context manager that records it."""

    __slots__ = ("name", "id", "parent", "start", "end", "attrs", "_trace")

    def __init__(self, trace: "Trace", name: str, sid: int,
                 parent: Optional[int], start: int, end: int,
                 attrs: Dict[str, Any]) -> None:
        self._trace = trace
        self.name, self.id, self.parent = name, sid, parent
        self.start, self.end, self.attrs = start, end, attrs

    def set(self, **attrs: Any) -> None:
        self.attrs.update(attrs)

    @property
    def ns(self) -> int:
        return self.end - self.start

    def __enter__(self) -> "Span":
        self._trace._stack.append(self.id)
        self.start = now_ns()
        return self

    def __exit__(self, typ: Any, value: Any, tb: Any) -> None:
        self.end = now_ns()
        tr = self._trace
        tr._stack.pop()
        tr._record(self)


class _NullSpan:
    """The disabled trace's span: records nothing."""

    __slots__ = ()

    def set(self, **attrs: Any) -> None:
        pass

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, typ: Any, value: Any, tb: Any) -> None:
        pass


NULL_SPAN = _NullSpan()


class Trace:
    """A ring of the last ``capacity`` spans; ``opened`` spans were
    started in all (ids ``0`` to ``opened - 1``), ``dropped`` of them were
    pushed out."""

    def __init__(self, enabled: bool = True,
                 capacity: int = CAPACITY) -> None:
        self.enabled = enabled
        self.records: Deque[Span] = collections.deque(maxlen=capacity)
        self.dropped = 0
        self.opened = 0
        self._stack: List[int] = []

    def span(self, name: str, **attrs: Any):
        """A context manager that records ``name`` from entry to exit."""
        if not self.enabled:
            return NULL_SPAN
        sid, stack = self.opened, self._stack
        self.opened = sid + 1
        return Span(self, name, sid, stack[-1] if stack else None, 0, 0,
                    attrs)

    def add(self, name: str, start: int, end: int, **attrs: Any) -> None:
        """Record ``name`` from ``start`` to ``end`` (``now_ns()`` reads),
        under the span open now."""
        if self.enabled:
            sid, stack = self.opened, self._stack
            self.opened = sid + 1
            self._record(Span(self, name, sid, stack[-1] if stack else None,
                              start, end, attrs))

    def _record(self, span: Span) -> None:
        records = self.records
        if len(records) == records.maxlen:
            self.dropped += 1
        records.append(span)
