"""The measured window: the harness drives ``ServingEngine`` as a client.

Each pass of the loop submits every request whose due time has passed,
then calls ``tick()``; with nothing queued or live it sleeps until the
next due time.  Tokens are delivered when the ``tick()`` that made them
returns (it ends in the host copy of the sampled tokens).  A request is
timed from when it was due.  A closed loop's client sends its next
request when its last one finished.  After the window closes, nothing
new is due; the loop goes on ticking until every request that was due in
the window has its first token, for at most ``DRAIN_S`` seconds.
"""
from __future__ import annotations

import dataclasses
import heapq
import time
from typing import Callable, Dict, List, Optional

from .traffic import Req, Traffic

DRAIN_S = 60.0


@dataclasses.dataclass
class Record:
    req: Req
    ereq: object                        # the engine's Request
    submitted: float                    # seconds after the window opened
    first: Optional[float] = None
    times: List[float] = dataclasses.field(default_factory=list)
    failed: bool = False


@dataclasses.dataclass
class Tick:
    start: float
    end: float
    prefill_ms: List[float]             # the engine's timings of this tick
    decode_ms: List[float]
    prompts: List[int]                  # prompt lengths admitted
    decode_lengths: List[int]           # cache fill before each decode token
    profiled: bool = False


class Window:
    """One run's window over ``engine`` with the requests of ``traffic``.
    ``tracer`` (or None) is told of each tick and of the close
    (``tracing.Tracer``)."""

    def __init__(self, engine, traffic: Traffic, seconds: float,
                 tracer=None, clock: Callable[[], float] = time.perf_counter,
                 sleep: Callable[[float], None] = time.sleep):
        self.engine, self.traffic, self.seconds = engine, traffic, seconds
        self.tracer, self.clock, self.sleep = tracer, clock, sleep
        self.records: Dict[int, Record] = {}
        self.ticks: List[Tick] = []
        self._inflight: Dict[int, Record] = {}
        self._pending: List = []            # heap of (due, rid, Req)
        self.close = seconds
        self.backlog_at_close = (0, 0)      # (queued, submitted and not done)

    # -- requests -------------------------------------------------------
    def _push(self, req: Req) -> None:
        heapq.heappush(self._pending, (req.due, req.rid, req))

    def _submit_due(self, now: float, before_close: bool = False) -> None:
        from repro_torch.serving import Request
        while self._pending and (self._pending[0][0] < self.seconds
                                 if before_close
                                 else self._pending[0][0] <= now):
            _, _, req = heapq.heappop(self._pending)
            ereq = Request(rid=req.rid, prompt=req.prompt,
                           max_new_tokens=req.out_len)
            self.engine.submit(ereq)
            rec = Record(req, ereq, self.clock() - self.t0)
            self.records[req.rid] = rec
            self._inflight[req.rid] = rec

    def _next_round(self, client: int, rnd: int, due: float) -> None:
        """Closed loop: ``client``'s request of round ``rnd``, due at
        ``due``."""
        while len(self._rounds) <= rnd:
            self._rounds.append(self.traffic.closed_round(len(self._rounds)))
        req = self._rounds[rnd][client]
        req.due = due
        self._push(req)

    # -- one tick -------------------------------------------------------
    def _tick(self, in_window: bool) -> None:
        eng = self.engine
        n_pre = len(eng.timings["prefill_ms"])
        n_dec = len(eng.timings["decode_ms"])
        profiled = self.tracer is not None \
            and self.tracer.before_tick(self.clock() - self.t0)
        start = self.clock() - self.t0
        eng.tick()
        end = self.clock() - self.t0
        tick = Tick(start, end, eng.timings["prefill_ms"][n_pre:],
                    eng.timings["decode_ms"][n_dec:], [], [], profiled)
        for rid, rec in list(self._inflight.items()):
            out = rec.ereq.output
            new = len(out) - len(rec.times)
            if new:
                n = len(rec.times)
                if rec.first is None:
                    rec.first = end
                    tick.prompts.append(len(rec.req.prompt))
                    n += 1
                # decode token j + 1 (1-based) read a cache of P + j - 1
                tick.decode_lengths += [len(rec.req.prompt) + j - 1
                                        for j in range(n, len(out))]
                rec.times += [end] * new
            if rec.ereq.done:
                del self._inflight[rid]
                if rec.ereq.error is not None:
                    rec.failed = True
                if self.traffic.loop == "closed" and in_window \
                        and end < self.seconds:
                    self._next_round(rec.req.client, rec.req.round + 1, end)
        self.ticks.append(tick)
        if self.tracer is not None:
            self.tracer.after_tick(tick)

    # -- the window -----------------------------------------------------
    def run(self) -> "Window":
        self._rounds: List[List[Req]] = []
        if self.traffic.loop == "open":
            for req in self.traffic.open_requests():
                self._push(req)
        else:
            for c in range(int(self.traffic.mix["clients"])):
                self._next_round(c, 0, 0.0)
        eng = self.engine
        self.t0 = self.clock()
        while True:
            now = self.clock() - self.t0
            if now >= self.seconds:
                break
            self._submit_due(now)
            if eng.queue or self._inflight:
                self._tick(True)
            else:
                wait = (self._pending[0][0] if self._pending
                        else self.seconds) - now
                self.sleep(max(0.0, min(wait, self.seconds - now)))
        self.close = self.clock() - self.t0
        self.backlog_at_close = (len(eng.queue), len(self._inflight))
        if self.tracer is not None:
            self.tracer.window_closed()
        self._submit_due(self.close, before_close=True)
        while any(r.first is None and not r.failed
                  for r in self.records.values()) \
                and self.clock() - self.t0 < self.close + DRAIN_S \
                and (eng.queue or self._inflight):
            self._tick(False)
        return self

    # -- what the metrics read ------------------------------------------
    def due_in_window(self) -> List[Record]:
        return [r for r in self.records.values() if r.req.due < self.seconds]

    def failed(self) -> List[Record]:
        return [r for r in self.due_in_window()
                if r.failed or r.first is None]

    def finished(self) -> List:
        """The engine's requests that finished unfailed."""
        return [r.ereq for r in self.records.values()
                if r.ereq.done and not r.failed]

    def window_ticks(self) -> List[Tick]:
        """Ticks that started inside the window."""
        return [t for t in self.ticks if t.start < self.close]
