"""Serving engine: slot-based KV cache with continuous batching.

The port of ``repro/serving/engine.py``.  The engine owns ``n_slots``
sequences sharing one pre-allocated cache
(:func:`repro_torch.models.init_cache`).  New requests prefill into free
slots at their exact length; every decode tick advances all slots with
one batched :func:`~repro_torch.models.decode_step` that takes one cache
length per slot (the reference ``vmap``s a scalar-length decode over the
slots instead).  Positions, the cache row written and the
``k_pos <= length`` mask are all per slot.  Mamba layers carry a
recurrent state (``conv``, ``h``) per slot instead of KV rows: a prefill
overwrites the slot's whole state, and the batched decode advances every
slot's state, free slots too, as the reference's vmapped decode does
(harmless: the slot's next prefill overwrites it).

Scheduling: each ``tick`` is driven through an AMT executor
(:class:`repro_torch.amt.Executor`) on a private LCX runtime: one
admission task per queued request (priority = arrival order) and one
decode task depending on all of them.  ``use_executor=False`` keeps the
inline loop.  With ``failover=True`` or a ``heartbeat``, a warm standby
device joins the serving device's axis and a
:class:`~repro_torch.runtime.HeartbeatMonitor` (by default
``on_dead="failover"``) watches the engine's LCX runtime: if the serving
device stops beating mid-stream, its endpoints and in-flight traffic
migrate to a survivor and the executor re-dispatches the affected tasks.

Besides ``stats`` (the reference's counters), ``timings`` keeps the
host time of every prefill and decode tick in milliseconds; both end
in a device-to-host copy of the sampled tokens, which waits for the
device.

``trace`` (:class:`repro_torch.trace.Trace`, on by default;
``trace=False`` records nothing) holds a span of each layer boundary,
nested in this order: ``engine.tick`` (one ``tick()``: the requests
``queued`` at its start, the ``live`` slots at its end), the executor's
``amt.run`` and ``amt.task`` spans (see
:class:`~repro_torch.amt.Executor`), ``engine.admit`` (one admission:
``rid``; its queue wait is the span's start less ``submitted_at``) and
``engine.decode`` (one decode tick: ``live`` slots).  Inside an
admission, ``prefill.dispatch`` (the prompt's host-to-device copy,
``prefill`` and ``sample_token``, returning before the first token is
copied back: ``prompt`` length) and ``prefill.sync`` (that copy: the
host waiting for the card); inside a decode tick, ``decode.prepare``
(the token array and the copies of tokens and lengths to the card),
``decode.dispatch`` (``decode_step`` and ``sample_token``),
``decode.sync`` (the copy of the sampled tokens back) and
``decode.bookkeeping`` (the per-slot loop: requests ``finished``).  The
phases share their boundaries' clock reads with ``timings``:
``prefill_ms`` is dispatch + sync, ``decode_ms`` is prepare + dispatch +
sync, exactly.  A dispatch span is the host's enqueueing only while the
card keeps up: once the card's launch queue is full, each launch waits
in it for the card, and the sync that follows reads only the queue's
drain.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .. import core as lcx
from ..amt import Executor
from ..device import DeviceLike, resolve_device
from ..models import decode_step, init_cache, prefill
from ..models.model import slot_view
from ..runtime.fault import HeartbeatMonitor
from ..trace import Trace, now_ns

PyTree = Any


@dataclasses.dataclass
class ServeConfig:
    n_slots: int = 8
    max_seq: int = 512
    temperature: float = 0.0          # 0 = greedy
    eos_token: Optional[int] = None
    max_new_tokens: int = 64
    seed: int = 0


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                 # [P] int32
    max_new_tokens: Optional[int] = None
    # filled by the engine:
    output: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    error: Optional[str] = None        # set when the request was evicted
    submitted_at: float = 0.0
    finished_at: float = 0.0


def sample_token(logits: torch.Tensor, temperature: float,
                 generator: torch.Generator) -> torch.Tensor:
    """logits [B, V] -> tokens [B] (int32).  Greedy is the first maximum,
    as ``jnp.argmax``; otherwise a categorical draw from ``generator``."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)


class ServingEngine:
    def __init__(self, cfg: Any, params: PyTree, scfg: ServeConfig,
                 kernels: Optional[Dict[str, Any]] = None, *,
                 use_executor: bool = True,
                 lcx_runtime: Optional[Any] = None,
                 lcx_device: Optional[Any] = None,
                 failover: bool = False,
                 heartbeat: Optional[Any] = None,
                 device: DeviceLike = None,
                 trace: bool = True) -> None:
        self.device = resolve_device(device)
        self.trace = Trace(enabled=trace)
        self.cfg = cfg
        self.params = params
        self.scfg = scfg
        self.kernels = kernels
        self.heartbeat: Optional[Any] = heartbeat
        self.standby_device: Optional[Any] = None
        if use_executor:
            # The engine owns a private LCX runtime unless the application
            # injects one, so its admission traffic never mixes with the
            # process-global default runtime.
            if lcx_runtime is None and lcx_device is not None:
                lcx_runtime = lcx_device.runtime
            if lcx_runtime is None:
                lcx_runtime = lcx.Runtime(name="serving")
            self.lcx_runtime: Optional[Any] = lcx_runtime
            self._executor: Optional[Executor] = Executor(
                name="serving", runtime=lcx_runtime, device=lcx_device,
                trace=self.trace if self.trace.enabled else None)
            if failover or heartbeat is not None:
                # Warm standby on the serving device's axis: if the
                # heartbeat declares the primary dead mid-stream, its
                # endpoints and in-flight admission traffic migrate here
                # and the executor re-dispatches the affected tasks.
                primary = self._executor.device
                self.standby_device = lcx_runtime.device(axis=primary.axis)
                if self.heartbeat is None:
                    self.heartbeat = HeartbeatMonitor(on_dead="failover")
                self.heartbeat.attach(lcx_runtime)
        else:
            self.lcx_runtime = lcx_runtime
            self._executor = None
        self.caches = init_cache(cfg, scfg.n_slots, scfg.max_seq,
                                 device=self.device)
        self.lengths = np.zeros((scfg.n_slots,), np.int32)
        self.slot_req: List[Optional[Request]] = [None] * scfg.n_slots
        self.queue: List[Request] = []
        self.finished: List[Request] = []
        self.failed: List[Request] = []
        self._gen = torch.Generator(device=self.device).manual_seed(
            scfg.seed)
        self.stats = {"ticks": 0, "prefills": 0, "decoded_tokens": 0,
                      "evictions": 0}
        self.timings: Dict[str, List[float]] = {"prefill_ms": [],
                                                "decode_ms": []}

    # -- request intake ------------------------------------------------------
    def submit(self, req: Request) -> None:
        req.submitted_at = time.perf_counter()
        self.queue.append(req)

    def _free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.slot_req) if r is None]

    def _admit(self) -> None:
        while self._free_slots() and self.queue:
            self._admit_one(self.queue.pop(0))

    def _evict(self, req: Request, reason: str) -> None:
        """Terminally fail ``req`` without touching slot state: the tick
        loop keeps serving the other slots instead of wedging."""
        req.done = True
        req.error = reason
        req.finished_at = time.perf_counter()
        self.finished.append(req)
        self.failed.append(req)
        self.stats["evictions"] += 1

    def _finish(self, req: Request, slot: int) -> None:
        req.done = True
        req.finished_at = time.perf_counter()
        self.finished.append(req)
        self.slot_req[slot] = None
        self.lengths[slot] = 0

    def _admit_one(self, req: Request) -> bool:
        """Prefill ``req`` into a free slot.  Returns False when no slot
        is free (caller re-queues); True when the request was placed or
        terminally handled (including eviction on prefill failure)."""
        free = self._free_slots()
        if not free:
            return False
        slot = free[0]
        plen = len(req.prompt)
        if plen >= self.scfg.max_seq:
            self._evict(req, f"prompt length {plen} >= max_seq "
                             f"{self.scfg.max_seq}")
            return True
        with self.trace.span("engine.admit", rid=req.rid):
            t0 = now_ns()
            try:
                tok = self._dispatch_prefill(req.prompt, slot)
            except Exception as e:
                self._evict(req, f"prefill failed: {type(e).__name__}: {e}")
                return True
            t1 = now_ns()
            tok = int(tok[0])
            t2 = now_ns()
            self.timings["prefill_ms"].append((t2 - t0) / 1e6)
            self.trace.add("prefill.dispatch", t0, t1, prompt=plen)
            self.trace.add("prefill.sync", t1, t2)
            self.lengths[slot] = plen
            self.slot_req[slot] = req
            self.stats["prefills"] += 1
            req.output.append(tok)
            self.stats["decoded_tokens"] += 1
            # the first token may already terminate the request
            limit = req.max_new_tokens or self.scfg.max_new_tokens
            if (self.scfg.eos_token is not None
                    and tok == self.scfg.eos_token) \
                    or len(req.output) >= limit:
                self._finish(req, slot)
        return True

    def _dispatch_prefill(self, prompt: np.ndarray,
                          slot: int) -> torch.Tensor:
        """Enqueue ``prompt``'s prefill into ``slot`` and the sampling of
        its first token, which stays on the device (``prefill.dispatch``).
        A failed prefill may leave the slot's cache half written: KV rows
        past the slot's length are masked, an SSM state is masked by
        nothing, and both are overwritten by the slot's next prefill."""
        toks = torch.as_tensor(np.asarray(prompt, np.int64),
                               device=self.device)[None]
        # exact-length prefill straight into the slot's cache
        lg, _ = prefill(self.cfg, self.params, toks,
                        slot_view(self.cfg, self.caches, slot),
                        kernels=self.kernels)
        # sample the first generated token from the prefill logits
        return sample_token(lg[:, -1], self.scfg.temperature, self._gen)

    # -- decode tick ----------------------------------------------------------
    def tick(self) -> int:
        """Admit + one decode step for all active slots.  Returns the
        number of live slots advanced.

        With an executor, admission and decode run as a per-tick task
        graph: one prefill-admission task per queued request (priority
        keeps arrival order) feeding one decode task."""
        with self.trace.span("engine.tick",
                             queued=len(self.queue)) as span:
            if self._executor is not None:
                live = self._tick_executor()
            else:
                self._admit()
                live = self._decode_tick()
            span.set(live=len(self.slot_req) - self.slot_req.count(None))
        return live

    def _tick_executor(self) -> int:
        ex = self._executor
        queued, self.queue = list(self.queue), []
        admissions = []
        for k, req in enumerate(queued):
            def admit(ctx, _req=req):
                if not self._admit_one(_req):
                    self.queue.append(_req)   # no free slot: re-queue

            admissions.append(ex.spawn(
                admit, priority=len(queued) - k,
                name=f"prefill:{req.rid}"))
        decode = ex.spawn(lambda ctx: self._decode_tick(),
                          deps=tuple(admissions), priority=-1,
                          name="decode")
        ex.run()
        return decode.result

    def _decode_tick(self) -> int:
        active = [i for i, r in enumerate(self.slot_req) if r is not None]
        if not active:
            return 0
        with self.trace.span("engine.decode", live=len(active)):
            t0 = now_ns()
            tokens = np.zeros((self.scfg.n_slots, 1), np.int64)
            for i in active:
                req = self.slot_req[i]
                tokens[i, 0] = req.output[-1] if req.output \
                    else req.prompt[-1]
            tokens = torch.as_tensor(tokens, device=self.device)
            lengths = torch.as_tensor(self.lengths, device=self.device)
            t1 = now_ns()
            nxt = self._dispatch_decode(tokens, lengths)
            t2 = now_ns()
            nxt = nxt.cpu().numpy()
            t3 = now_ns()
            self.timings["decode_ms"].append((t3 - t0) / 1e6)
            self.stats["ticks"] += 1
            finished = 0
            for i in active:
                req = self.slot_req[i]
                self.lengths[i] += 1
                tok = int(nxt[i])
                req.output.append(tok)
                self.stats["decoded_tokens"] += 1
                limit = req.max_new_tokens or self.scfg.max_new_tokens
                if (self.scfg.eos_token is not None
                        and tok == self.scfg.eos_token) \
                        or len(req.output) >= limit \
                        or self.lengths[i] >= self.scfg.max_seq - 1:
                    self._finish(req, i)
                    finished += 1
            tr = self.trace
            tr.add("decode.prepare", t0, t1)
            tr.add("decode.dispatch", t1, t2)
            tr.add("decode.sync", t2, t3)
            tr.add("decode.bookkeeping", t3, now_ns(), finished=finished)
        return len(active)

    def _dispatch_decode(self, tokens: torch.Tensor,
                         lengths: torch.Tensor) -> torch.Tensor:
        """Enqueue one decode step of every slot and the sampling of its
        tokens, which stay on the device (``decode.dispatch``)."""
        lg, _ = decode_step(self.cfg, self.params, tokens, self.caches,
                            lengths, kernels=self.kernels)
        return sample_token(lg[:, 0], self.scfg.temperature, self._gen)

    def run_until_drained(self, max_ticks: int = 10000) -> List[Request]:
        for _ in range(max_ticks):
            if not self.queue and all(r is None for r in self.slot_req):
                break
            self.tick()
        return self.finished
