"""Completion-driven task executor on top of LCX.

This is the runtime the paper's interface was designed *for*: an
asynchronous many-task scheduler whose worker loop interleaves
ready-task execution with explicit ``lcx.progress()`` calls, and which
retires communication-blocked tasks from **completion objects** — a
:class:`~repro_torch.core.resources.CompletionQueue` drained after each
progress call, plus :class:`~repro_torch.core.resources.FunctionHandler`
callbacks fired *by* progress — never from blocking/polling waits.

Execution protocol
------------------
A task body receives a :class:`TaskContext`.  To communicate it posts
LCX operations through the context (``ctx.put`` / ``ctx.am`` /
``ctx.send`` / ``ctx.recv``), which route the operation's completion to
the executor's retirement queue with the task recorded as the event
context.  A body that must wait for arrivals returns
``ctx.suspend(k, n_events=...)``: the task parks as BLOCKED and the
executor calls ``k`` with the event(s) once progress has signalled them,
using ``k``'s return value as the task result.

Tracing
-------
``Executor(trace=...)`` takes a :class:`repro_torch.trace.Trace` (off,
``None``, by default: the serving engine passes its own).  With one,
each ``run()`` is an ``amt.run`` span whose attributes count the tasks
it ran (``tasks_run``), its ``progress_calls`` and the tasks the graph
holds at its end (``graph_tasks``: the graph keeps every task ever
spawned, and each ``run()`` walks them all), and each task body
executed is an ``amt.task`` span under it (attribute ``task``: the
task's name).  The executor's self time is ``amt.run`` less its
``amt.task`` spans.

Backpressure
------------
Admission from the ready heap is gated on the depth of the pending
transfer ledger: when more matched-but-unprogressed transfers are
outstanding than the packet pool has packets (or ``max_inflight``), the
executor drives progress instead of admitting more work — the AMT
analogue of LCI's packet-pool exhaustion pushing back on senders.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import Any, Callable, Dict, List, Optional, Tuple

import repro_torch.core as lcx

from ..trace import Trace
from .task import Task, TaskGraph, TaskState


class _Pending:
    """Sentinel returned by :meth:`TaskContext.suspend`."""

    def __repr__(self) -> str:  # pragma: no cover
        return "<pending>"


PENDING = _Pending()


@dataclasses.dataclass
class TaskStatus:
    """Per-task fault record kept by the executor in graceful mode.

    ``state`` is ``"ok"`` (never failed), ``"retrying"`` (failed but
    requeued with backoff), ``"failed"`` (retries exhausted, in the
    dead-letter list), or ``"cascade"`` (a dependency failed, so the
    task can never run).
    """

    task: Task
    attempts: int = 0
    state: str = "ok"
    error: Optional[BaseException] = None


class DependencyError(RuntimeError):
    """Raised into a task's error slot when a dependency dead-letters."""


class TaskContext:
    """Handed to every task body; the task's view of the executor."""

    def __init__(self, executor: "Executor", task: Task) -> None:
        self.executor = executor
        self.task = task

    # -- communication posting ----------------------------------------------
    def put(self, buffer: Any, perm: Optional[lcx.Perm] = None, *,
            tag: int = 0, device: Optional[lcx.Device] = None,
            allow_aggregation: bool = True, timeout: Optional[int] = None,
            max_retries: int = 0) -> None:
        """Post a one-sided put whose *remote* completion retires through
        the executor (the receiving side's suspended task resumes)."""
        ex = self.executor
        dev = device or ex.device
        lcx.put_x(buffer).perm(perm).tag(tag) \
            .remote_comp(ex.cq).ctx(self.task) \
            .runtime(ex._runtime).endpoint(None if device else ex.endpoint) \
            .device(dev).allow_aggregation(allow_aggregation) \
            .timeout(timeout).max_retries(max_retries)()
        ex._note_post()

    def am(self, buffer: Any, perm: Optional[lcx.Perm] = None, *,
           tag: int = 0, remote_comp: Optional[Any] = None,
           context: Any = None,
           device: Optional[lcx.Device] = None) -> None:
        """Post an active message.  Defaults the remote completion to the
        executor's retirement queue with this task as context."""
        ex = self.executor
        dev = device or ex.device
        lcx.am_x(buffer).perm(perm).tag(tag) \
            .remote_comp(remote_comp or ex.cq) \
            .runtime(ex._runtime).endpoint(None if device else ex.endpoint) \
            .ctx(self.task if context is None else context).device(dev)()
        ex._note_post()

    def send(self, buffer: Any, perm: Optional[lcx.Perm] = None, *,
             tag: int = 0, device: Optional[lcx.Device] = None,
             timeout: Optional[int] = None, max_retries: int = 0) -> None:
        ex = self.executor
        dev = device or ex.device
        lcx.send_x(buffer).perm(perm).tag(tag).comp(ex.cq) \
            .ctx(self.task).device(dev) \
            .runtime(ex._runtime).endpoint(None if device else ex.endpoint) \
            .timeout(timeout).max_retries(max_retries)()
        ex._note_post()

    def recv(self, like: Any, perm: Optional[lcx.Perm] = None, *,
             tag: int = 0, device: Optional[lcx.Device] = None,
             timeout: Optional[int] = None, max_retries: int = 0) -> None:
        ex = self.executor
        dev = device or ex.device
        lcx.recv_x(like).perm(perm).tag(tag).comp(ex.cq) \
            .ctx(self.task).device(dev) \
            .runtime(ex._runtime).endpoint(None if device else ex.endpoint) \
            .timeout(timeout).max_retries(max_retries)()
        ex._note_post()

    # -- suspension ----------------------------------------------------------
    def suspend(self, k: Optional[Callable[..., Any]] = None,
                n_events: int = 1) -> _Pending:
        """Park this task until ``n_events`` completion events with this
        task as context have been retired; then run ``k(event)`` (or
        ``k(events)`` for n_events > 1) as the task result."""
        self.task._suspension = {"k": k, "need": int(n_events),
                                 "events": []}
        return PENDING

    # -- dynamic graph growth -------------------------------------------------
    def spawn(self, fn: Callable[..., Any], *, deps: Tuple[Task, ...] = (),
              priority: int = 0, name: Optional[str] = None) -> Task:
        return self.executor.spawn(fn, deps=deps, priority=priority,
                                   name=name)


class Executor:
    """Single-threaded (per-rank) completion-driven task scheduler.

    One executor per SPMD rank trace.  Tasks run in priority order
    (higher first, FIFO within a priority); communication-suspended
    tasks retire from the executor's CompletionQueue after each
    ``lcx.progress()``; watched completion objects (Synchronizer /
    CounterCompletion / custom ``signal`` overloads) resolve promise
    tasks the same way.
    """

    def __init__(self, device: Optional[lcx.Device] = None,
                 pool: Optional[lcx.PacketPool] = None,
                 graph: Optional[TaskGraph] = None, *,
                 runtime: Optional[lcx.Runtime] = None,
                 endpoint: Optional[lcx.Endpoint] = None,
                 progress_every: int = 8,
                 adaptive_progress: bool = True,
                 max_inflight: Optional[int] = None,
                 cq: Optional[lcx.CompletionQueue] = None,
                 fail_fast: bool = True,
                 max_task_retries: int = 0,
                 task_retry_backoff: int = 1,
                 name: str = "amt",
                 trace: Optional[Trace] = None) -> None:
        self.name = name
        self.trace = trace
        # Graceful degradation: with fail_fast=False a task exception is
        # recorded in ``task_status`` and the task is retried with
        # exponential backoff up to ``max_task_retries`` times, then
        # dead-lettered (its dependents cascade-fail) — the loop keeps
        # running instead of tearing down.
        self.fail_fast = fail_fast
        self.max_task_retries = max_task_retries
        self.task_retry_backoff = max(1, task_retry_backoff)
        self.dead_letter: List[Task] = []
        self.task_status: Dict[int, TaskStatus] = {}
        self._deferred: List[Tuple[int, int, Task]] = []  # (cycle, tie, task)
        # Resource injection (library-interop pattern): an executor given
        # an explicit runtime / endpoint / device keeps all its traffic on
        # those resources; with none it shares the global default runtime
        # (lazily created) so independently constructed executors can
        # still exchange active messages.
        self.endpoint = endpoint
        if device is None and endpoint is not None:
            device = endpoint.device
        if runtime is None:
            if endpoint is not None and endpoint.runtime is not None:
                runtime = endpoint.runtime
            elif device is not None and device.runtime is not None:
                runtime = device.runtime
        self._runtime = runtime
        if device is None and runtime is not None:
            device = runtime.default_device
        self._device = device if device is not None else lcx.Device()
        self.pool = pool
        self.graph = graph or TaskGraph()
        self.cq = cq if cq is not None else lcx.CompletionQueue()
        self.progress_every = max(1, progress_every)
        # Adaptive interval: doubles (up to 16x) each time a progress
        # call retires nothing, snaps back to ``progress_every`` as soon
        # as one retires something — idle polling backs off, busy phases
        # keep the configured cadence.
        self.adaptive_progress = adaptive_progress
        self._progress_interval = self.progress_every
        self._max_interval = self.progress_every * 16
        if max_inflight is None:
            if pool is not None:
                max_inflight = pool.get_attr_npackets()
            else:
                max_inflight = self.device.get_attr_max_inflight()
        self.max_inflight = max_inflight
        self.stats: Dict[str, int] = {
            "tasks_run": 0, "tasks_resumed": 0, "progress_calls": 0,
            "events_retired": 0, "backpressure_stalls": 0,
            "backpressure_deferrals": 0, "progress_backoffs": 0,
            "watch_fires": 0, "cycles": 0, "tasks_failed": 0,
            "task_retries": 0, "tasks_redispatched": 0,
        }
        self._heap: List[Tuple[int, int, Task]] = []
        self._tie = itertools.count()
        self._posted_since_progress = 0
        # (comp, k, promise) triples checked after each progress call
        self._watches: List[Tuple[Any, Callable[[Any], Any], Task]] = []
        self._activity = 0

    @property
    def runtime(self) -> lcx.Runtime:
        """The runtime this executor posts/progresses against (injected,
        else the global default)."""
        return self._runtime if self._runtime is not None else lcx.runtime()

    @property
    def device(self) -> lcx.Device:
        """The executor's posting device, following the failover
        forwarding chain: after ``runtime.failover(dev)`` the executor
        transparently posts on the survivor."""
        dev = self._device
        if dev.migrated_to is not None:
            dev = dev.resolve_migrated()
            self._device = dev
        return dev

    # -- submission -----------------------------------------------------------
    def spawn(self, fn: Callable[..., Any], *,
              deps: Tuple[Task, ...] = (), priority: int = 0,
              name: Optional[str] = None) -> Task:
        task = self.graph.add(fn, deps=deps, priority=priority, name=name)
        if task.n_waiting == 0:
            task.state = TaskState.READY
            self._push(task)
        self._activity += 1
        return task

    def submit(self, task: Task) -> Task:
        self.graph.add_task(task)
        if task.n_waiting == 0 and task.fn is not None:
            task.state = TaskState.READY
            self._push(task)
        self._activity += 1
        return task

    def promise(self, name: str = "promise") -> Task:
        """A task with no body, resolved externally (reply arrival,
        watched completion object, ...)."""
        task = self.graph.add(None, name=name)
        task.state = TaskState.BLOCKED
        return task

    def resolve_promise(self, task: Task, value: Any = None) -> None:
        self._retire(task, value)

    def watch(self, comp: Any,
              k: Optional[Callable[[Any], Any]] = None,
              name: str = "watch") -> Task:
        """Resolve a promise when ``comp.ready()`` becomes true (checked
        after every progress call).  ``k(comp)`` supplies the value."""
        promise = self.promise(name=name)
        self._watches.append((comp, k or (lambda c: c), promise))
        return promise

    # -- worker loop -----------------------------------------------------------
    def run(self, max_cycles: int = 100000) -> Dict[str, int]:
        """Drain the graph: execute ready tasks, interleave progress,
        retire completions.  Raises on deadlock (blocked tasks that no
        amount of progress can unblock)."""
        if self.trace is None:
            return self._run(max_cycles)
        ran, progressed = (self.stats["tasks_run"],
                           self.stats["progress_calls"])
        with self.trace.span("amt.run") as span:
            stats = self._run(max_cycles)
            span.set(tasks_run=stats["tasks_run"] - ran,
                     progress_calls=stats["progress_calls"] - progressed,
                     graph_tasks=len(self.graph))
        return stats

    def _run(self, max_cycles: int) -> Dict[str, int]:
        for t in self.graph.newly_ready():
            self._push(t)
        for _ in range(max_cycles):
            self.stats["cycles"] += 1
            before = self._activity
            self._release_deferred()
            while self._heap:
                deferred = False
                # Per-device backpressure: gate admission on the POSTING
                # device's pending depth (its packet pool), not the
                # runtime-wide ledger — a busy neighbour device must not
                # stall this executor's admission (docs/resources.md).
                while self.runtime.pending_for(self.device) \
                        >= self.max_inflight:
                    self.stats["backpressure_stalls"] += 1
                    pending_before = self.runtime.pending_for(self.device)
                    self._progress_and_retire()
                    if self.runtime.pending_for(self.device) >= pending_before:
                        # progress could not shrink the ledger — admitting
                        # more work would only deepen it; defer until the
                        # outer flush (or an external drain) frees packets
                        self.stats["backpressure_deferrals"] += 1
                        deferred = True
                        break
                if deferred:
                    break
                task = self._pop()
                if task is None:
                    break
                self._execute(task)
                if self._posted_since_progress >= self._progress_interval:
                    self._progress_and_retire()
            # Flush communication even when no task is runnable — an
            # arriving message may spawn work (active-message handlers).
            self._progress_and_retire()
            if not self.graph.unfinished():
                break
            if self._activity == before:
                if self._deferred or self.runtime.has_inflight():
                    # Not a deadlock: backed-off task retries and/or comm
                    # retries/timeouts are still pending — keep driving
                    # progress so their tick deadlines can elapse.
                    continue
                stuck = [t for t in self.graph.tasks.values()
                         if t.state in (TaskState.PENDING, TaskState.READY,
                                        TaskState.BLOCKED)]
                raise RuntimeError(
                    f"executor {self.name!r} deadlocked with "
                    f"{self.graph.unfinished()} unfinished tasks: "
                    f"{stuck[:8]}")
        else:
            raise RuntimeError(f"executor {self.name!r}: max_cycles "
                               "exceeded")
        return dict(self.stats)

    # -- internals -------------------------------------------------------------
    def _note_post(self) -> None:
        self._posted_since_progress += 1

    def _push(self, task: Task) -> None:
        heapq.heappush(self._heap, (-task.priority, next(self._tie), task))

    def _pop(self) -> Optional[Task]:
        while self._heap:
            _, _, task = heapq.heappop(self._heap)
            if task.state is TaskState.READY:
                return task
        return None

    def _execute(self, task: Task) -> None:
        task.state = TaskState.RUNNING
        ctx = TaskContext(self, task)
        try:
            if self.trace is None:
                out = task.fn(ctx)
            else:
                with self.trace.span("amt.task", task=task.name):
                    out = task.fn(ctx)
        except BaseException as e:
            if self.fail_fast or not isinstance(e, Exception):
                self.graph.fail(task, e)
                raise
            self._handle_failure(task, e)
            return
        self.stats["tasks_run"] += 1
        self._activity += 1
        if out is PENDING:
            task.state = TaskState.BLOCKED
        else:
            self._retire(task, out)

    # -- graceful degradation ---------------------------------------------------
    def status_of(self, task: Task) -> TaskStatus:
        st = self.task_status.get(task.tid)
        if st is None:
            st = self.task_status[task.tid] = TaskStatus(task)
        return st

    def _handle_failure(self, task: Task, error: Exception) -> None:
        st = self.status_of(task)
        st.attempts += 1
        st.error = error
        self._activity += 1
        if st.attempts <= self.max_task_retries:
            st.state = "retrying"
            self.stats["task_retries"] += 1
            delay = self.task_retry_backoff * (1 << (st.attempts - 1))
            task.state = TaskState.PENDING
            heapq.heappush(self._deferred,
                           (self.stats["cycles"] + delay, next(self._tie),
                            task))
            return
        st.state = "failed"
        self.dead_letter.append(task)
        self._fail_task(task, error)

    def _fail_task(self, task: Task, error: BaseException) -> None:
        """Settle ``task`` as FAILED and cascade to dependents that can
        now never run (their error records why)."""
        if task.state in (TaskState.DONE, TaskState.FAILED):
            return
        self.graph.fail(task, error)
        self.stats["tasks_failed"] += 1
        self._activity += 1
        for dep in task.dependents:
            if dep.state in (TaskState.DONE, TaskState.FAILED):
                continue
            st = self.status_of(dep)
            st.state = "cascade"
            cascade = DependencyError(
                f"dependency {task.name!r} failed: {error!r}")
            st.error = cascade
            self._fail_task(dep, cascade)

    def _release_deferred(self) -> None:
        while self._deferred and self._deferred[0][0] <= self.stats["cycles"]:
            _, _, task = heapq.heappop(self._deferred)
            if task.state is TaskState.PENDING:
                task.state = TaskState.READY
                self._push(task)
                self._activity += 1

    def _retire(self, task: Task, result: Any) -> None:
        task.result = result
        for k in task.continuations:
            k(result)
        for ready in self.graph.retire(task):
            ready.state = TaskState.READY
            self._push(ready)
        self._activity += 1

    def _progress_and_retire(self) -> int:
        op = lcx.progress_x().runtime(self._runtime)
        if self.pool is not None:
            op = op.pool(self.pool)
        op()
        self.stats["progress_calls"] += 1
        self._posted_since_progress = 0
        # Batched retirement: ONE completion-queue drain per progress
        # call.  Events are first sorted into their suspended tasks; the
        # tasks whose event count is met resume in a single second pass
        # (resumptions may spawn/post, so they must not interleave with
        # the drain itself).
        events = self.cq.pop_all()
        n = len(events)
        self.stats["events_retired"] += n
        resumable: List[Task] = []
        redispatch: List[Task] = []
        for ev in events:
            task = ev.context
            if not isinstance(task, Task):
                continue  # foreign traffic on a shared queue
            if ev.migrated and ev.status is lcx.ErrorCode.RETRY \
                    and task.state is TaskState.BLOCKED:
                # Device failover could not replay this op on the
                # survivor (axis mismatch / replay disabled): re-dispatch
                # the suspended task so it re-posts on the migrated
                # device — a healthy task, not a dead-letter.
                if task not in redispatch:
                    redispatch.append(task)
                continue
            susp = task._suspension
            if susp is None or len(susp["events"]) >= susp["need"]:
                continue  # not suspended / already satisfied this batch
            susp["events"].append(ev)
            if len(susp["events"]) == susp["need"]:
                resumable.append(task)
        for task in redispatch:
            task._suspension = None
            task.state = TaskState.READY
            self._push(task)
            self.stats["tasks_redispatched"] += 1
            self._activity += 1
        for task in resumable:
            susp = task._suspension
            task._suspension = None
            k = susp["k"]
            evs = susp["events"]
            value = None
            if k is not None:
                value = k(evs[0]) if susp["need"] == 1 else k(evs)
            self.stats["tasks_resumed"] += 1
            self._retire(task, value)
        # Resolve watched completion objects (threshold counters etc.).
        still = []
        for comp, k, promise in self._watches:
            if getattr(comp, "ready", lambda: False)():
                self.stats["watch_fires"] += 1
                n += 1
                self.resolve_promise(promise, k(comp))
            else:
                still.append((comp, k, promise))
        self._watches = still
        # Adaptive back-off: a progress call that retires nothing widens
        # the posting interval; any retirement snaps it back.
        if self.adaptive_progress:
            if n == 0:
                if self._progress_interval < self._max_interval:
                    self._progress_interval = min(
                        self._progress_interval * 2, self._max_interval)
                    self.stats["progress_backoffs"] += 1
            else:
                self._progress_interval = self.progress_every
        return n
