"""Tasks and task graphs for the AMT executor.

A :class:`Task` is a unit of work — a Python callable (usually closing
over traced JAX values) invoked once by an executor with a
``TaskContext``.  Tasks carry *dependencies* (tasks that must finish
first), a *priority* (higher runs earlier among ready tasks), and
*continuations* (callbacks fired with the task's result when it
retires).  A :class:`TaskGraph` owns a set of tasks and the dependency
bookkeeping the executor schedules from.

The graph is deliberately communication-agnostic: an edge says "B needs
A's result", nothing more.  When an edge is *physically* a message —
e.g. the inter-stage activation transfer of a pipeline — the sending
task posts an LCX operation and suspends; the executor resumes it from
the completion object (see ``executor.py``).
"""
from __future__ import annotations

import enum
import itertools
from typing import Any, Callable, Dict, Iterable, List, Optional


class TaskState(enum.Enum):
    PENDING = "pending"      # waiting on dependencies
    READY = "ready"          # dependencies met, queued for execution
    RUNNING = "running"      # body executing
    BLOCKED = "blocked"      # suspended on a completion object
    DONE = "done"
    FAILED = "failed"


_TASK_IDS = itertools.count()


class Task:
    """A schedulable unit of work with dependencies and continuations."""

    __slots__ = ("tid", "fn", "name", "priority", "state", "result",
                 "error", "deps", "dependents", "n_waiting",
                 "continuations", "_graph", "_suspension")

    def __init__(self, fn: Optional[Callable[..., Any]], *,
                 name: Optional[str] = None, priority: int = 0,
                 deps: Iterable["Task"] = ()) -> None:
        self.tid = next(_TASK_IDS)
        self.fn = fn
        self.name = name or (getattr(fn, "__name__", None)
                             or f"task{self.tid}")
        self.priority = priority
        self.state = TaskState.PENDING
        self.result: Any = None
        self.error: Optional[BaseException] = None
        self.deps: List["Task"] = [d for d in deps if d is not None]
        self.dependents: List["Task"] = []
        self.n_waiting = 0
        self.continuations: List[Callable[[Any], Any]] = []
        self._graph: Optional["TaskGraph"] = None
        # set by TaskContext.suspend: {"k", "need", "events"}
        self._suspension: Optional[Dict[str, Any]] = None

    # -- chaining ------------------------------------------------------------
    def then(self, fn: Callable[[Any], Any], *,
             priority: Optional[int] = None,
             name: Optional[str] = None) -> "Task":
        """Chain a dependent task that runs ``fn(self.result)``."""
        if self._graph is None:
            raise RuntimeError(f"{self!r} is not in a TaskGraph; add it "
                               "before chaining")
        return self._graph.add(
            lambda ctx, _p=self: fn(_p.result),
            deps=(self,), name=name or f"{self.name}.then",
            priority=self.priority if priority is None else priority)

    def on_done(self, fn: Callable[[Any], Any]) -> "Task":
        """Register a lightweight continuation (no new task): ``fn`` is
        invoked with the result at retirement."""
        self.continuations.append(fn)
        return self

    @property
    def done(self) -> bool:
        return self.state is TaskState.DONE

    def __repr__(self) -> str:
        return (f"Task<{self.name}#{self.tid} {self.state.value} "
                f"prio={self.priority}>")


class TaskGraph:
    """Dependency DAG of tasks plus the ready-set bookkeeping."""

    def __init__(self) -> None:
        self.tasks: Dict[int, Task] = {}
        self._n_unfinished = 0

    # -- construction --------------------------------------------------------
    def add(self, fn: Optional[Callable[..., Any]] = None, *,
            deps: Iterable[Task] = (), priority: int = 0,
            name: Optional[str] = None) -> Task:
        task = Task(fn, name=name, priority=priority, deps=deps)
        return self.add_task(task)

    def add_task(self, task: Task) -> Task:
        if task.tid in self.tasks:
            return task
        task._graph = self
        self.tasks[task.tid] = task
        self._n_unfinished += 1
        task.n_waiting = 0
        for dep in task.deps:
            if dep.tid not in self.tasks:
                raise ValueError(f"dependency {dep!r} of {task!r} is not "
                                 "in this graph")
            if dep.state not in (TaskState.DONE, TaskState.FAILED):
                dep.dependents.append(task)
                task.n_waiting += 1
        return task

    # -- scheduling queries --------------------------------------------------
    def newly_ready(self) -> List[Task]:
        """PENDING tasks whose dependencies are all met; marks them READY."""
        out = []
        for t in self.tasks.values():
            if t.state is TaskState.PENDING and t.n_waiting == 0 \
                    and t.fn is not None:
                t.state = TaskState.READY
                out.append(t)
        return out

    def unfinished(self) -> int:
        return self._n_unfinished

    def retire(self, task: Task) -> List[Task]:
        """Mark DONE; return dependents that just became dependency-free."""
        if task.state is TaskState.DONE:
            return []
        task.state = TaskState.DONE
        self._n_unfinished -= 1
        unblocked = []
        for d in task.dependents:
            d.n_waiting -= 1
            if d.n_waiting == 0 and d.state is TaskState.PENDING:
                unblocked.append(d)
        return unblocked

    def fail(self, task: Task, error: BaseException) -> None:
        if task.state in (TaskState.FAILED, TaskState.DONE):
            return  # already settled (e.g. cascade hit it twice)
        task.state = TaskState.FAILED
        task.error = error
        self._n_unfinished -= 1

    def validate_acyclic(self) -> None:
        """Kahn's algorithm over the current graph; raises on a cycle."""
        indeg = {t.tid: sum(1 for d in t.deps
                            if d.state not in (TaskState.DONE,
                                               TaskState.FAILED))
                 for t in self.tasks.values()}
        frontier = [t for t in self.tasks.values() if indeg[t.tid] == 0]
        seen = 0
        while frontier:
            t = frontier.pop()
            seen += 1
            for d in t.dependents:
                indeg[d.tid] -= 1
                if indeg[d.tid] == 0:
                    frontier.append(d)
        if seen != len(self.tasks):
            cyclic = [t.name for t in self.tasks.values()
                      if indeg[t.tid] > 0]
            raise ValueError(f"task graph has a cycle through {cyclic}")

    def __len__(self) -> int:
        return len(self.tasks)
