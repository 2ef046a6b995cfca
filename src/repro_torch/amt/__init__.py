"""AMT — an asynchronous many-task executor layered on LCX.

The paper argues that a lightweight communication interface earns its
keep when an asynchronous many-task runtime drives it.  This package is
that runtime for the repo: :class:`TaskGraph` DAGs of fine-grained
tasks, a completion-driven :class:`Executor` whose worker loop
interleaves task execution with explicit ``lcx.progress()`` and retires
communication-suspended tasks from completion objects (never blocking
waits).  ``RemoteSpawner`` (``repro/amt/remote.py``) comes with a later
slice.

Client in the port: the serving engine
(:class:`repro_torch.serving.ServingEngine`) admits prefill/decode work
through an executor.  See ``docs/amt.md`` for the executor ↔
completion-object contract.
"""
from .task import Task, TaskGraph, TaskState
from .executor import (DependencyError, Executor, PENDING, TaskContext,
                       TaskStatus)

__all__ = [
    "Task", "TaskGraph", "TaskState",
    "DependencyError", "Executor", "PENDING", "TaskContext", "TaskStatus",
]
