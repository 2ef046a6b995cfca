"""AMT — an asynchronous many-task executor layered on LCX.

The paper argues that a lightweight communication interface earns its
keep when an asynchronous many-task runtime drives it.  This package is
that runtime for the repo: :class:`TaskGraph` DAGs of fine-grained
tasks, a completion-driven :class:`Executor` whose worker loop
interleaves task execution with explicit ``lcx.progress()`` and retires
communication-suspended tasks from completion objects (never blocking
waits).  :class:`RemoteSpawner` spawns tasks on peer ranks over LCX
active messages and resolves a promise with the peer's reply.

Client in the port: the serving engine
(:class:`repro_torch.serving.ServingEngine`) admits prefill/decode work
through an executor.  See ``docs/amt.md`` for the executor ↔
completion-object contract.
"""
from .task import Task, TaskGraph, TaskState
from .executor import (DependencyError, Executor, PENDING, TaskContext,
                       TaskStatus)
from .remote import (RemoteFailure, RemoteSpawner, clear_task_handlers,
                     register_task_handler, task_handler)

__all__ = [
    "Task", "TaskGraph", "TaskState",
    "DependencyError", "Executor", "PENDING", "TaskContext", "TaskStatus",
    "RemoteFailure", "RemoteSpawner", "clear_task_handlers",
    "register_task_handler", "task_handler",
]
