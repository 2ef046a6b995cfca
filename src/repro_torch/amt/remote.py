"""Remote task spawning over LCX active messages (the port of
``repro/amt/remote.py``).

A task handler is registered *by name* on every rank (SPMD: the same
registration code runs everywhere, so the table is identical — the
trace-time analogue of LCI's remote-completion-handler registry).
:meth:`RemoteSpawner.spawn` posts an ``am_x`` carrying the argument
payload toward the peer selected by ``perm``; at the destination the
message's :class:`~repro_torch.core.resources.FunctionHandler` remote
completion fires during ``progress()`` and enqueues an *execution task*
on the destination executor.  If a reply is requested, that execution
task posts a second active message back along the inverse permutation,
resolving the promise the spawner returned.

Because ranks run in lockstep, reply-correlation ids advance
identically on every rank; the id in the (locally traced) event context
therefore names the same logical spawn on sender and receiver.

Rank model (:mod:`repro_torch.core.ranks`): on a device with an axis the
payload is rank-stacked, ``[n_ranks, ...]``, and a handler runs once on
the stacked payload that arrived (row i is what rank i received).  An
error reply carries a dummy rank-stacked ``zeros(n_ranks)`` on the
arriving payload's torch device.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Callable, Dict, Optional

import torch

from .. import core as lcx

from .executor import Executor
from .task import Task

_HANDLERS: Dict[str, Callable[[Any], Any]] = {}


@dataclasses.dataclass
class RemoteFailure:
    """Error result of a remote spawn — the reply-side analogue of a
    non-ok :class:`~repro_torch.core.resources.ErrorCode`.

    Delivered as the promise's *value* (never raised from inside
    ``progress()``): an unregistered handler or a handler that raised on
    the peer resolves the spawner's promise with one of these instead of
    wedging it forever.
    """

    handler: str
    status: str            # "unknown_handler" | "handler_error"
    message: str = ""

    @property
    def ok(self) -> bool:
        return False


def register_task_handler(name: str, fn: Callable[[Any], Any]) -> str:
    """Register ``fn`` under ``name`` (must run on every rank)."""
    _HANDLERS[name] = fn
    return name


def task_handler(name: Optional[str] = None):
    """Decorator form of :func:`register_task_handler`."""

    def deco(fn: Callable[[Any], Any]) -> Callable[[Any], Any]:
        register_task_handler(name or fn.__name__, fn)
        return fn

    return deco


def clear_task_handlers() -> None:
    _HANDLERS.clear()


class RemoteSpawner:
    """Remote-spawn endpoint bound to one executor (one per rank)."""

    def __init__(self, executor: Executor,
                 device: Optional[lcx.Device] = None,
                 endpoint: Optional[lcx.Endpoint] = None) -> None:
        self.executor = executor
        self.endpoint = endpoint if endpoint is not None else executor.endpoint
        if device is None and endpoint is not None:
            device = endpoint.device
        self.device = device or executor.device
        self._fh = lcx.FunctionHandler(self._deliver)
        self._reply_fh = lcx.FunctionHandler(self._deliver_reply)
        self._reply_ids = itertools.count(1)
        self._pending_replies: Dict[int, Task] = {}
        self.stats: Dict[str, int] = {
            "unknown_handlers": 0, "handler_errors": 0,
            "orphan_replies": 0,
        }

    # -- sender side -----------------------------------------------------------
    def spawn(self, name: str, payload: Any, perm: lcx.Perm, *,
              reply: bool = True, priority: int = 0,
              tag: int = 0) -> Optional[Task]:
        """Spawn handler ``name`` on the peer(s) named by ``perm``,
        shipping ``payload``.  Returns a promise task that resolves with
        the peer's result (or None when ``reply=False``)."""
        if name not in _HANDLERS:
            raise KeyError(f"no task handler registered as {name!r}; "
                           f"known: {sorted(_HANDLERS)}")
        promise = None
        reply_id = 0
        if reply:
            reply_id = next(self._reply_ids)
            promise = self.executor.promise(name=f"reply:{name}:{reply_id}")
            self._pending_replies[reply_id] = promise
        lcx.am_x(payload).perm(perm).tag(tag).remote_comp(self._fh) \
            .runtime(self.executor._runtime).endpoint(self.endpoint) \
            .ctx({"handler": name, "reply_id": reply_id, "perm": perm,
                  "priority": priority}).device(self.device)()
        self.executor._note_post()
        return promise

    # -- receiver side (both run during lcx.progress) ---------------------------
    def _reply_error(self, ctx: Any, info: Dict[str, Any], payload: Any,
                     status: str, message: str) -> RemoteFailure:
        """Ship an error-status reply (dummy payload, the error rides in
        the context) so the spawner's promise resolves with a
        :class:`RemoteFailure` instead of hanging."""
        failure = RemoteFailure(handler=info["handler"], status=status,
                                message=message)
        if info["reply_id"]:
            shape = () if self.device.axis is None \
                else (self.device.axis_size,)
            dummy = torch.zeros(shape, device=getattr(payload, "device",
                                                      None))
            lcx.am_x(dummy).perm(info["perm"].inverse()) \
                .remote_comp(self._reply_fh) \
                .runtime(self.executor._runtime).endpoint(self.endpoint) \
                .ctx({"reply_id": info["reply_id"], "status": status,
                      "error": message, "handler": info["handler"]}) \
                .device(self.device)()
            ctx.executor._note_post()
        return failure

    def _deliver(self, ev: lcx.Event) -> Task:
        info = ev.context

        def run_remote(ctx: Any, _payload: Any = ev.payload,
                       _info: Dict[str, Any] = info) -> Any:
            fn = _HANDLERS.get(_info["handler"])
            if fn is None:
                self.stats["unknown_handlers"] += 1
                return self._reply_error(
                    ctx, _info, _payload, "unknown_handler",
                    f"no task handler registered as {_info['handler']!r}")
            try:
                result = fn(_payload)
            except Exception as e:
                self.stats["handler_errors"] += 1
                return self._reply_error(ctx, _info, _payload,
                                         "handler_error",
                                         f"{type(e).__name__}: {e}")
            if _info["reply_id"]:
                lcx.am_x(result).perm(_info["perm"].inverse()) \
                    .remote_comp(self._reply_fh) \
                    .runtime(self.executor._runtime).endpoint(self.endpoint) \
                    .ctx({"reply_id": _info["reply_id"]}) \
                    .device(self.device)()
                ctx.executor._note_post()
            return result

        return self.executor.spawn(
            run_remote, priority=info.get("priority", 0),
            name=f"remote:{info['handler']}")

    def _deliver_reply(self, ev: lcx.Event) -> None:
        info = ev.context
        promise = self._pending_replies.pop(info["reply_id"], None)
        if promise is None:
            # duplicate / late reply (e.g. FaultyTransport duplication)
            self.stats["orphan_replies"] += 1
            return
        if info.get("status"):
            self.executor.resolve_promise(
                promise, RemoteFailure(handler=info.get("handler", "?"),
                                       status=info["status"],
                                       message=info.get("error", "")))
        else:
            self.executor.resolve_promise(promise, ev.payload)
