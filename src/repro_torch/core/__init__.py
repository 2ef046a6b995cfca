"""LCX — the paper's contribution, ported to PyTorch.

A Lightweight Communication Interface for asynchronous many-task
execution over rank-stacked tensors (:mod:`repro_torch.core.ranks`):
resources (Device, PacketPool,
MatchingEngine, completion objects) composed orthogonally with
operations (send/recv, put/get, active messages, progress), expressed
through the *objectized flexible function* idiom.

Typical use (``x`` is ``[16, ...]``, one slice per rank)::

    import repro_torch.core as lcx

    dev  = lcx.Device(axis="model", mesh_shape={"model": 16})
    sync = lcx.Synchronizer(threshold=1)
    lcx.put_x(x).perm(lcx.Perm.shift(1)).remote_comp(sync).device(dev)()
    lcx.progress()
    (ev,) = sync.wait()            # ev.payload[i] == x[i - 1]

The AMT client this interface was designed for lives in
``repro_torch.amt``:
a task-graph executor whose worker loop interleaves ready-task
execution with ``progress()`` and retires communication-suspended tasks
from completion objects — the executor's CompletionQueue is drained
after every progress call, FunctionHandlers fired by active messages
enqueue handler tasks, and any completion object with ``ready()``
(Synchronizer, CounterCompletion, custom ``signal`` overloads) can be
watched to resolve promise tasks.  See ``docs/amt.md`` for the
executor ↔ completion-object contract; ``repro_torch.serving`` is the
port's in-repo client.  The collectives (``all_gather``,
``reduce_scatter``, ``all_reduce``, ``all_to_all``, ``broadcast``,
``barrier``) are compositions of LCX puts over rank-stacked tensors
under ``ranks.bind_axis`` (:mod:`repro_torch.core.collectives`).
"""
from . import ranks
from .flex import FlexOp, REQUIRED, plain
from .attr import (get_global_attr, reset_global_attrs, set_global_attr)
from .resources import (CompletionError, CompletionObject, CompletionQueue,
                        CounterCompletion, Device, Endpoint, ErrorCode, Event,
                        FaultPolicy, FaultyTransport, FunctionHandler,
                        MatchingEngine, MemoryRegion, MigrationReport,
                        NetContext, PacketPool,
                        Perm, PostedOp, ResolvedResources, Runtime,
                        Synchronizer, IMMEDIATE_RCOMP_BITS,
                        IMMEDIATE_TAG_BITS, MAX_RCOMP_BITS, MAX_TAG_BITS,
                        finalize, init, install_transport, resolve_resources,
                        runtime, signal_error)
from .ops import (PostHandle, am, am_x, cancel, get, get_x, progress,
                  progress_x, put, put_x, recv, recv_x, register_memory,
                  register_rcomp, send, send_x, sendrecv)
from .collectives import (all_gather, all_gather_x, all_reduce, all_reduce_x,
                          all_to_all, all_to_all_x, barrier, broadcast,
                          broadcast_x, reduce_scatter, reduce_scatter_x)

__all__ = [
    "FlexOp", "REQUIRED", "plain",
    "get_global_attr", "set_global_attr", "reset_global_attrs",
    "CompletionError", "CompletionObject", "CompletionQueue",
    "CounterCompletion", "Device", "Endpoint", "ErrorCode", "Event",
    "FaultPolicy", "FaultyTransport", "FunctionHandler", "MatchingEngine",
    "MemoryRegion", "MigrationReport", "NetContext", "PacketPool", "Perm", "PostedOp",
    "ResolvedResources", "Runtime", "Synchronizer",
    "IMMEDIATE_RCOMP_BITS", "IMMEDIATE_TAG_BITS", "MAX_RCOMP_BITS",
    "MAX_TAG_BITS", "finalize", "init", "install_transport",
    "resolve_resources", "runtime", "signal_error",
    "PostHandle", "am", "am_x", "cancel", "get", "get_x", "progress",
    "progress_x", "put", "put_x", "recv", "recv_x", "register_memory",
    "register_rcomp", "send", "send_x", "sendrecv",
    "all_gather", "all_gather_x", "all_reduce", "all_reduce_x",
    "all_to_all", "all_to_all_x", "barrier", "broadcast", "broadcast_x",
    "reduce_scatter", "reduce_scatter_x", "ranks",
]
