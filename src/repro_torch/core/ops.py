"""LCX communication-posting operations (paper §2.2) as objectized
flexible functions (paper §3.1).

All posting operations are **asynchronous**: they pend the operation and
return a :class:`PostHandle`.  Completion is observed through the
completion object passed via ``.comp(...)`` (or an auto-allocated
:class:`~repro_torch.core.resources.Synchronizer`) *after* an explicit
:func:`progress` call — the paper's explicit-progress design point.

Naming follows the binding guideline: flexible form ``send_x``, plain
shorthand ``send`` with positional arguments only.

Rank model (:mod:`repro_torch.core.ranks`): on a device with an axis,
every buffer is rank-stacked, ``[n_ranks, ...]``, and a transfer is a
permutation along dim 0.  Byte counts and the eager threshold use one
rank's slice, as the reference counts inside its per-rank trace.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import ranks
from .flex import FlexOp, plain
from .resources import (CompletionObject, CompletionQueue, Device, Endpoint,
                        ErrorCode, Event, FaultyTransport, FunctionHandler,
                        MatchingEngine, MemoryRegion, PacketPool, Perm,
                        PostedOp, ResolvedResources, Runtime, Synchronizer,
                        IMMEDIATE_RCOMP_BITS, IMMEDIATE_TAG_BITS,
                        MAX_RCOMP_BITS, MAX_TAG_BITS, resolve_resources,
                        runtime, signal_error)


# ---------------------------------------------------------------------------
# Helpers
# ---------------------------------------------------------------------------
def _as_array(x: Any) -> Any:
    if isinstance(x, MemoryRegion):
        x.uses += 1
        return x.array
    return x


def _nbytes(x: Any) -> int:
    """Bytes one rank sends: a rank-stacked tensor's slice along dim 0."""
    if not hasattr(x, "shape") or len(x.shape) == 0:
        return 0
    return int(np.prod(x.shape[1:])) * x.dtype.itemsize


def _resolve(op: FlexOp) -> ResolvedResources:
    """Resolve the resource set for a posting op from its optional
    ``.runtime(r)`` / ``.endpoint(ep)`` / ``.device(d)`` /
    ``.matching_engine(e)`` handles — one path for every op (endpoint →
    device → runtime defaults)."""
    opt = type(op)._optional
    res = resolve_resources(
        runtime=op.arg_or("runtime", None),
        endpoint=op.arg_or("endpoint", None),
        device=op.arg_or("device", None),
        engine=(op.arg_or("matching_engine", None)
                if "matching_engine" in opt else None),
        pool=op.arg_or("pool", None) if "pool" in opt else None)
    if res.endpoint is not None and op.arg_or("endpoint", None) is not None:
        res.endpoint.stats["posted"] += 1
    return res


def _default_comp(op: FlexOp) -> CompletionObject:
    comp = op.arg_or("comp", None)
    return comp if comp is not None else Synchronizer(threshold=1)


def _check_tag(tag: int, bits: int, what: str) -> None:
    if not (0 <= tag < (1 << bits)):
        raise ValueError(f"{what} {tag} out of range for {bits}-bit field")


@dataclasses.dataclass(eq=False)
class PostHandle:
    """Returned by every posting operation."""

    comp: CompletionObject
    posted: PostedOp

    def wait(self) -> List[Event]:
        if isinstance(self.comp, Synchronizer):
            return self.comp.wait()
        raise TypeError("wait() only on Synchronizer completions; poll the "
                        "completion queue / handler instead")

    def payload(self) -> Any:
        return self.wait()[0].payload

    @property
    def status(self) -> str:
        """Lifecycle state of the posted op: pending/matched/done or the
        terminal error-code value (cancelled/timeout/fatal/retry)."""
        return self.posted.state

    def cancel(self) -> bool:
        """Retire the op if it is still pending in its matching engine;
        signals a ``cancelled`` completion.  See :func:`cancel`."""
        return cancel(self)


# ---------------------------------------------------------------------------
# send / recv (two-sided, matched)
# ---------------------------------------------------------------------------
class send_x(FlexOp):
    """Post an asynchronous tagged send.

    ``send_x(buf).perm(Perm.shift(1)).tag(3).comp(cq).post()`` — any
    optional argument, any order; reusable.
    """

    _positional = ("buffer",)
    _optional = dict(perm=None, tag=0, comp=None, device=None,
                     matching_engine=None, runtime=None, endpoint=None,
                     ctx=None, allow_aggregation=True,
                     timeout=None, max_retries=0)

    def _invoke(self) -> PostHandle:
        buf = _as_array(self.arg("buffer"))
        res = _resolve(self)
        rt, dev, eng = res.runtime, res.device, res.engine
        comp = _default_comp(self)
        tag = self.arg_or("tag", 0)
        _check_tag(tag, MAX_TAG_BITS, "send tag")
        op = PostedOp(kind="send", buffer=buf, perm=self.arg_or("perm", None),
                      tag=tag, comp=comp, device=dev,
                      seq=rt.next_seq(),
                      context=self.arg_or("ctx", None), op_name="send",
                      allow_aggregation=self.arg_or("allow_aggregation", True),
                      timeout=self.arg_or("timeout", None),
                      max_retries=self.arg_or("max_retries", 0))
        dev.stats["posted"] += 1
        rt.watch_deadline(op)
        rt.enqueue_matches(eng.post(op))
        return PostHandle(comp=comp, posted=op)


class recv_x(FlexOp):
    """Post an asynchronous tagged receive.  ``like`` gives the shape and
    dtype of the incoming message (the LCI recv buffer)."""

    _positional = ("like",)
    _optional = dict(perm=None, tag=0, comp=None, device=None,
                     matching_engine=None, runtime=None, endpoint=None,
                     ctx=None, timeout=None, max_retries=0)

    def _invoke(self) -> PostHandle:
        like = self.arg("like")
        res = _resolve(self)
        rt, dev, eng = res.runtime, res.device, res.engine
        comp = _default_comp(self)
        tag = self.arg_or("tag", 0)
        _check_tag(tag, MAX_TAG_BITS, "recv tag")
        op = PostedOp(kind="recv", buffer=like,
                      perm=self.arg_or("perm", None), tag=tag, comp=comp,
                      device=dev, seq=rt.next_seq(),
                      context=self.arg_or("ctx", None), op_name="recv",
                      timeout=self.arg_or("timeout", None),
                      max_retries=self.arg_or("max_retries", 0))
        dev.stats["posted"] += 1
        rt.watch_deadline(op)
        rt.enqueue_matches(eng.post(op))
        return PostHandle(comp=comp, posted=op)


# ---------------------------------------------------------------------------
# put / get / active message (one-sided, unmatched)
# ---------------------------------------------------------------------------
class put_x(FlexOp):
    """One-sided RDMA-write analogue.  With ``remote_comp`` set it becomes
    *RDMA write with signal*; the immediate-data limits of the paper are
    enforced (16-bit tag, 15-bit remote handler) unless the device allows
    payload-carried metadata."""

    _positional = ("buffer",)
    _optional = dict(perm=None, tag=0, comp=None, remote_comp=None,
                     device=None, runtime=None, endpoint=None, ctx=None,
                     allow_aggregation=True, timeout=None, max_retries=0)

    _OP = "put"

    def _default_remote_comp(self, res: ResolvedResources
                             ) -> Optional[CompletionObject]:
        return None

    def _invoke(self) -> PostHandle:
        buf = _as_array(self.arg("buffer"))
        res = _resolve(self)
        rt, dev = res.runtime, res.device
        comp = _default_comp(self)
        tag = self.arg_or("tag", 0)
        rcomp = self.arg_or("remote_comp", None)
        if rcomp is None:
            rcomp = self._default_remote_comp(res)
        if isinstance(rcomp, int):
            rid, rcomp_obj = rcomp, rt.rcomp(rcomp)
        elif rcomp is not None:
            rid, rcomp_obj = rt.register_rcomp(rcomp), rcomp
        else:
            rid, rcomp_obj = 0, None
        if rcomp_obj is not None and self._OP == "put":
            # paper §2.2: put-with-remote-signal rides the 32-bit immediate
            # field: 16-bit tag + 15-bit remote handler.  Wider values fall
            # back to payload-carried metadata (extra memory references) if
            # the device permits.
            if (tag >= (1 << IMMEDIATE_TAG_BITS)
                    or rid >= (1 << IMMEDIATE_RCOMP_BITS)):
                if not dev.get_attr_allow_payload_metadata():
                    raise ValueError(
                        "put with remote signal: tag/remote-handler exceed "
                        f"the immediate-data limits ({IMMEDIATE_TAG_BITS}/"
                        f"{IMMEDIATE_RCOMP_BITS} bits) and payload-carried "
                        "metadata is disabled on this device")
                dev.stats["payload_metadata_msgs"] = (
                    dev.stats.get("payload_metadata_msgs", 0) + 1)
        _check_tag(tag, MAX_TAG_BITS, f"{self._OP} tag")
        if rid >= (1 << MAX_RCOMP_BITS):
            raise ValueError("remote completion handler id too wide")
        send = PostedOp(kind="send", buffer=buf,
                        perm=self.arg_or("perm", None), tag=tag, comp=comp,
                        device=dev, seq=rt.next_seq(),
                        context=self.arg_or("ctx", None), op_name=self._OP,
                        remote_comp=rcomp_obj,
                        allow_aggregation=self.arg_or(
                            "allow_aggregation", True),
                        state="matched",
                        timeout=self.arg_or("timeout", None),
                        max_retries=self.arg_or("max_retries", 0))
        recv = PostedOp(kind="recv", buffer=buf, perm=send.perm, tag=tag,
                        comp=rcomp_obj, device=dev, seq=send.seq,
                        context=self.arg_or("ctx", None), op_name=self._OP,
                        state="matched")
        dev.stats["posted"] += 1
        rt.watch_deadline(send)
        rt.enqueue_matches([(send, recv)])
        return PostHandle(comp=comp, posted=send)


class am_x(put_x):
    """Active message: payload transfer plus a *remote completion object of
    any type* (function handler, completion queue, synchronizer…) signalled
    at the destination (paper §2.2).  Defaults the remote completion to the
    resolved completion queue (endpoint's, then device's, then the
    runtime's default)."""

    _OP = "am"

    def _default_remote_comp(self, res: ResolvedResources
                             ) -> Optional[CompletionObject]:
        return res.cq


class get_x(FlexOp):
    """One-sided RDMA-read analogue: fetch ``like``-shaped data from the
    peer defined by ``perm`` (a src->dst pattern read *backwards*)."""

    _positional = ("like",)
    _optional = dict(perm=None, tag=0, comp=None, device=None, runtime=None,
                     endpoint=None, ctx=None, timeout=None, max_retries=0)

    def _invoke(self) -> PostHandle:
        like = _as_array(self.arg("like"))
        res = _resolve(self)
        rt, dev = res.runtime, res.device
        comp = _default_comp(self)
        tag = self.arg_or("tag", 0)
        _check_tag(tag, MAX_TAG_BITS, "get tag")
        perm = self.arg_or("perm", None)
        send = PostedOp(kind="send", buffer=like, perm=perm, tag=tag,
                        comp=None, device=dev, seq=rt.next_seq(),
                        context=self.arg_or("ctx", None), op_name="get",
                        state="matched",
                        timeout=self.arg_or("timeout", None),
                        max_retries=self.arg_or("max_retries", 0))
        recv = PostedOp(kind="recv", buffer=like, perm=perm, tag=tag,
                        comp=comp, device=dev, seq=send.seq,
                        context=self.arg_or("ctx", None), op_name="get",
                        state="matched")
        dev.stats["posted"] += 1
        rt.watch_deadline(send)
        rt.enqueue_matches([(send, recv)])
        return PostHandle(comp=comp, posted=recv)


# ---------------------------------------------------------------------------
# progress (explicit, user-driven)
# ---------------------------------------------------------------------------
class progress_x(FlexOp):
    """Materialize matched transfers and signal completion objects.

    The paper's explicit progress function: "allowing users to determine
    when and how frequently to invoke the communication progress engine."
    Trace-time meaning: *where* you call progress is where the transfers
    are placed in the program — the overlap knob.

    Returns the number of *actual transfers* materialized (an aggregated
    group is one transfer; loopback deliveries are zero), and
    ``max_transfers`` limits that same count — loopback groups never
    consume the budget.

    Fault path: each call advances the runtime's progress tick (the
    clock that op ``timeout`` deadlines and retry backoffs count in),
    releases due backoff re-posts, drains matches touching dead devices
    as ``fatal`` completions, routes live matches through the installed
    :class:`~repro_torch.core.resources.FaultyTransport` (if any — resolved
    per match: explicit ``transport=`` > send device's > recv device's >
    runtime-wide fallback), and expires engine-pending ops past their
    deadline as ``timeout`` completions.

    Scoping: with no arguments, progresses the *global* runtime's entire
    ledger.  ``.runtime(rt)`` progresses another runtime; ``.device(d)``
    / ``.endpoint(ep)`` narrows to that device's ledger only (other
    devices' pending traffic is untouched — per-device progress
    isolation).
    """

    _positional = ()
    _optional = dict(device=None, pool=None, max_transfers=None,
                     transport=None, runtime=None, endpoint=None)

    def _invoke(self) -> int:
        explicit_dev = self.arg_or("device", None)
        ep = self.arg_or("endpoint", None)
        dev_filter = explicit_dev
        if dev_filter is None and ep is not None:
            dev_filter = ep.device
        rt = self.arg_or("runtime", None)
        if dev_filter is not None and dev_filter.migrated_to is not None:
            dev_filter = dev_filter.resolve_migrated()
        if rt is None and dev_filter is not None:
            rt = dev_filter.runtime
        if rt is None:
            rt = runtime()
        rt.tick += 1
        if rt.heartbeat is not None:
            # Heartbeats: every responsive device answers the progress
            # ping; a frozen device stays silent and the monitor's EMA
            # of inter-beat gaps eventually declares it dead (triggering
            # the configured failover/drain/raise policy).
            for d in rt.devices():
                if d.alive and d.responsive:
                    d.last_beat = rt.tick
            rt.heartbeat.poll(rt)
        pool = self.arg_or("pool", None)
        if pool is None and ep is not None:
            pool = ep.pool
        if pool is None and dev_filter is not None:
            pool = dev_filter.pool
        if pool is None:
            pool = rt.default_pool
        explicit_t = self.arg_or("transport", None)
        rt.release_retries()
        matches = rt.take_ready(dev_filter)
        n = 0
        if matches:
            live = []
            stalled = []
            for s, r in matches:
                if not (s.device.alive and r.device.alive):
                    signal_error(s, r, ErrorCode.FATAL)
                elif not (s.device.responsive and r.device.responsive):
                    # frozen (silently dead) device: its transfers stall
                    # in the ledger until a heartbeat monitor declares it
                    # dead and fails them over (or drains them fatal)
                    stalled.append((s, r))
                else:
                    live.append((s, r))
            if stalled:
                rt.enqueue_matches(stalled)
            live.sort(key=lambda m: m[0].seq)
            if explicit_t is not None:
                live = explicit_t.apply(live, rt)
            else:
                # Per-device transports: resolve and apply per match in
                # global seq order so a shared transport's seeded RNG
                # consumes draws exactly as a single global one would.
                routed: List[Tuple[PostedOp, PostedOp]] = []
                for s, r in live:
                    t = s.device.transport or r.device.transport \
                        or rt.transport
                    if t is None:
                        routed.append((s, r))
                    else:
                        routed.extend(t.apply([(s, r)], rt))
                live = routed
            if live:
                limit = self.arg_or("max_transfers", None)
                n = _execute(rt, live, pool, limit)
            if dev_filter is not None:
                dev_filter.stats["progressed"] += 1
        rt.expire_timeouts()
        return n


def _pack_class(dtype: Any) -> str:
    """Aggregation packing class.  Bitcast-safe dtypes share one byte-view
    class so mixed-dtype eager messages on the same perm ride one
    transfer; bools (no uint8 bitcast) aggregate only among themselves."""
    if dtype == torch.bool:
        return "dtype:bool"
    return "bytes"


def _execute(rt: Runtime, matches: List[Tuple[PostedOp, PostedOp]],
             pool: Optional[PacketPool], limit: Optional[int]) -> int:
    """Group, aggregate, and run matched transfers.

    Message stats (``eager_msgs``/``rendezvous_msgs``) are bumped only
    for groups actually *executed* this call — matches re-enqueued by the
    ``max_transfers`` budget are counted when they finally run, not on
    every progress attempt.
    """
    groups: Dict[Any, List[Tuple[PostedOp, PostedOp]]] = {}
    for s, r in matches:
        axis = s.device.axis
        if (pool is not None and pool.get_attr_aggregate()
                and s.allow_aggregation and s.fault_mark is None
                and axis is not None
                and pool.is_eager(_nbytes(s.buffer))):
            pkey = s.perm.key(s.device.axis_size) if s.perm else ()
            key = ("agg", axis, pkey, id(s.device),
                   _pack_class(s.buffer.dtype))
        else:
            key = ("solo", id(s))
        groups.setdefault(key, []).append((s, r))

    n_transfers = 0
    for key, grp in groups.items():
        cost = 0 if grp[0][0].device.axis is None else 1
        if limit is not None and cost and n_transfers + cost > limit:
            # out of transfer budget — leave the group pending
            rt.enqueue_matches(grp)
            continue
        if key[0] == "agg":
            if pool is not None:
                pool.stats["eager_msgs"] += len(grp)
            if len(grp) > 1:
                _run_aggregated(rt, grp, pool)
            else:
                _run_single(rt, *grp[0])
        else:
            for s, r in grp:
                _run_single(rt, s, r)
                if pool is not None and s.device.axis is not None:
                    pool.stats["rendezvous_msgs"] += 1
                    pool.stats["raw_transfers"] += 1
        n_transfers += cost
    return n_transfers


def _permute(value: Any, dev: Device, perm: Optional[Perm]) -> Any:
    axis = dev.axis
    if axis is None:  # loopback / sim device
        return value
    pairs = perm.pairs_for(dev.axis_size) if perm else [
        (i, i) for i in range(dev.axis_size)]
    if value.shape[0] != dev.axis_size:
        raise ValueError(
            f"rank-stacked buffer has {value.shape[0]} ranks on dim 0, "
            f"axis {axis!r} has {dev.axis_size}")
    dev.stats["transfers"] += 1
    dev.stats["bytes_moved"] += _nbytes(value)
    return ranks.permute(value, pairs)


def _check_shapes(s: PostedOp, r: PostedOp) -> None:
    if getattr(r.buffer, "shape", None) is not None and hasattr(
            s.buffer, "shape"):
        if tuple(r.buffer.shape) != tuple(s.buffer.shape):
            raise ValueError(
                f"matched send/recv shape mismatch: send {s.buffer.shape} "
                f"vs recv {r.buffer.shape} (tag={s.tag})")


def _corrupt_value(x: Any) -> Any:
    """Deterministic payload corruption: bitwise inversion through a
    uint8 view (bools flip logically, as in the reference)."""
    if x.dtype == torch.bool:
        return torch.logical_not(x)
    b = x.contiguous().reshape(-1).view(torch.uint8)
    return torch.bitwise_not(b).view(x.dtype).reshape(x.shape)


def _run_single(rt: Runtime, s: PostedOp, r: PostedOp) -> None:
    value = _permute(s.buffer, s.device, s.perm)
    _check_shapes(s, r)
    _signal(rt, s, r, value)


@dataclasses.dataclass(eq=False)
class AggPlan:
    """A cached concat/slice layout for one aggregated transfer: how to
    pack N eager messages into one flat buffer and carve the arrival back
    into per-message payloads.  Keyed by (axis, perm-key, dtype-signature,
    shape-signature), so steady-state progress loops (pipeline ticks,
    serving decode steps) reuse the plan instead of re-deriving it."""

    mixed: bool                      # byte-view packing (mixed dtypes)?
    sizes: Tuple[int, ...]           # per-rank flat length (elems/bytes)
    offsets: Tuple[int, ...]         # per-rank start offset per message
    shapes: Tuple[Tuple[int, ...], ...]  # rank-stacked shapes
    dtypes: Tuple[Any, ...]
    itemsizes: Tuple[int, ...]


def _agg_plan(rt: Runtime, grp: List[Tuple[PostedOp, PostedOp]]) -> AggPlan:
    """Look up or build the aggregation plan for a seq-sorted group."""
    s0 = grp[0][0]
    dtypes = tuple(s.buffer.dtype for s, _ in grp)
    shapes = tuple(tuple(s.buffer.shape) for s, _ in grp)
    pkey = s0.perm.key(s0.device.axis_size) if s0.perm else ()
    sig = (s0.device.axis, pkey, tuple(str(d) for d in dtypes), shapes)
    cache = rt.agg_plans
    plan = cache.get(sig)
    if plan is not None:
        rt.plan_stats["hits"] += 1
        return plan
    rt.plan_stats["misses"] += 1
    mixed = len(set(dtypes)) > 1
    itemsizes = tuple(d.itemsize for d in dtypes)
    if mixed:
        sizes = tuple(int(np.prod(sh[1:], dtype=np.int64)) * isz
                      for sh, isz in zip(shapes, itemsizes))
    else:
        sizes = tuple(int(np.prod(sh[1:], dtype=np.int64)) for sh in shapes)
    offsets, off = [], 0
    for sz in sizes:
        offsets.append(off)
        off += sz
    plan = AggPlan(mixed=mixed, sizes=sizes, offsets=tuple(offsets),
                   shapes=shapes, dtypes=dtypes, itemsizes=itemsizes)
    if len(cache) >= 4096:           # bound steady-state memory
        cache.clear()
    cache[sig] = plan
    return plan


def _byte_view(x: torch.Tensor) -> torch.Tensor:
    """Per-rank flat uint8 view of a rank-stacked tensor: [n, bytes]."""
    return x.contiguous().view(torch.uint8).reshape(x.shape[0], -1)


def _run_aggregated(rt: Runtime, grp: List[Tuple[PostedOp, PostedOp]],
                    pool: Optional[PacketPool]) -> None:
    """Pack eager messages sharing (axis, perm) into one transfer.

    Same-dtype groups concatenate directly; mixed-dtype groups ride a
    byte view (uint8 bitcast) so one packed transfer still suffices.
    """
    grp = sorted(grp, key=lambda m: m[0].seq)
    for s, r in grp:
        _check_shapes(s, r)
    plan = _agg_plan(rt, grp)
    if plan.mixed:
        flats = [_byte_view(s.buffer) for s, _ in grp]
    else:
        flats = [s.buffer.reshape(s.buffer.shape[0], -1) for s, _ in grp]
    packed = torch.cat(flats, dim=1)
    out = _permute(packed, grp[0][0].device, grp[0][0].perm)
    if pool is not None:
        pool.stats["aggregated_transfers"] += 1
    for (s, r), off, sz, shape, dt, isz in zip(
            grp, plan.offsets, plan.sizes, plan.shapes, plan.dtypes,
            plan.itemsizes):
        piece = out[:, off:off + sz]
        if plan.mixed:
            piece = piece.contiguous().view(dt)
        _signal(rt, s, r, piece.reshape(shape))


def _signal(rt: Runtime, s: PostedOp, r: PostedOp, value: Any) -> None:
    """Deliver completions for an executed transfer.

    The receiver is signalled first: a full completion queue returns
    ``retry`` instead of raising from inside progress, and that
    backpressure decides what the poster sees — an automatic backoff
    re-post when the op has retry budget, else a ``retry``-status
    completion the poster can re-post on.  The transport's per-hop
    ``fault_mark`` (duplicate / corrupt) is consumed here.

    Migrated (failed-over) transfers are exactly-once: each absorbed
    delivery records the op's seq in the runtime's dedup window, and a
    *migrated* replay whose seq already delivered is suppressed instead
    of double-delivered.  Transport-injected duplicates are exempt (the
    link duplicated the packet; both copies arrive, as on real wires).
    """
    mark, s.fault_mark = s.fault_mark, None
    migrated = s.migrated or r.migrated
    r_status = ErrorCode.OK
    if mark in ("corrupt", "corrupt_silent"):
        value = _corrupt_value(value)
        if mark == "corrupt":
            r_status = ErrorCode.RETRY
    if migrated and rt.was_delivered(s.seq):
        # the transfer raced the failure: it was already delivered before
        # the device died, and the failover replayed it — suppress.
        rt.failover_stats["dedup_suppressed"] += 1
        already_done = s.state == "done"
        s.state = r.state = "done"
        if s.comp is not None and not already_done:
            s.comp.signal(Event(payload=None, op=s.op_name, tag=s.tag,
                                perm=s.perm, remote=False, context=s.context,
                                migrated=True))
        return
    if r.comp is not None:
        remote = s.op_name in ("put", "am")
        ret = r.comp.signal(Event(payload=value, op=s.op_name, tag=r.tag,
                                  perm=r.perm, remote=remote,
                                  context=r.context, status=r_status,
                                  migrated=migrated))
        if ret is ErrorCode.RETRY and r_status.ok:
            # completion-queue overflow: the delivery was not absorbed
            if rt.schedule_retry(s, r):
                return                    # re-delivered after backoff
            s.state = r.state = "retry"
            if s.comp is not None:
                s.comp.signal(Event(payload=None, op=s.op_name, tag=s.tag,
                                    perm=s.perm, remote=False,
                                    context=s.context,
                                    status=ErrorCode.RETRY,
                                    migrated=migrated))
            return
        rt.note_delivered(s.seq)
        if mark == "duplicate":
            r.comp.signal(Event(payload=value, op=s.op_name, tag=r.tag,
                                perm=r.perm, remote=remote,
                                context=r.context, status=r_status,
                                migrated=migrated))
    else:
        rt.note_delivered(s.seq)
    s.state = r.state = "done"
    if s.comp is not None:
        s.comp.signal(Event(payload=None, op=s.op_name, tag=s.tag,
                            perm=s.perm, remote=False, context=s.context,
                            migrated=migrated))


# ---------------------------------------------------------------------------
# Convenience composites
# ---------------------------------------------------------------------------
def sendrecv(buffer: Any, perm: Perm, tag: int = 0,
             device: Optional[Device] = None,
             matching_engine: Optional[MatchingEngine] = None,
             runtime: Optional[Runtime] = None,
             endpoint: Optional[Endpoint] = None) -> Any:
    """Matched shift: send along ``perm`` and receive the inbound message.
    Posts both sides, progresses, returns the received array."""
    sync = Synchronizer(threshold=2)
    send_x(buffer).perm(perm).tag(tag).comp(sync).device(device) \
        .matching_engine(matching_engine).runtime(runtime) \
        .endpoint(endpoint)()
    recv_x(buffer).perm(perm).tag(tag).comp(sync).device(device) \
        .matching_engine(matching_engine).runtime(runtime) \
        .endpoint(endpoint)()
    progress_x().runtime(runtime).device(device).endpoint(endpoint)()
    events = sync.wait()
    (payload,) = [e.payload for e in events if e.payload is not None]
    return payload


def cancel(handle: Any) -> bool:
    """Cancel a posted-but-unmatched operation.

    Accepts a :class:`PostHandle` or a raw
    :class:`~repro_torch.core.resources.PostedOp`.  If the op is still pending
    in its matching engine it is retired from the keyed buckets, its
    completion object receives a ``cancelled``-status event, and the
    call returns True.  Ops that already matched (their transfer is in
    the ledger or executed) return False — too late to cancel.
    """
    op = handle.posted if isinstance(handle, PostHandle) else handle
    if not isinstance(op, PostedOp):
        raise TypeError(f"cancel() takes a PostHandle or PostedOp, "
                        f"got {type(op).__name__}")
    if op.state != "pending" or op.engine is None:
        return False
    if not op.engine.cancel(op):
        return False
    op.state = "cancelled"
    if op.comp is not None:
        op.comp.signal(Event(payload=None, op=op.op_name, tag=op.tag,
                             perm=op.perm, remote=False, context=op.context,
                             status=ErrorCode.CANCELLED))
    return True


def register_memory(array: Any,
                    runtime_: Optional[Runtime] = None) -> MemoryRegion:
    rt = runtime_ if runtime_ is not None else runtime()
    return rt.register_memory(array)


def register_rcomp(comp: CompletionObject,
                   runtime_: Optional[Runtime] = None) -> int:
    rt = runtime_ if runtime_ is not None else runtime()
    return rt.register_rcomp(comp)


# Plain-function shorthands (binding guideline).
send = plain(send_x)
recv = plain(recv_x)
put = plain(put_x)
get = plain(get_x)
am = plain(am_x)
progress = plain(progress_x)
