"""LCX resources (paper §2.2).

The interface consists of *resources* and *operations*, arranged in the
paper's explicit hierarchy::

    Runtime → NetContext → Device → Endpoint

Every level is independently constructible and carries (or resolves to)
its own matching engine, packet pool, and default completion resources;
the process-global :func:`runtime` is merely a lazily created *default*
instance (the paper's ``g_runtime`` idiom), not the only one.  Two
runtimes — or two isolated devices on one runtime — can coexist in one
process with independent ``pending()`` accounting, fault injection, and
``finalize()`` leak checks.  See ``docs/resources.md``.

Major resources:

- :class:`Runtime` — top of the hierarchy: default resources, the
  pending-transfer ledger, sequence/registry state, fault clocks.
- :class:`NetContext` — one per network backend ("xla" / "pallas" /
  "sim"); owns devices.
- :class:`Device` — encapsulates the low-level network resource.  On TPU
  the "network" is the ICI mesh accessed through compiled collectives;
  a Device names a mesh axis (its communicator) plus a backend and
  tunable attributes.  Hierarchy-created devices own a private matching
  engine, packet pool, and completion queue (library/thread isolation);
  bare ``Device(...)`` stays *floating* and shares the ambient runtime's
  defaults, preserving the legacy single-pool behaviour.
- :class:`Endpoint` — the posting resource on a device (one per thread
  or library); may override the device's engine/pool/completion queue.
- :class:`PacketPool` — pre-registered fixed-size internal buffers.  At
  the JAX level the pool enables *message aggregation*: many fine-grained
  eager-protocol messages are packed into one transfer (the TPU analogue
  of doorbell batching / packet reuse).
- :class:`MatchingEngine` — matches sends with receives.  Two
  implementations (``queue`` in-order, ``map`` keyed) and five policies
  (``none``, ``rank_only``, ``tag_only``, ``rank_tag``, ``custom``).
- Completion objects — :class:`Synchronizer`, :class:`CompletionQueue`,
  :class:`FunctionHandler`; all subclassable via ``signal()``.

Resources map to operations independently: two operations may share a
device but use different completion objects; sends and recvs posted on
*different devices* still match if they share a matching engine.

Execution model (hardware adaptation, see DESIGN.md §2): LCI posts
operations at *runtime* from many threads; LCX posts at *trace time*
inside one SPMD program.  Posted operations are pended; the
:func:`~repro_torch.core.ops.progress` operation resolves matches and
materializes transfers as permutations along the leading rank dimension
of rank-stacked tensors (:mod:`repro_torch.core.ranks`), then signals
completion objects.  Completion is data availability of the permuted
tensor.
"""
from __future__ import annotations

import dataclasses
import enum
import heapq
import itertools
import os
import random
import threading
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from . import ranks
from .attr import HasAttrs

# Interface constants (paper §2.2): immediate-data-constrained limits for
# put-with-remote-signal; full-width limits elsewhere.
IMMEDIATE_TAG_BITS = 16
IMMEDIATE_RCOMP_BITS = 15
MAX_TAG_BITS = 64
MAX_RCOMP_BITS = 32


# ---------------------------------------------------------------------------
# Permutation specs (who talks to whom on a device's axis)
# ---------------------------------------------------------------------------
class Perm:
    """A trace-time communication pattern on a device axis.

    In SPMD there is no runtime "destination rank" argument; the pattern
    *is* the argument.  ``Perm.shift(1)`` is the ring successor,
    ``Perm.pairs([(0, 3)])`` a single point-to-point message (other ranks
    carry padding), ``Perm.all_to(r)``/``Perm.from_(r)`` fan-in/fan-out.
    """

    def __init__(self, fn: Callable[[int], List[Tuple[int, int]]], name: str):
        self._fn = fn
        self.name = name
        # Per-axis_size memo: the progress engine re-derives pairs/keys on
        # every post and every transfer, so these are hot-path lookups.
        self._pairs_memo: Dict[int, List[Tuple[int, int]]] = {}
        self._key_memo: Dict[int, Tuple[Tuple[int, int], ...]] = {}

    def pairs_for(self, axis_size: int) -> List[Tuple[int, int]]:
        pairs = self._pairs_memo.get(axis_size)
        if pairs is None:
            pairs = self._pairs_memo[axis_size] = self._fn(axis_size)
        return pairs

    # -- constructors -------------------------------------------------------
    @staticmethod
    def shift(k: int) -> "Perm":
        return Perm(lambda n: [(i, (i + k) % n) for i in range(n)],
                    f"shift({k})")

    @staticmethod
    def pairs(ps: Sequence[Tuple[int, int]]) -> "Perm":
        ps = [tuple(p) for p in ps]
        return Perm(lambda n: list(ps), f"pairs({ps})")

    @staticmethod
    def to(dst: int, src: int) -> "Perm":
        return Perm.pairs([(src, dst)])

    def key(self, axis_size: int) -> Tuple[Tuple[int, int], ...]:
        key = self._key_memo.get(axis_size)
        if key is None:
            key = self._key_memo[axis_size] = tuple(
                sorted(self.pairs_for(axis_size)))
        return key

    def inverse(self) -> "Perm":
        fn = self._fn
        return Perm(lambda n: [(d, s) for (s, d) in fn(n)],
                    f"inv({self.name})")

    def __repr__(self) -> str:
        return f"Perm<{self.name}>"


# ---------------------------------------------------------------------------
# Status codes (LCI errorcode_t analogue)
# ---------------------------------------------------------------------------
class ErrorCode(enum.Enum):
    """Per-operation status, mirroring LCI's ``errorcode_t``: every post
    and every completion carries one instead of success-or-crash.

    - ``OK``        — the operation completed normally.
    - ``RETRY``     — transient resource exhaustion (completion-queue
      overflow, corrupt-marked delivery); the poster may re-post.
    - ``TIMEOUT``   — the op's progress-call-count deadline elapsed
      before a match/delivery.
    - ``CANCELLED`` — the op was retired via :func:`repro_torch.core.cancel`.
    - ``FATAL``     — unrecoverable (retries exhausted, dead device).
    """

    OK = "ok"
    RETRY = "retry"
    TIMEOUT = "timeout"
    CANCELLED = "cancelled"
    FATAL = "fatal"

    @property
    def ok(self) -> bool:
        return self is ErrorCode.OK


class CompletionError(RuntimeError):
    """Raised when a waited-on completion carries a non-ok status.
    ``events`` holds the offending :class:`Event` objects."""

    def __init__(self, msg: str, events: Sequence["Event"] = ()) -> None:
        super().__init__(msg)
        self.events = list(events)


# ---------------------------------------------------------------------------
# Completion objects
# ---------------------------------------------------------------------------
@dataclasses.dataclass(eq=False)
class Event:
    """A completion event delivered to a completion object."""

    payload: Any = None          # traced array (recv/get/am/put-target side)
    op: str = ""                 # "send"|"recv"|"put"|"get"|"am"
    tag: int = 0
    perm: Optional[Perm] = None
    remote: bool = False         # True when this is a *remote* completion
    context: Any = None          # user context passed at post time
    status: ErrorCode = ErrorCode.OK
    # True when the op travelled through a device failover: either it
    # replayed on the survivor (status ok) or it needs a re-post there
    # (status retry).  Consumers (AMT executor) use this to re-dispatch
    # instead of dead-lettering.
    migrated: bool = False


class CompletionObject(HasAttrs):
    """Base completion object.  Users may subclass and override
    :meth:`signal` to customize completion semantics (paper: e.g. an
    atomic-counter object waiting for all previously posted ops)."""

    _ATTR_DEFAULTS: Dict[str, Any] = {}

    def __init__(self, **attrs: Any) -> None:
        self._init_attrs(attrs)

    def signal(self, event: Event) -> Optional[ErrorCode]:
        """Deliver one event.  May return :attr:`ErrorCode.RETRY` to
        push back on the signaller (e.g. queue overflow); ``None`` or
        :attr:`ErrorCode.OK` mean the event was absorbed."""
        raise NotImplementedError  # pragma: no cover - abstract

    # Default-resource bookkeeping
    def __repr__(self) -> str:
        return f"{type(self).__name__}@{id(self):x}"


class Synchronizer(CompletionObject):
    """MPI-request-like object that can wait for *multiple* completed
    operations before becoming ready (paper §2.2)."""

    _ATTR_DEFAULTS = {"threshold": 1}

    def __init__(self, threshold: Optional[int] = None, **attrs: Any) -> None:
        super().__init__(threshold=threshold, **attrs)
        self._events: List[Event] = []

    def signal(self, event: Event) -> None:
        self._events.append(event)

    @property
    def threshold(self) -> int:
        return self._attrs["threshold"]

    def ready(self) -> bool:
        return len(self._events) >= self.threshold

    def wait(self, reset: bool = True,
             raise_on_error: bool = True) -> List[Event]:
        """Return the completed events.  In trace-time LCX, ops complete
        at ``progress()``; waiting before enough progress is a program
        error (there is no background thread to make it ready).

        A non-ok event (timeout, cancellation, fatal transport failure)
        raises :class:`CompletionError` — errors surface instead of
        counting as silent successes.  Pass ``raise_on_error=False`` to
        receive the events and inspect ``event.status`` yourself; on
        raise the events stay queued for inspection.
        """
        if not self.ready():
            raise RuntimeError(
                f"Synchronizer.wait(): only {len(self._events)} of "
                f"{self.threshold} completions arrived — call "
                "lcx.progress() after posting"
            )
        events, rest = (self._events[: self.threshold],
                        self._events[self.threshold:])
        if raise_on_error:
            bad = [e for e in events if not e.status.ok]
            if bad:
                raise CompletionError(
                    f"Synchronizer.wait(): {len(bad)} of {len(events)} "
                    f"completions failed: "
                    f"{sorted({e.status.value for e in bad})}", bad)
        if reset:
            self._events = rest
        return events

    def wait_payloads(self, reset: bool = True) -> List[Any]:
        return [e.payload for e in self.wait(reset=reset)]

    def error_events(self) -> List[Event]:
        """Arrived events carrying a non-ok status (without consuming)."""
        return [e for e in self._events if not e.status.ok]


class CompletionQueue(CompletionObject):
    """FIFO completion queue.

    A full queue does **not** raise from inside progress (which would
    lose the event and tear down the progress engine): ``signal``
    returns :attr:`ErrorCode.RETRY` and the progress engine converts it
    into a retry-status completion for the poster (or an automatic
    backoff re-post when the op carries ``max_retries``).
    """

    _ATTR_DEFAULTS = {"capacity": 1 << 16}

    def __init__(self, capacity: Optional[int] = None, **attrs: Any) -> None:
        super().__init__(capacity=capacity, **attrs)
        self._q: deque = deque()
        self.overflows = 0
        self.n_error_events = 0

    def signal(self, event: Event) -> ErrorCode:
        if len(self._q) >= self._attrs["capacity"]:
            self.overflows += 1
            return ErrorCode.RETRY
        if not event.status.ok:
            self.n_error_events += 1
        self._q.append(event)
        return ErrorCode.OK

    def pop(self) -> Optional[Event]:
        return self._q.popleft() if self._q else None

    def pop_all(self) -> List[Event]:
        out = list(self._q)
        self._q.clear()
        return out

    def __len__(self) -> int:
        return len(self._q)


class FunctionHandler(CompletionObject):
    """Completion object that invokes a function on each event — the
    active-message handler, usable as *local or remote* completion for any
    operation (paper: "LCI's active message operation supports remote
    completion objects of any type")."""

    def __init__(self, fn: Callable[[Event], Any], **attrs: Any) -> None:
        super().__init__(**attrs)
        self._fn = fn
        self.results: List[Any] = []

    def signal(self, event: Event) -> None:
        self.results.append(self._fn(event))


class CounterCompletion(CompletionObject):
    """Example of the paper's "overload ``signal`` with an atomic counter"
    pattern: becomes ready when N ops completed, keeps no payloads.

    Only ok-status completions advance the counter; failed completions
    are collected in :attr:`errors` so a lost transfer can never satisfy
    a success threshold silently."""

    _ATTR_DEFAULTS = {"target": 1}

    def __init__(self, target: Optional[int] = None, **attrs: Any) -> None:
        super().__init__(target=target, **attrs)
        self.count = 0
        self.errors: List[Event] = []

    def signal(self, event: Event) -> None:
        if event.status.ok:
            self.count += 1
        else:
            self.errors.append(event)

    def ready(self) -> bool:
        return self.count >= self._attrs["target"]

    @property
    def error_count(self) -> int:
        return len(self.errors)


# ---------------------------------------------------------------------------
# Matching engine
# ---------------------------------------------------------------------------
_NO_KEY = object()          # sentinel: match key not yet computed


@dataclasses.dataclass(eq=False)
class PostedOp:
    """A pending posted operation (trace-time analogue of an LCI
    communication descriptor)."""

    kind: str                    # "send" | "recv"
    buffer: Any                  # send: traced array; recv: ShapeDtype proto
    perm: Optional[Perm]
    tag: int
    comp: Optional[CompletionObject]
    device: "Device"
    seq: int
    context: Any = None
    remote_comp: Optional[CompletionObject] = None
    op_name: str = "send"        # original op: send/put/get/am
    allow_aggregation: bool = True
    # Match key, computed ONCE at post time by the matching engine the op
    # is posted to (it depends on the engine's policy).  _NO_KEY until then.
    match_key: Any = _NO_KEY
    # -- lifecycle (fault-tolerance) ----------------------------------------
    # "pending"   — posted, waiting in a matching engine
    # "matched"   — matched, waiting in the transfer ledger / retry queue
    # "done"      — completion signalled
    # "cancelled" / "timeout" / "fatal" — retired with that status
    state: str = "pending"
    engine: Optional["MatchingEngine"] = None
    timeout: Optional[int] = None      # deadline in progress calls
    max_retries: int = 0               # backoff re-posts on drop/overflow
    retries: int = 0                   # attempts consumed
    delays: int = 0                    # consecutive injected delays
    posted_tick: int = 0               # runtime tick at post time
    fault_mark: Optional[str] = None   # set by FaultyTransport for this hop
    migrated: bool = False             # re-homed by a device failover


class MatchingEngine(HasAttrs):
    """Matches posted sends with posted recvs.

    ``kind='map'`` matches on a key derived from the policy, regardless of
    posting order (the multithreaded-throughput implementation in the
    paper — LCI attributes its message-rate advantage to hash-table tag
    matching, and this engine mirrors that: keyed hash buckets give O(1)
    amortized post+match instead of the O(S×R) pending-list scan).
    ``kind='queue'`` only matches in FIFO order (in-order receives): a
    send matches the *head* recv and vice versa; a key mismatch at the
    heads leaves both pending (they may match after reordering posts —
    which, trace-time, means user error surfaced by ``flush``).

    Map-mode invariant: after every ``post`` no matchable (send, recv)
    pair remains pending, so a new op can only match the *oldest*
    pending opposite op with the same key — which is exactly the head of
    that key's bucket.  Custom ``key_fn``s returning unhashable keys
    fall back to a linear bucket scan with identical semantics.
    """

    _ATTR_DEFAULTS = {"kind": "map", "policy": "rank_tag"}
    POLICIES = ("none", "rank_only", "tag_only", "rank_tag", "custom")

    def __init__(self, kind: Optional[str] = None,
                 policy: Optional[str] = None,
                 key_fn: Optional[Callable[[PostedOp], Any]] = None,
                 **attrs: Any) -> None:
        self._init_attrs({"kind": kind, "policy": policy, **attrs})
        if self._attrs["kind"] not in ("map", "queue"):
            raise ValueError(f"unknown matching engine kind "
                             f"{self._attrs['kind']!r}")
        if self._attrs["policy"] not in self.POLICIES:
            raise ValueError(f"unknown match policy {self._attrs['policy']!r}")
        if self._attrs["policy"] == "custom" and key_fn is None:
            raise ValueError("custom match policy requires key_fn")
        self._key_fn = key_fn
        # queue kind: FIFO deques.  map kind: key -> deque buckets, plus
        # an unhashable-key overflow list ((key, op) pairs, linear scan).
        self._pending_send: deque = deque()
        self._pending_recv: deque = deque()
        self._send_buckets: Dict[Any, deque] = {}
        self._recv_buckets: Dict[Any, deque] = {}
        self._send_overflow: List[Tuple[Any, PostedOp]] = []
        self._recv_overflow: List[Tuple[Any, PostedOp]] = []
        self._n_send = 0
        self._n_recv = 0
        self.n_matched = 0

    # -- key derivation ------------------------------------------------------
    def _key(self, op: PostedOp) -> Any:
        """Derive (and cache on the op) the policy match key.  Computed
        once at post time; the cached value is reused on every later
        drain attempt instead of re-deriving perm keys in inner loops."""
        if op.match_key is not _NO_KEY:
            return op.match_key
        policy = self._attrs["policy"]
        if policy == "none":
            key = ()
        elif policy == "rank_only":
            key = op.perm.key(op.device.axis_size) if op.perm else ()
        elif policy == "tag_only":
            key = op.tag
        elif policy == "rank_tag":
            key = ((op.perm.key(op.device.axis_size) if op.perm else ()),
                   op.tag)
        else:
            key = self._key_fn(op)
        op.match_key = key
        return key

    # -- posting ---------------------------------------------------------------
    def post(self, op: PostedOp) -> List[Tuple[PostedOp, PostedOp]]:
        """Post an op; return newly formed (send, recv) matches."""
        op.engine = self
        if self._attrs["kind"] == "queue":
            if op.kind == "send":
                self._pending_send.append(op)
            else:
                self._pending_recv.append(op)
            matches = self._drain_queue()
        else:
            matches = self._post_map(op)
        for s, r in matches:
            s.state = r.state = "matched"
        return matches

    def _post_map(self, op: PostedOp) -> List[Tuple[PostedOp, PostedOp]]:
        key = self._key(op)
        is_send = op.kind == "send"
        other_buckets = self._recv_buckets if is_send else self._send_buckets
        other_overflow = self._recv_overflow if is_send else self._send_overflow
        try:
            bucket = other_buckets.get(key)
        except TypeError:                     # unhashable custom key
            return self._post_map_unhashable(op, key)
        peer: Optional[PostedOp] = None
        if bucket:
            peer = bucket.popleft()
            if not bucket:
                del other_buckets[key]
        elif other_overflow:
            # hashable key may still match an unhashable-keyed peer via ==
            for i, (okey, oop) in enumerate(other_overflow):
                if okey == key:
                    peer = oop
                    del other_overflow[i]
                    break
        if peer is None:
            own = self._send_buckets if is_send else self._recv_buckets
            own.setdefault(key, deque()).append(op)
            if is_send:
                self._n_send += 1
            else:
                self._n_recv += 1
            return []
        if is_send:
            self._n_recv -= 1
            match = (op, peer)
        else:
            self._n_send -= 1
            match = (peer, op)
        self.n_matched += 1
        return [match]

    def _post_map_unhashable(self, op: PostedOp,
                             key: Any) -> List[Tuple[PostedOp, PostedOp]]:
        is_send = op.kind == "send"
        other_buckets = self._recv_buckets if is_send else self._send_buckets
        other_overflow = self._recv_overflow if is_send else self._send_overflow
        peer: Optional[PostedOp] = None
        # oldest matching peer across bucketed and overflow pendings
        best_seq = None
        best_loc: Any = None
        for bkey, bucket in other_buckets.items():
            if bkey == key and bucket:
                head = bucket[0]
                if best_seq is None or head.seq < best_seq:
                    best_seq, best_loc, peer = head.seq, ("b", bkey), head
        for i, (okey, oop) in enumerate(other_overflow):
            if okey == key and (best_seq is None or oop.seq < best_seq):
                best_seq, best_loc, peer = oop.seq, ("o", i), oop
        if peer is None:
            own = self._send_overflow if is_send else self._recv_overflow
            own.append((key, op))
            if is_send:
                self._n_send += 1
            else:
                self._n_recv += 1
            return []
        if best_loc[0] == "b":
            bucket = other_buckets[best_loc[1]]
            bucket.popleft()
            if not bucket:
                del other_buckets[best_loc[1]]
        else:
            del other_overflow[best_loc[1]]
        if is_send:
            self._n_recv -= 1
            match = (op, peer)
        else:
            self._n_send -= 1
            match = (peer, op)
        self.n_matched += 1
        return [match]

    def _drain_queue(self) -> List[Tuple[PostedOp, PostedOp]]:
        matches: List[Tuple[PostedOp, PostedOp]] = []
        while self._pending_send and self._pending_recv:
            s, r = self._pending_send[0], self._pending_recv[0]
            if self._key(s) != self._key(r):
                break
            self._pending_send.popleft()
            self._pending_recv.popleft()
            matches.append((s, r))
        self.n_matched += len(matches)
        return matches

    # -- cancellation ----------------------------------------------------------
    def cancel(self, op: PostedOp) -> bool:
        """Retire a still-pending op from the engine's buckets.

        The op is removed *physically* (not tombstoned), so
        :meth:`pending` reflects the cancellation immediately rather
        than waiting for bucket compaction.  Returns ``False`` when the
        op already matched, completed, or belongs to another engine —
        too late to cancel."""
        if op.state != "pending" or op.engine is not self:
            return False
        if self._attrs["kind"] == "queue":
            q = self._pending_send if op.kind == "send" else self._pending_recv
            try:
                q.remove(op)
            except ValueError:
                return False
            return True
        # map kind: keyed bucket or unhashable overflow
        own_buckets = (self._send_buckets if op.kind == "send"
                       else self._recv_buckets)
        own_overflow = (self._send_overflow if op.kind == "send"
                        else self._recv_overflow)
        removed = False
        try:
            bucket = own_buckets.get(op.match_key)
        except TypeError:
            bucket = None
        if bucket is not None:
            try:
                bucket.remove(op)
                removed = True
                if not bucket:
                    del own_buckets[op.match_key]
            except ValueError:
                pass
        if not removed:
            for i, (_, oop) in enumerate(own_overflow):
                if oop is op:
                    del own_overflow[i]
                    removed = True
                    break
        if removed:
            if op.kind == "send":
                self._n_send -= 1
            else:
                self._n_recv -= 1
        return removed

    def pending(self) -> Tuple[int, int]:
        if self._attrs["kind"] == "queue":
            return len(self._pending_send), len(self._pending_recv)
        return self._n_send, self._n_recv

    # -- migration -------------------------------------------------------------
    def extract_pending(self, device: "Device") -> List[PostedOp]:
        """Remove and return every still-pending op posted on ``device``,
        in seq order (the order they were posted).  Used by
        :meth:`NetContext.migrate` to transplant a dead device's
        un-matched ops into the survivor's engine; the ops keep their
        cached ``match_key`` so tag/rank matching is preserved."""
        out: List[PostedOp] = []
        if self._attrs["kind"] == "queue":
            for q in (self._pending_send, self._pending_recv):
                keep = deque()
                for op in q:
                    (out if op.device is device else keep).append(op)
                q.clear()
                q.extend(keep)
        else:
            for buckets in (self._send_buckets, self._recv_buckets):
                for key in list(buckets):
                    bucket = buckets[key]
                    taken = [op for op in bucket if op.device is device]
                    if not taken:
                        continue
                    out.extend(taken)
                    kept = deque(op for op in bucket
                                 if op.device is not device)
                    if kept:
                        buckets[key] = kept
                    else:
                        del buckets[key]
            for overflow in (self._send_overflow, self._recv_overflow):
                taken = [op for _, op in overflow if op.device is device]
                if taken:
                    out.extend(taken)
                    overflow[:] = [(k, op) for k, op in overflow
                                   if op.device is not device]
            for op in out:
                if op.kind == "send":
                    self._n_send -= 1
                else:
                    self._n_recv -= 1
        for op in out:
            op.engine = None
        out.sort(key=lambda op: op.seq)
        return out


# ---------------------------------------------------------------------------
# Packet pool
# ---------------------------------------------------------------------------
class PacketPool(HasAttrs):
    """Pre-registered fixed-size buffer pool.

    Messages with ``nbytes <= packet_size`` travel the *eager* path and
    are eligible for aggregation: at progress time all eager messages
    sharing a (axis, perm) pattern are packed into one transfer.  Larger
    messages take the *rendezvous* path (their own transfer) — mirroring
    LCI's eager/rendezvous split.
    """

    _ATTR_DEFAULTS = {"npackets": 4096, "packet_size": 65536,
                      "aggregate": True}

    def __init__(self, npackets: Optional[int] = None,
                 packet_size: Optional[int] = None, **attrs: Any) -> None:
        self._init_attrs(
            {"npackets": npackets, "packet_size": packet_size, **attrs})
        self.stats = {"eager_msgs": 0, "rendezvous_msgs": 0,
                      "aggregated_transfers": 0, "raw_transfers": 0}

    def is_eager(self, nbytes: int) -> bool:
        return nbytes <= self._attrs["packet_size"]


# ---------------------------------------------------------------------------
# NetContext
# ---------------------------------------------------------------------------
class NetContext(HasAttrs):
    """The per-backend network context (second hierarchy level).

    One net context per network backend: ``"xla"`` (compiled
    collectives), ``"pallas"`` (remote-DMA kernels, TPU-only), ``"sim"``
    (loopback).  A net context owns :class:`Device` objects; devices
    created through :meth:`device` inherit the context's backend and own
    private matching/pool/completion resources by default — the
    library-interop pattern (one device per library) and the
    per-thread-device isolation both hang off this level.
    """

    _ATTR_DEFAULTS = {
        "backend": "xla",        # "xla" | "pallas" (TPU-only) | "sim"
        "name": None,
    }

    def __init__(self, runtime: Optional["Runtime"] = None,
                 backend: Optional[str] = None, **attrs: Any) -> None:
        self._init_attrs({"backend": backend, **attrs})
        if self._attrs["backend"] not in ("xla", "pallas", "sim"):
            raise ValueError(
                f"unknown net-context backend {self._attrs['backend']!r}")
        self._runtime = runtime
        self.devices: List["Device"] = []
        self.default_device: Optional["Device"] = None
        if runtime is not None:
            runtime._attach_net_context(self)

    @property
    def runtime(self) -> Optional["Runtime"]:
        return self._runtime

    @property
    def backend(self) -> str:
        return self._attrs["backend"]

    def device(self, axis: Optional[str] = None, **attrs: Any) -> "Device":
        """Allocate a device on this context.  Unlike bare ``Device()``,
        the device owns private resources (``own_resources=True``)
        unless explicitly disabled."""
        attrs.setdefault("own_resources", True)
        attrs.setdefault("backend", self.backend)
        return Device(axis=axis, net_context=self, **attrs)

    def _attach_device(self, dev: "Device") -> None:
        self.devices.append(dev)
        if self.default_device is None:
            self.default_device = dev

    def pending(self) -> int:
        """Matched-but-unprogressed transfers across this context's
        devices (0 when unbound to a runtime)."""
        rt = self._runtime
        if rt is None:
            return 0
        return sum(rt.pending_for(d) for d in self.devices)

    # -- failover --------------------------------------------------------------
    def migrate(self, dead: "Device", target: "Device",
                replay: bool = True) -> "MigrationReport":
        """Re-home a dead (or dying) device's communication state onto
        ``target``: endpoints move over, un-matched posted ops
        transplant into the target's matching engine (tag/rank match
        keys preserved), and matched-but-unprogressed transfers in the
        runtime's ledger/retry queue re-point to the survivor.

        Replay semantics: when ``replay`` is true and the two devices
        communicate over the *same axis*, in-flight transfers replay
        transparently on the survivor — deliveries carry
        ``Event.migrated=True`` and the runtime's per-op sequence
        numbers + dedup window guarantee a transfer that raced the
        failure is neither lost nor double-delivered.  When the axes
        differ (or ``replay=False``), matched pairs cannot replay: both
        sides complete ``retry`` with ``migrated=True`` so the poster
        (e.g. the AMT executor) re-posts on the survivor.

        The dead device is marked dead and left with a ``migrated_to``
        forwarding pointer, so stale handles posting through it resolve
        to the target."""
        if dead is target:
            raise ValueError("cannot migrate a device onto itself")
        if not target.alive:
            raise ValueError(f"migration target {target!r} is dead")
        rt = self._runtime
        if rt is None:
            rt = target.runtime or dead.runtime
        if rt is None:
            rt = _global_runtime()
        can_replay = replay and dead.axis == target.axis
        target_engine = target.engine
        if target_engine is None:      # floating target: ambient default
            target_engine = rt.default_engine
        # 1. un-matched engine-pending ops: pull them (seq order) out of
        #    whatever engine they pend in and transplant.
        moved_ops: List[PostedOp] = []
        engines = []
        if dead.engine is not None:
            engines.append(dead.engine)
        for ep in dead.endpoints:
            if ep.engine is not None and ep.engine not in engines:
                engines.append(ep.engine)
        if rt.default_engine is not None and rt.default_engine not in engines:
            engines.append(rt.default_engine)
        for eng in engines:
            moved_ops.extend(eng.extract_pending(dead))
        moved_ops.sort(key=lambda op: op.seq)
        n_signalled = 0
        for op in moved_ops:
            op.device = target
            op.migrated = True
            if not can_replay:
                # match keys derived from (perm, axis_size) no longer
                # describe the survivor's axis: recompute at re-post.
                op.match_key = _NO_KEY
            rt.enqueue_matches(target_engine.post(op))
        # 2. matched transfers in the ledger / retry queue.
        n_ledger, n_retry, sig = rt.retarget_pending(
            dead, target, can_replay=can_replay)
        n_signalled += sig
        # 3. endpoints re-home (their resource aliases follow the target
        #    when they aliased the dead device's own resources).
        n_eps = 0
        for ep in list(dead.endpoints):
            if ep in target.endpoints:
                continue
            if ep.engine is dead.engine:
                ep.engine = target.engine
            if ep.pool is dead.pool:
                ep.pool = target.pool
            if ep.cq is dead.cq:
                ep.cq = target.cq
            ep.device = target
            target.endpoints.append(ep)
            n_eps += 1
        dead.endpoints = []
        dead.mark_dead()
        dead.migrated_to = target
        return MigrationReport(dead=dead, target=target, replayed=can_replay,
                               n_endpoints=n_eps, n_engine_ops=len(moved_ops),
                               n_ledger=n_ledger, n_retry=n_retry,
                               n_reposted=n_signalled)

    def __repr__(self) -> str:
        name = self._attrs.get("name")
        tag = f" {name!r}" if name else ""
        return (f"NetContext<{self.backend}{tag}, "
                f"{len(self.devices)} device(s)>")


@dataclasses.dataclass
class MigrationReport:
    """What :meth:`NetContext.migrate` moved.  ``replayed`` is True when
    in-flight transfers replay transparently on the survivor;
    ``n_reposted`` counts matched pairs that instead completed
    ``retry``/``migrated`` for the poster to re-post."""

    dead: "Device"
    target: "Device"
    replayed: bool
    n_endpoints: int = 0
    n_engine_ops: int = 0
    n_ledger: int = 0
    n_retry: int = 0
    n_reposted: int = 0


# ---------------------------------------------------------------------------
# Device
# ---------------------------------------------------------------------------
class Device(HasAttrs):
    """The per-communicator network resource (third hierarchy level).

    ``axis`` names the mesh axis this device communicates over (its
    "NIC port" onto the ICI torus); ``axis=None`` is the loopback/sim
    device used for single-process semantics tests.  Multiple devices on
    the same axis model LCI's device-per-thread isolation: their pending
    traffic is progressed independently (separate transfer schedules).

    Devices allocated through the hierarchy (``net_ctx.device(...)`` /
    ``rt.device(...)``) own a *private* matching engine, packet pool,
    and completion queue plus a default :class:`Endpoint` — ops posted
    on them cannot contend with (or match against) another device's
    traffic.  A bare ``Device(axis=...)`` stays *floating*: it carries
    no private resources and resolves them from the ambient runtime's
    defaults (the legacy shared-engine behaviour — sends and recvs
    posted on different floating devices still match when they share
    the default engine).
    """

    _ATTR_DEFAULTS = {
        "axis": None,            # mesh axis name (str) or None = loopback
        "backend": "xla",        # "xla" | "pallas" (TPU-only) | "sim"
        "max_inflight": 64,       # max transfers materialized per progress
        "allow_payload_metadata": True,
        "mesh_shape": None,       # optional dict axis->size when not in ctx
        "own_resources": False,   # private engine/pool/cq (+ endpoint)
        "name": None,
    }

    def __init__(self, axis: Optional[str] = None,
                 net_context: Optional[NetContext] = None,
                 **attrs: Any) -> None:
        self._init_attrs({"axis": axis, **attrs})
        self.stats = {"posted": 0, "transfers": 0, "progressed": 0,
                      "bytes_moved": 0}
        self.alive = True
        # ``responsive`` models the *health signal*: a frozen device
        # (silent death — still "alive" as far as anyone has declared,
        # but no longer answering progress pings) stops beating and its
        # pending transfers stall until a HeartbeatMonitor declares it
        # dead and triggers failover.
        self.responsive = True
        self.last_beat = 0           # runtime tick of the last heartbeat
        # Forwarding pointer set by NetContext.migrate: stale handles to
        # a migrated device resolve (via resolve_resources) to the
        # survivor, chained if the survivor itself later migrates.
        self.migrated_to: Optional["Device"] = None
        self._net_context = net_context
        self.endpoints: List["Endpoint"] = []
        self.transport: Optional["FaultyTransport"] = None
        self.engine: Optional[MatchingEngine] = None
        self.pool: Optional[PacketPool] = None
        self.cq: Optional[CompletionQueue] = None
        self.default_endpoint: Optional["Endpoint"] = None
        if self._attrs["own_resources"]:
            self.engine = MatchingEngine()
            self.pool = PacketPool()
            self.cq = CompletionQueue()
            self.default_endpoint = self.endpoint()
        if net_context is not None:
            net_context._attach_device(self)

    @property
    def net_context(self) -> Optional[NetContext]:
        return self._net_context

    @property
    def runtime(self) -> Optional["Runtime"]:
        """The runtime this device hangs off (None when floating)."""
        return self._net_context.runtime if self._net_context else None

    def endpoint(self, matching_engine: Optional[MatchingEngine] = None,
                 pool: Optional[PacketPool] = None,
                 cq: Optional[CompletionQueue] = None,
                 **attrs: Any) -> "Endpoint":
        """Allocate a posting endpoint on this device, optionally with a
        private matching engine / packet pool / completion queue."""
        return Endpoint(self, matching_engine=matching_engine, pool=pool,
                        cq=cq, **attrs)

    def install_transport(
            self, transport: Optional["FaultyTransport"]
    ) -> Optional["FaultyTransport"]:
        """Install (or, with ``None``, remove) a fault-injecting
        transport on *this device only*: matched transfers whose send
        side sits on this device route through it at progress time.
        Returns the previous transport.  The module-level
        :func:`install_transport` delegates here for every device of the
        default runtime (plus the runtime-wide fallback for floating
        devices)."""
        prev, self.transport = self.transport, transport
        return prev

    def pending(self, runtime: Optional["Runtime"] = None) -> int:
        """Matched-but-unprogressed transfers ledgered on this device in
        ``runtime`` (defaults to the device's own runtime, else the
        global one)."""
        rt = runtime if runtime is not None else self.runtime
        if rt is None:
            rt = _global_runtime()
        return rt.pending_for(self)

    def mark_dead(self) -> None:
        """Declare this device failed.  Matched transfers touching a
        dead device drain as ``fatal`` completions at the next progress
        call (or immediately via ``runtime().drain_dead``) instead of
        hanging their completion objects forever."""
        self.alive = False
        self.responsive = False

    def freeze(self) -> None:
        """Silent death: the device stops answering progress pings (no
        more heartbeats, its matched transfers stall in the ledger) but
        nobody has *declared* it dead yet.  A
        :class:`repro_torch.runtime.fault.HeartbeatMonitor` attached to the
        runtime notices the missing beats and triggers the configured
        ``on_dead`` policy (failover / drain / raise)."""
        self.responsive = False

    def unfreeze(self) -> None:
        if self.alive:
            self.responsive = True

    def resolve_migrated(self) -> "Device":
        """Follow the ``migrated_to`` forwarding chain to the device
        currently serving this handle's traffic (self when never
        migrated)."""
        dev: "Device" = self
        seen = set()
        while dev.migrated_to is not None and id(dev) not in seen:
            seen.add(id(dev))
            dev = dev.migrated_to
        return dev

    def __repr__(self) -> str:
        name = self._attrs.get("name")
        tag = f"{name!r}, " if name else ""
        own = ", own" if self._attrs["own_resources"] else ""
        return f"Device<{tag}axis={self.axis!r}{own}>@{id(self):x}"

    @property
    def axis(self) -> Optional[str]:
        return self._attrs["axis"]

    @property
    def axis_size(self) -> int:
        axis = self.axis
        if axis is None:
            return 1
        ms = self._attrs.get("mesh_shape")
        if ms and axis in ms:
            return int(ms[axis])
        # Inside ranks.bind_axis(axis, n) the axis is bound; query its size.
        try:
            return ranks.axis_size(axis)
        except NameError:
            raise RuntimeError(
                f"Device axis {axis!r} is not bound — post LCX ops under "
                "ranks.bind_axis over that axis, or pass mesh_shape attr"
            )


# ---------------------------------------------------------------------------
# Endpoint
# ---------------------------------------------------------------------------
class Endpoint(HasAttrs):
    """The posting resource on a device (fourth hierarchy level).

    LCI allocates one endpoint per thread (or per library) on a device;
    here an endpoint is the handle ops are posted through:
    ``send_x(buf).endpoint(ep)()`` resolves every unset resource from
    the endpoint first — its matching engine, packet pool, and default
    completion queue — before falling back to the device, net-context,
    and runtime defaults (:func:`resolve_resources`).

    By default an endpoint aliases its device's private resources; pass
    ``matching_engine=`` / ``pool=`` / ``cq=`` for a fully isolated
    endpoint (two endpoints with separate engines on one device never
    match each other's traffic).
    """

    _ATTR_DEFAULTS = {"name": None}

    def __init__(self, device: Device,
                 matching_engine: Optional[MatchingEngine] = None,
                 pool: Optional[PacketPool] = None,
                 cq: Optional[CompletionQueue] = None,
                 **attrs: Any) -> None:
        self._init_attrs(attrs)
        self.device = device
        self.engine = matching_engine if matching_engine is not None \
            else device.engine
        self.pool = pool if pool is not None else device.pool
        self.cq = cq if cq is not None else device.cq
        self.stats = {"posted": 0}
        device.endpoints.append(self)

    @property
    def runtime(self) -> Optional["Runtime"]:
        return self.device.runtime

    def __repr__(self) -> str:
        name = self._attrs.get("name")
        tag = f"{name!r} " if name else ""
        return f"Endpoint<{tag}on {self.device!r}>"


# ---------------------------------------------------------------------------
# Memory registration
# ---------------------------------------------------------------------------
@dataclasses.dataclass(eq=False)
class MemoryRegion:
    """Explicit memory registration (paper §2.2: reuse registrations to
    reduce overhead).  In XLA the analogue of registration cost is layout/
    donation setup; we track reuse so benchmarks can report it."""

    array: Any
    registration_id: int
    uses: int = 0


# ---------------------------------------------------------------------------
# Fault-injecting transport (seeded, deterministic, CPU-testable)
# ---------------------------------------------------------------------------
def signal_error(s: PostedOp, r: PostedOp, code: ErrorCode,
                 migrated: bool = False) -> None:
    """Deliver a non-ok completion to both sides of a matched pair
    (payload-less: the transfer never happened).  ``migrated=True``
    stamps the events as failover fallout — consumers treat a
    ``retry``-status migrated completion as "re-post on the survivor",
    not as a loss."""
    s.state = r.state = code.value
    if s.comp is not None:
        s.comp.signal(Event(payload=None, op=s.op_name, tag=s.tag,
                            perm=s.perm, remote=False, context=s.context,
                            status=code, migrated=migrated))
    if r.comp is not None:
        remote = s.op_name in ("put", "am")
        r.comp.signal(Event(payload=None, op=s.op_name, tag=r.tag,
                            perm=r.perm, remote=remote, context=r.context,
                            status=code, migrated=migrated))


@dataclasses.dataclass
class FaultPolicy:
    """Seeded fault schedule for :class:`FaultyTransport`.

    Rates are per matched transfer per progress attempt; they must sum
    to at most 1.  ``corrupt_mark=True`` stamps corrupted deliveries
    with :attr:`ErrorCode.RETRY` (an integrity-checked link); ``False``
    corrupts silently (the checksum-free link — higher layers must
    detect).  ``max_delays`` bounds consecutive delays per transfer so a
    pathological ``delay=1.0`` policy still terminates."""

    seed: int = 0
    drop: float = 0.0
    delay: float = 0.0
    duplicate: float = 0.0
    corrupt: float = 0.0
    corrupt_mark: bool = True
    max_delays: int = 16

    def __post_init__(self) -> None:
        total = self.drop + self.delay + self.duplicate + self.corrupt
        if not 0.0 <= total <= 1.0:
            raise ValueError(f"fault rates must sum to [0, 1], got {total}")


class FaultyTransport:
    """Injectable transport faults, mirroring the
    :class:`repro_torch.runtime.fault.FailureInjector` idiom: every decision
    comes from one seeded RNG, so a given (policy, workload) pair
    replays identically on CPU.

    Applied by ``progress()`` to each matched transfer before execution:

    - **drop** — the transfer is lost.  With retries remaining
      (``max_retries`` on the post) it is re-posted after exponential
      backoff; otherwise both sides complete with ``fatal``.
    - **delay** — the match is re-enqueued; it needs extra progress
      calls to land (bounded by ``policy.max_delays``).
    - **duplicate** — the receiver's completion object is signalled
      twice with the same payload.
    - **corrupt** — the payload arrives bitwise-inverted, stamped
      ``retry`` when ``policy.corrupt_mark``.
    """

    def __init__(self, policy: Optional[FaultPolicy] = None,
                 **policy_kwargs: Any) -> None:
        self.policy = policy if policy is not None \
            else FaultPolicy(**policy_kwargs)
        self._rng = random.Random(self.policy.seed)
        self.stats = {"transfers": 0, "drops": 0, "delays": 0,
                      "duplicates": 0, "corruptions": 0, "retries": 0,
                      "fatal": 0}

    def decide(self) -> str:
        u = self._rng.random()
        p = self.policy
        if u < p.drop:
            return "drop"
        u -= p.drop
        if u < p.delay:
            return "delay"
        u -= p.delay
        if u < p.duplicate:
            return "duplicate"
        u -= p.duplicate
        if u < p.corrupt:
            return "corrupt"
        return "ok"

    def apply(self, matches: List[Tuple[PostedOp, PostedOp]],
              rt: Optional["Runtime"] = None
              ) -> List[Tuple[PostedOp, PostedOp]]:
        """Fault-filter matched pairs; returns the ones to execute now.
        Dropped pairs go to the retry queue (or fail fatally); delayed
        pairs go back to the ledger; duplicate/corrupt pairs pass
        through with a ``fault_mark`` the execution path consumes.
        ``rt`` is the runtime whose ledger/retry queue absorbs delayed
        and dropped pairs (defaults to the global one)."""
        if rt is None:
            rt = runtime()
        out: List[Tuple[PostedOp, PostedOp]] = []
        for s, r in matches:
            self.stats["transfers"] += 1
            action = self.decide()
            if action == "delay" and s.delays >= self.policy.max_delays:
                action = "ok"
            if action == "drop":
                self.stats["drops"] += 1
                if rt.schedule_retry(s, r):
                    self.stats["retries"] += 1
                else:
                    self.stats["fatal"] += 1
                    signal_error(s, r, ErrorCode.FATAL)
            elif action == "delay":
                self.stats["delays"] += 1
                s.delays += 1
                rt.enqueue_matches([(s, r)])
            elif action == "duplicate":
                self.stats["duplicates"] += 1
                s.fault_mark = "duplicate"
                out.append((s, r))
            elif action == "corrupt":
                self.stats["corruptions"] += 1
                s.fault_mark = ("corrupt" if self.policy.corrupt_mark
                                else "corrupt_silent")
                out.append((s, r))
            else:
                s.delays = 0
                out.append((s, r))
        return out


# ---------------------------------------------------------------------------
# Runtime (default resources + pending transfer ledger)
# ---------------------------------------------------------------------------
_RUNTIME_IDS = itertools.count(1)


class Runtime:
    """Top of the resource hierarchy: default resources, the
    pending-transfer ledger, and the fault clocks.

    The paper: "There will be a default set of resources allocated by the
    runtime.  Users only need to explicitly manage resources when they
    find it necessary.  Users can also disable this default resource
    allocation."

    A Runtime is independently constructible — ``Runtime()`` gives a
    fully isolated instance whose traffic, ``pending()`` accounting,
    fault injection, and :meth:`finalize` leak check never touch the
    global default runtime (which is itself just a lazily created
    ``Runtime`` — the ``g_runtime`` idiom).  Default resources are
    allocated *through the hierarchy*: one :class:`NetContext`, holding
    one default :class:`Device` with a private engine/pool/completion
    queue and a default :class:`Endpoint`; ``default_engine`` etc. are
    views onto that default device's resources.
    """

    def __init__(self, alloc_default_resources: bool = True,
                 default_axis: Optional[str] = None,
                 name: Optional[str] = None,
                 dedup_window: int = 4096) -> None:
        self.name = name or f"runtime-{next(_RUNTIME_IDS)}"
        self._seq = itertools.count()
        self._reg_ids = itertools.count(1)
        self.net_contexts: List[NetContext] = []
        self.default_net_context: Optional[NetContext] = None
        self.default_device: Optional[Device] = None
        self.default_endpoint: Optional[Endpoint] = None
        self.default_pool: Optional[PacketPool] = None
        self.default_engine: Optional[MatchingEngine] = None
        self.default_cq: Optional[CompletionQueue] = None
        if alloc_default_resources:
            nc = self.net_context()
            dev = nc.device(axis=default_axis)
            self.default_device = dev
            self.default_endpoint = dev.default_endpoint
            self.default_pool = dev.pool
            self.default_engine = dev.engine
            self.default_cq = dev.cq
        # (send, recv) matches waiting for a progress() call, ledgered
        # per device so take_ready(device) is an O(1) dict pop instead of
        # a quadratic filter over one global list.  A cross-device match
        # (shared engine, different devices) is indexed under BOTH
        # devices; entries are [match, taken] cells so whichever ledger
        # is drained first claims the match.  Keys are the Device objects
        # themselves (identity-hashed) so leak reports can name them.
        self._ready: Dict[Device, List[List[Any]]] = {}
        self._n_pending = 0
        # Fault path: progress-call tick counter, optional fault-injecting
        # transport, backoff retry queue (min-heap on release tick), and
        # the deadline watchlist for ops posted with a timeout.
        self.tick = 0
        self.transport: Optional[FaultyTransport] = None
        self._retry_q: List[Tuple[int, int, Tuple[PostedOp, PostedOp]]] = []
        self._timed: List[PostedOp] = []
        # Failover machinery: an optional heartbeat monitor polled each
        # progress tick (duck-typed: anything with ``poll(rt)``), and the
        # delivered-seq dedup window that makes post-migration replay
        # exactly-once (a migrated transfer whose seq already delivered
        # is suppressed; the window is bounded so memory stays flat).
        self.heartbeat: Optional[Any] = None
        self._dedup_window = max(1, int(dedup_window))
        self._delivered_seqs: set = set()
        self._delivered_order: deque = deque()
        self.failover_stats = {"failovers": 0, "migrated_ops": 0,
                               "dedup_suppressed": 0, "replayed": 0,
                               "reposted": 0}
        # Aggregation-plan cache: (axis, perm-key, dtype-sig, shape-sig)
        # -> concat/slice layout, reused across progress calls so
        # steady-state loops don't re-derive pack/unpack plans.
        self.agg_plans: Dict[Any, Any] = {}
        self.plan_stats: Dict[str, int] = {"hits": 0, "misses": 0}
        self._rcomp_registry: Dict[int, CompletionObject] = {}
        self._rcomp_next = itertools.count(1)
        self._lock = threading.Lock()

    # -- hierarchy ----------------------------------------------------------
    def _attach_net_context(self, nc: "NetContext") -> None:
        self.net_contexts.append(nc)
        if self.default_net_context is None:
            self.default_net_context = nc

    def net_context(self, backend: Optional[str] = None,
                    **attrs: Any) -> "NetContext":
        """Allocate a new :class:`NetContext` owned by this runtime."""
        return NetContext(runtime=self, backend=backend, **attrs)

    def device(self, axis: Optional[str] = None, **attrs: Any) -> "Device":
        """Allocate an isolated device (private engine/pool/cq) on this
        runtime's default net context, creating one if needed."""
        nc = self.default_net_context
        if nc is None:
            nc = self.net_context()
        return nc.device(axis=axis, **attrs)

    def devices(self) -> List["Device"]:
        """Every device attached to this runtime, across net contexts."""
        return [d for nc in self.net_contexts for d in nc.devices]

    # -- sequencing ---------------------------------------------------------
    def next_seq(self) -> int:
        return next(self._seq)

    # -- remote completion registry ------------------------------------------
    def register_rcomp(self, comp: CompletionObject) -> int:
        rid = next(self._rcomp_next)
        if rid >= (1 << MAX_RCOMP_BITS):
            raise RuntimeError("remote completion handler space exhausted")
        self._rcomp_registry[rid] = comp
        return rid

    def rcomp(self, rid: int) -> CompletionObject:
        return self._rcomp_registry[rid]

    # -- memory registration ---------------------------------------------------
    def register_memory(self, array: Any) -> MemoryRegion:
        return MemoryRegion(array=array, registration_id=next(self._reg_ids))

    # -- match ledger -----------------------------------------------------------
    def enqueue_matches(
            self, matches: List[Tuple[PostedOp, PostedOp]]) -> None:
        for m in matches:
            entry = [m, False]
            d0 = m[0].device
            self._ready.setdefault(d0, []).append(entry)
            d1 = m[1].device
            if d1 is not d0:
                self._ready.setdefault(d1, []).append(entry)
            self._n_pending += 1

    def take_ready(self, device: Optional[Device] = None
                   ) -> List[Tuple[PostedOp, PostedOp]]:
        out: List[Tuple[PostedOp, PostedOp]] = []
        if device is None:
            for ledger in self._ready.values():
                for entry in ledger:
                    if not entry[1]:
                        entry[1] = True
                        out.append(entry[0])
            self._ready.clear()
        else:
            for entry in self._ready.pop(device, ()):
                if not entry[1]:
                    entry[1] = True
                    out.append(entry[0])
        self._n_pending -= len(out)
        return out

    def pending_count(self) -> int:
        # backoff-queued retries are still in flight: they re-enter the
        # ledger when due, so they count toward backpressure and the
        # finalize() leak check
        return self._n_pending + len(self._retry_q)

    def pending_for(self, device: Device) -> int:
        """Matched-but-unprogressed transfers touching ``device``
        (ledger entries plus backoff-queued retries)."""
        n = sum(1 for entry in self._ready.get(device, ()) if not entry[1])
        n += sum(1 for _, _, (s, r) in self._retry_q
                 if s.device is device or r.device is device)
        return n

    def pending_by_device(self) -> Dict[Device, int]:
        """Per-device pending breakdown.  A cross-device match counts
        under both of its devices, so the sum may exceed
        :meth:`pending_count`."""
        out: Dict[Device, int] = {}
        for dev, ledger in self._ready.items():
            n = sum(1 for entry in ledger if not entry[1])
            if n:
                out[dev] = n
        for _, _, (s, r) in self._retry_q:
            for dev in {id(s.device): s.device, id(r.device): r.device}.values():
                out[dev] = out.get(dev, 0) + 1
        return out

    def finalize(self, strict: bool = True) -> None:
        """Leak-check this runtime.  With ``strict`` raises if any
        matched transfer was never progressed, naming the devices the
        leaks sit on."""
        n = self.pending_count()
        if strict and n:
            per_dev = ", ".join(
                f"{dev!r}: {cnt}"
                for dev, cnt in self.pending_by_device().items())
            raise RuntimeError(
                f"lcx.finalize(): {n} matched transfers never progressed "
                f"on {self.name} ({per_dev})")
        self._ready.clear()
        self._retry_q = []
        self._n_pending = 0

    # -- fault path: retries, deadlines, dead devices -------------------------
    def schedule_retry(self, s: PostedOp, r: PostedOp) -> bool:
        """Queue a lost/backpressured matched pair for an exponential-
        backoff re-post.  Returns False (caller must surface an error)
        when the pair has no retry budget left or its deadline already
        elapsed."""
        budget = max(s.max_retries, r.max_retries)
        if s.retries >= budget:
            return False
        if s.timeout is not None and \
                self.tick - s.posted_tick >= s.timeout:
            return False
        s.retries += 1
        backoff = 1 << (s.retries - 1)
        heapq.heappush(self._retry_q,
                       (self.tick + backoff, s.seq, (s, r)))
        return True

    def release_retries(self) -> None:
        """Move due retry entries back into the transfer ledger; expire
        the ones whose op deadline passed while backing off."""
        while self._retry_q and self._retry_q[0][0] <= self.tick:
            _, _, (s, r) = heapq.heappop(self._retry_q)
            if s.timeout is not None and \
                    self.tick - s.posted_tick >= s.timeout:
                signal_error(s, r, ErrorCode.TIMEOUT)
                continue
            self.enqueue_matches([(s, r)])

    def watch_deadline(self, op: PostedOp) -> None:
        op.posted_tick = self.tick
        if op.timeout is not None:
            self._timed.append(op)

    def expire_timeouts(self) -> None:
        """Retire engine-pending ops whose progress-call deadline passed:
        they are cancelled out of the matching engine and their
        completion object receives a ``timeout`` event."""
        if not self._timed:
            return
        still: List[PostedOp] = []
        for op in self._timed:
            if op.state != "pending":
                continue                      # matched/retired: deadline moot
            if self.tick - op.posted_tick < op.timeout:
                still.append(op)
                continue
            if op.engine is not None:
                op.engine.cancel(op)
            op.state = "timeout"
            if op.comp is not None:
                op.comp.signal(Event(payload=None, op=op.op_name, tag=op.tag,
                                     perm=op.perm, remote=False,
                                     context=op.context,
                                     status=ErrorCode.TIMEOUT))
        self._timed = still

    def drain_dead(self, device: Optional[Device] = None) -> int:
        """Drain matched transfers touching a dead device as ``fatal``
        completions.  With ``device=None`` every ledger entry whose send
        or recv device died is drained.  Returns the drain count."""
        drained = 0
        for s, r in self.take_ready(device):
            if s.device.alive and r.device.alive:
                self.enqueue_matches([(s, r)])   # healthy: put it back
            else:
                signal_error(s, r, ErrorCode.FATAL)
                drained += 1
        keep: List[Tuple[int, int, Tuple[PostedOp, PostedOp]]] = []
        for entry in self._retry_q:
            s, r = entry[2]
            if s.device.alive and r.device.alive:
                keep.append(entry)
            else:
                signal_error(s, r, ErrorCode.FATAL)
                drained += 1
        if len(keep) != len(self._retry_q):
            heapq.heapify(keep)
            self._retry_q = keep
        return drained

    def has_inflight(self) -> bool:
        """True while time-based work (backoff retries, armed deadlines)
        can still make progress — callers polling the engine should keep
        driving ``progress()`` rather than declare deadlock.  With a
        heartbeat monitor attached, ledger entries stalled on a frozen
        device also count: the monitor will declare the device dead and
        fail the transfers over (or drain them), so they are recoverable
        by driving more progress."""
        if self._retry_q:
            return True
        if self.heartbeat is not None and self._n_pending:
            return True
        return any(op.state == "pending" for op in self._timed)

    # -- failover: dedup window, ledger retarget, survivor choice -------------
    def note_delivered(self, seq: int) -> None:
        """Record an op seq whose receiver-side delivery was absorbed.
        The window is bounded (``dedup_window``): old seqs age out, so a
        migrated replay arriving *after* eviction delivers again — the
        window must cover the failure-detection latency, not history."""
        if seq in self._delivered_seqs:
            return
        self._delivered_seqs.add(seq)
        self._delivered_order.append(seq)
        while len(self._delivered_order) > self._dedup_window:
            self._delivered_seqs.discard(self._delivered_order.popleft())

    def was_delivered(self, seq: int) -> bool:
        return seq in self._delivered_seqs

    def retarget_pending(self, dead: Device, target: Device,
                         can_replay: bool = True) -> Tuple[int, int, int]:
        """Re-point ledger/retry-queue matches touching ``dead`` at
        ``target``.  Replayable pairs re-enqueue (marked migrated);
        non-replayable ones complete ``retry``+``migrated`` on both
        sides.  Returns (n_ledger, n_retry, n_signalled)."""
        def _repoint(s: PostedOp, r: PostedOp) -> None:
            if s.device is dead:
                s.device = target
            if r.device is dead:
                r.device = target
            s.migrated = r.migrated = True

        n_ledger = n_retry = n_signalled = 0
        for s, r in self.take_ready(dead):
            if s.device is not dead and r.device is not dead:
                self.enqueue_matches([(s, r)])   # foreign entry: put back
                continue
            n_ledger += 1
            _repoint(s, r)
            if can_replay:
                self.enqueue_matches([(s, r)])
            else:
                signal_error(s, r, ErrorCode.RETRY, migrated=True)
                n_signalled += 1
        keep: List[Tuple[int, int, Tuple[PostedOp, PostedOp]]] = []
        for entry in self._retry_q:
            s, r = entry[2]
            if s.device is not dead and r.device is not dead:
                keep.append(entry)
                continue
            n_retry += 1
            _repoint(s, r)
            if can_replay:
                keep.append(entry)
            else:
                signal_error(s, r, ErrorCode.RETRY, migrated=True)
                n_signalled += 1
        if len(keep) != len(self._retry_q):
            heapq.heapify(keep)
            self._retry_q = keep
        return n_ledger, n_retry, n_signalled

    def failover(self, dev: Device, target: Optional[Device] = None,
                 replay: bool = True) -> "MigrationReport":
        """Migrate ``dev``'s communication state onto a survivor.

        Without an explicit ``target``, picks the least-loaded alive
        device (fewest pending transfers), preferring same-net-context,
        same-axis candidates — endpoints, un-matched ops, and in-flight
        ledger entries move per :meth:`NetContext.migrate`.  Raises
        ``RuntimeError`` when no survivor exists."""
        if target is None:
            def rank(d: Device) -> Tuple[int, int, int]:
                same_nc = 0 if d.net_context is dev.net_context else 1
                same_axis = 0 if d.axis == dev.axis else 1
                return (same_nc, same_axis, self.pending_for(d))

            candidates = [d for d in self.devices()
                          if d is not dev and d.alive and d.responsive]
            if not candidates:
                raise RuntimeError(
                    f"failover({dev!r}): no alive device left on "
                    f"{self.name}")
            target = min(candidates, key=rank)
        nc = dev.net_context or target.net_context \
            or self.default_net_context
        if nc is None:
            nc = self.net_context()
        report = nc.migrate(dev, target, replay=replay)
        self.failover_stats["failovers"] += 1
        self.failover_stats["migrated_ops"] += (
            report.n_engine_ops + report.n_ledger + report.n_retry)
        if report.replayed:
            self.failover_stats["replayed"] += (
                report.n_ledger + report.n_retry)
        self.failover_stats["reposted"] += report.n_reposted
        return report


# ---------------------------------------------------------------------------
# Global default runtime (the paper's ``g_runtime`` idiom)
# ---------------------------------------------------------------------------
_RUNTIME: Optional[Runtime] = None


def init(alloc_default_resources: bool = True,
         default_axis: Optional[str] = None) -> Runtime:
    """Initialize the global default LCX runtime (idempotent re-init
    replaces it).  Explicit ``init()`` works even under
    ``LCX_NO_GLOBAL_RUNTIME=1`` — the flag only disables *lazy*
    auto-creation via :func:`runtime`."""
    global _RUNTIME
    _RUNTIME = Runtime(alloc_default_resources=alloc_default_resources,
                       default_axis=default_axis, name="g_runtime")
    return _RUNTIME


def finalize(strict: bool = True, runtime: Optional[Runtime] = None) -> None:
    """Tear down a runtime with a leak check.  Without ``runtime``,
    finalizes and clears the global default instance; with one, finalizes
    that runtime only (the global, if any, is untouched)."""
    global _RUNTIME
    if runtime is not None:
        runtime.finalize(strict=strict)
        if runtime is _RUNTIME:
            _RUNTIME = None
        return
    if _RUNTIME is not None:
        rt, _RUNTIME = _RUNTIME, None
        rt.finalize(strict=strict)


def runtime() -> Runtime:
    """The global default runtime, lazily created on first use.  Set
    ``LCX_NO_GLOBAL_RUNTIME=1`` to disable lazy creation and require
    explicit :func:`init` / injected ``Runtime`` objects everywhere."""
    global _RUNTIME
    if _RUNTIME is None:
        if os.environ.get("LCX_NO_GLOBAL_RUNTIME", "") not in ("", "0"):
            raise RuntimeError(
                "LCX_NO_GLOBAL_RUNTIME is set: the global default runtime "
                "is disabled. Call lcx.init() explicitly or pass a Runtime "
                "via .runtime(rt)/.endpoint(ep).")
        _RUNTIME = Runtime(name="g_runtime")
    return _RUNTIME


# Internal alias: lets code with a ``runtime=None`` *parameter* still
# reach the module-level accessor without shadowing.
_global_runtime = runtime


def install_transport(
        transport: Optional[FaultyTransport],
        runtime: Optional[Runtime] = None) -> Optional[FaultyTransport]:
    """Install (or, with ``None``, remove) a fault-injecting transport on
    a runtime: sets the runtime-wide fallback AND delegates to every
    device currently attached (per-device installs override the
    fallback; use :meth:`Device.install_transport` directly for
    single-device chaos).  Defaults to the global runtime.  Returns the
    previous runtime-wide transport."""
    rt = runtime if runtime is not None else _global_runtime()
    prev, rt.transport = rt.transport, transport
    for dev in rt.devices():
        dev.install_transport(transport)
    return prev


# ---------------------------------------------------------------------------
# Resource resolution (endpoint → device → net context → runtime defaults)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class ResolvedResources:
    """The concrete resource set a posting op runs against, resolved by
    :func:`resolve_resources` from whatever handles the caller supplied."""
    runtime: Runtime
    device: Optional[Device]
    endpoint: Optional[Endpoint]
    engine: Optional[MatchingEngine]
    pool: Optional[PacketPool]
    cq: Optional[CompletionQueue]


def resolve_resources(runtime: Optional[Runtime] = None,
                      endpoint: Optional[Endpoint] = None,
                      device: Optional[Device] = None,
                      engine: Optional[MatchingEngine] = None,
                      pool: Optional[PacketPool] = None,
                      ) -> ResolvedResources:
    """Single resolution path for every posting op (paper §2.2: "an
    operation resolves its resources most-specific-first").

    Precedence, per resource: explicit argument > endpoint > device >
    runtime defaults.  The owning runtime is found by walking up the
    hierarchy (endpoint → device → net context → runtime); a *floating*
    device (bare ``Device(...)``, no hierarchy parent) resolves engine/
    pool from the ambient runtime's defaults — the legacy shared-pool
    behaviour that lets two bare devices on one axis still match.
    """
    if endpoint is not None and device is not None \
            and endpoint.device is not device:
        raise ValueError(
            f"endpoint {endpoint!r} belongs to {endpoint.device!r}, "
            f"not the explicitly passed {device!r}")
    if endpoint is not None and device is None:
        device = endpoint.device
    if device is not None and device.migrated_to is not None:
        # stale handle to a failed-over device: forward to the survivor
        device = device.resolve_migrated()
    rt = runtime
    if rt is None and device is not None:
        rt = device.runtime          # None when the device floats
    if rt is None:
        rt = _global_runtime()
    if device is None:
        device = rt.default_device
    ep = endpoint
    if ep is None and device is not None:
        ep = device.default_endpoint  # None for floating devices
    if engine is None:
        engine = ep.engine if ep is not None else None
    if engine is None and device is not None:
        engine = device.engine
    if engine is None:
        engine = rt.default_engine
    if pool is None:
        pool = ep.pool if ep is not None else None
    if pool is None and device is not None:
        pool = device.pool
    if pool is None:
        pool = rt.default_pool
    cq = ep.cq if ep is not None else None
    if cq is None and device is not None:
        cq = device.cq
    if cq is None:
        cq = rt.default_cq
    return ResolvedResources(runtime=rt, device=device, endpoint=ep,
                             engine=engine, pool=pool, cq=cq)
