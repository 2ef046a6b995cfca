"""Fault tolerance machinery: failure detection, straggler mitigation,
elastic remesh (the port of ``repro/runtime/fault.py``).

On a real cluster the failure signal comes from the coordinator (a
``torch.distributed`` heartbeat / barrier timeout); here the same control
flow is driven by injectable signals so every policy is testable on CPU:

- :class:`FailureInjector` raises ``NodeFailure`` at chosen steps.
- :class:`StragglerMonitor` keeps an EMA of step time and flags steps
  slower than ``threshold ×`` EMA; after ``patience`` consecutive flags
  it recommends a remesh (drop the slow host) — the AMT-style answer to
  stragglers (work steals around slow nodes; SPMD can only reshape).
- :class:`HeartbeatMonitor` watches per-device heartbeats (progress-tick
  driven, same EMA idiom) and declares silently dead devices, triggering
  live endpoint failover (``runtime.failover``), a fatal drain, or a
  raised ``NodeFailure`` per its ``on_dead`` policy.
- :func:`elastic_reshard` moves live state onto new shardings or devices.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from ..device import resolve_device

PyTree = Any


class NodeFailure(RuntimeError):
    """Raised when a (simulated) node drops out of the job."""

    def __init__(self, msg: str, lost_devices: int = 0) -> None:
        super().__init__(msg)
        self.lost_devices = lost_devices


class FailureInjector:
    """Deterministic failure schedule for tests/examples.

    ``devices`` optionally names LCX :class:`~repro_torch.core.Device` objects
    to kill when the failure fires: each is marked dead and its pending
    transfer ledger drains as ``fatal`` completion events (see
    :func:`fail_device`), so comm-blocked waiters observe the loss
    instead of hanging."""

    def __init__(self, fail_at: Sequence[int] = (),
                 lost_devices: int = 0,
                 devices: Sequence[Any] = (),
                 runtime: Optional[Any] = None) -> None:
        self.fail_at = set(fail_at)
        self.lost_devices = lost_devices
        self.devices = list(devices)
        self.runtime = runtime
        self.fired: List[int] = []

    def check(self, step: int) -> None:
        if step in self.fail_at:
            self.fail_at.discard(step)
            self.fired.append(step)
            for dev in self.devices:
                fail_device(dev, runtime=self.runtime)
            raise NodeFailure(f"injected node failure at step {step}",
                              self.lost_devices)


def fail_device(device: Any, runtime: Optional[Any] = None) -> int:
    """Mark an LCX device dead and drain its pending ledger as ``fatal``
    completions.  Returns the number of transfers drained.  This is the
    bridge from :class:`NodeFailure` to the comm layer: completion
    objects waiting on the dead device observe ``ErrorCode.FATAL``
    events (no infinite hang) and the caller can proceed to
    :func:`elastic_reshard`.

    The ledger drained is, in order: the explicitly passed ``runtime``,
    the device's own runtime (hierarchy-created devices), else the
    global default."""
    device.mark_dead()
    rt = runtime
    if rt is None:
        rt = getattr(device, "runtime", None)
    if rt is None:
        from ..core import runtime as _global  # core stays optional
        rt = _global()
    return rt.drain_dead(device)


class StragglerMonitor:
    """EMA-based straggler detection with a remesh recommendation."""

    def __init__(self, threshold: float = 2.0, patience: int = 3,
                 ema_decay: float = 0.9) -> None:
        self.threshold = threshold
        self.patience = patience
        self.ema_decay = ema_decay
        self.ema: Optional[float] = None
        self.slow_streak = 0
        self.events: List[Dict[str, float]] = []

    def observe(self, step: int, dt: float) -> str:
        """-> 'ok' | 'slow' | 'remesh'."""
        if self.ema is None:
            self.ema = dt
            return "ok"
        verdict = "ok"
        if dt > self.threshold * self.ema:
            self.slow_streak += 1
            self.events.append({"step": step, "dt": dt, "ema": self.ema})
            verdict = "slow"
            if self.slow_streak >= self.patience:
                verdict = "remesh"
                self.slow_streak = 0
        else:
            self.slow_streak = 0
            # only fold healthy steps into the EMA
            self.ema = self.ema_decay * self.ema + (1 - self.ema_decay) * dt
        return verdict


class HeartbeatMonitor:
    """Progress-tick-driven device liveness detection with automatic
    failover (builds on :class:`StragglerMonitor`'s EMA idiom).

    Every ``lcx.progress()`` call pings the runtime's devices: each
    alive, responsive device records a beat (``device.last_beat`` =
    current tick), then the monitor polls.  A healthy device's
    inter-beat gap folds into a per-device EMA; a device whose current
    gap exceeds ``threshold ×`` EMA (and at least ``grace`` ticks) for
    ``patience`` consecutive polls is declared dead:

    - ``on_dead="failover"`` — ``runtime.failover(dev)``: endpoints,
      un-matched posted ops, and in-flight ledger entries migrate onto
      the least-loaded survivor (see ``NetContext.migrate``).
    - ``on_dead="drain"``   — :func:`fail_device`: the classic fatal
      drain (completion objects observe the loss).
    - ``on_dead="raise"``   — raise :class:`NodeFailure` out of the
      progress call.

    Attach with ``monitor.attach(rt)`` (sets ``rt.heartbeat``);
    ``monitor.events`` records every declaration for postmortems and
    recovery-latency measurement (``failoverbench.py``)."""

    POLICIES = ("failover", "drain", "raise")

    def __init__(self, threshold: float = 3.0, patience: int = 2,
                 grace: int = 4, ema_decay: float = 0.9,
                 on_dead: str = "failover", replay: bool = True) -> None:
        if on_dead not in self.POLICIES:
            raise ValueError(f"unknown on_dead policy {on_dead!r}")
        self.threshold = threshold
        self.patience = patience
        self.grace = max(1, grace)
        self.ema_decay = ema_decay
        self.on_dead = on_dead
        self.replay = replay
        # per-device (id-keyed): EMA of inter-beat gaps, last seen beat,
        # consecutive suspect polls
        self._ema: Dict[int, float] = {}
        self._seen_beat: Dict[int, int] = {}
        self._suspect: Dict[int, int] = {}
        self.events: List[Dict[str, Any]] = []

    def attach(self, runtime: Any) -> "HeartbeatMonitor":
        runtime.heartbeat = self
        return self

    def poll(self, runtime: Any) -> List[Any]:
        """Called by ``progress()`` after the beat sweep.  Returns the
        devices declared dead this poll (already handled per policy)."""
        declared: List[Any] = []
        tick = runtime.tick
        for dev in runtime.devices():
            if not dev.alive:
                continue
            key = id(dev)
            seen = self._seen_beat.get(key)
            if seen is None:
                # first sighting: start the clock at this tick
                self._seen_beat[key] = dev.last_beat or tick
                continue
            if dev.last_beat > seen:
                gap = dev.last_beat - seen
                self._seen_beat[key] = dev.last_beat
                self._suspect[key] = 0
                prev = self._ema.get(key)
                self._ema[key] = gap if prev is None else (
                    self.ema_decay * prev + (1 - self.ema_decay) * gap)
                continue
            # no beat since last poll: how overdue is it?
            gap = tick - seen
            expected = max(self._ema.get(key, 1.0), 1.0)
            if gap >= self.grace and gap > self.threshold * expected:
                self._suspect[key] = self._suspect.get(key, 0) + 1
                if self._suspect[key] >= self.patience:
                    declared.append(dev)
                    self._suspect[key] = 0
        for dev in declared:
            self._declare_dead(runtime, dev)
        return declared

    def _declare_dead(self, runtime: Any, dev: Any) -> None:
        event: Dict[str, Any] = {"tick": runtime.tick, "device": dev,
                                 "policy": self.on_dead}
        if self.on_dead == "failover":
            try:
                report = runtime.failover(dev, replay=self.replay)
                event["target"] = report.target
                event["report"] = report
            except RuntimeError as e:
                # no survivor left: degrade to the fatal drain
                event["policy"] = "drain"
                event["error"] = str(e)
                fail_device(dev, runtime=runtime)
        elif self.on_dead == "drain":
            fail_device(dev, runtime=runtime)
        self.events.append(event)
        if self.on_dead == "raise":
            dev.mark_dead()
            raise NodeFailure(
                f"heartbeat lost on {dev!r} at tick {runtime.tick}", 1)


def elastic_reshard(tree: PyTree, shardings: PyTree) -> PyTree:
    """Move live state onto new shardings (a new mesh) or devices: each
    tensor leaf of ``tree`` takes the matching leaf of ``shardings``.  A
    :class:`~repro_torch.parallel.NamedSharding` is a layout over ranks
    that all live on the tensor's card, so the tensor stays as it is; a
    ``torch.device`` or device string (``None``: the card) moves it.
    Works for both shrink (node loss) and grow (node recovery); shapes
    are unchanged.  A list of nests (``params["stack"]``, one per period)
    takes one shardings nest for all its periods, as the reference holds
    them stacked; a dataclass (``AdamWState``) takes one of its kind."""
    from ..parallel.sharding import NamedSharding
    if isinstance(tree, torch.Tensor):
        if isinstance(shardings, NamedSharding):
            return tree
        return tree.to(resolve_device(shardings))
    if isinstance(tree, dict):
        return {k: elastic_reshard(v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        if isinstance(shardings, dict):
            return type(tree)(elastic_reshard(t, shardings) for t in tree)
        return type(tree)(elastic_reshard(t, d)
                          for t, d in zip(tree, shardings))
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: elastic_reshard(getattr(tree, f.name),
                                    getattr(shardings, f.name))
            for f in dataclasses.fields(tree)})
    return tree


def shrink_mesh_shape(shape: Dict[str, int], lost: int) -> Dict[str, int]:
    """Halve the data axis until the lost devices are covered — the
    remesh policy used when a host drops (model axis is preserved so
    parameter layouts stay valid).  Losing ANY device forces at least
    one halving (the dead host's row is gone).

    Each halving removes ``data/2 × (product of the other axes)``
    *actual* devices; the count accumulates until it reaches ``lost``
    (or the data axis bottoms out at 1)."""
    new = dict(shape)
    other = 1
    for axis, n in new.items():
        if axis != "data":
            other *= n
    covered = 0
    while covered < max(lost, 1) and new.get("data", 1) > 1:
        new["data"] //= 2
        covered += new["data"] * other
    return new
