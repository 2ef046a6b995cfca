"""The program's expert choices in the window, by request and position.

In a cell whose configuration has routed experts, the harness records,
from outside the program, what each call of
``repro_torch.models.moe.route`` chose: in a prefill, one request's
positions 0 to P - 1; in a decode tick, one row a live slot, at the
position its cache is filled to.  The i-th call inside one prefill or
tick is the i-th expert layer.  The ids stay on the card, untouched,
until the window has closed: nothing is copied or waited for inside it.
The check compares these sets with the reference's (``check.gaps``).
"""
from __future__ import annotations

from typing import Dict, FrozenSet, List, Tuple


class RouteLog:
    """Installs the recorder on ``engine``; ``on`` while the window runs."""

    def __init__(self, engine):
        self.engine = engine
        self.on = False
        self._ctx = None
        self._calls: List[Tuple] = []   # (kind, info, [ids a layer])
        self._restore: List = []

    def install(self) -> "RouteLog":
        from repro_torch.models import moe
        eng = self.engine
        admit, decode, route = eng._admit_one, eng._decode_tick, moe.route

        def admit_one(req):
            return self._within(("prefill", req.rid), admit, req)

        def decode_tick():
            live = [(i, r.rid, int(eng.lengths[i]))
                    for i, r in enumerate(eng.slot_req) if r is not None]
            return self._within(("decode", live), decode)

        def recorded(cfg, router_p, x):
            out = route(cfg, router_p, x)
            if self._ctx is not None:
                self._ctx[2].append(out[0])
            return out

        self._restore = [(eng, "_admit_one", admit),
                         (eng, "_decode_tick", decode),
                         (moe, "route", route)]
        eng._admit_one, eng._decode_tick = admit_one, decode_tick
        moe.route = recorded
        return self

    def _within(self, ctx, fn, *args):
        if not self.on:
            return fn(*args)
        self._ctx = (ctx[0], ctx[1], [])
        self._calls.append(self._ctx)
        try:
            return fn(*args)
        finally:
            self._ctx = None

    def uninstall(self) -> None:
        for obj, name, value in reversed(self._restore):
            setattr(obj, name, value)
        self._restore = []

    def sets(self, rids) -> Dict[int, Dict[int, Tuple[FrozenSet[int], ...]]]:
        """For each request of ``rids``: position -> the expert set the
        program chose there in each expert layer."""
        want = set(rids)
        out: Dict[int, Dict[int, Tuple[FrozenSet[int], ...]]] = {
            r: {} for r in want}
        for kind, info, layers in self._calls:
            if kind == "prefill":
                if info not in want:
                    continue
                per = [ids.cpu().tolist() for ids in layers]
                for pos in range(len(per[0]) if per else 0):
                    out[info][pos] = tuple(frozenset(p[pos]) for p in per)
            else:
                rows = [(slot, rid, pos) for slot, rid, pos in info
                        if rid in want]
                if not rows:
                    continue
                per = [ids.cpu().tolist() for ids in layers]
                for slot, rid, pos in rows:
                    out[rid][pos] = tuple(frozenset(p[slot]) for p in per)
        return out
