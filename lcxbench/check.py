"""How ``correct`` is decided: served tokens against the plain reference.

After the window closes, a sample drawn from the seed of the requests the
engine finished (the one with the most tokens always in it, then others
until ``served_tokens`` served tokens are in it) goes through the
configuration's reference once each, prompt and served tokens in one
causal pass.  At every served position the gap is the reference's best
logit less its logit of the token the program served (0 where they
agree).  The numbers compared are the ones the cell's limits file names:
the widest gap; or, in a model with routed experts, the widest gap over
the positions whose routing is clear (the reference's k-th expert score
leads its (k + 1)-th by the file's ``route_margin`` in every expert
layer, so that rounding cannot swap a chosen expert there), beside the
share of the experts the program chose that the reference did not.
The control puts the reference, with its matrix products in float8, in
the program's place: the same readings of the token that float8 puts
first and of float8's expert sets.
"""
from __future__ import annotations

import importlib
import time
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from . import families


def reference(cfg: Dict):
    """The configuration's plain reference module, found by name: a module
    of ``lcxbench/reference/``, or any importable module by its dotted
    name."""
    name = cfg["reference"]
    return importlib.import_module(name if "." in name
                                   else f"lcxbench.reference.{name}")


def sample(finished: Sequence, seed: int, served_tokens: int) -> List:
    """The requests to compare: the one with the most tokens, then others
    in an order drawn from the seed until ``served_tokens`` are in."""
    if not finished:
        return []
    longest = max(finished, key=lambda r: (len(r.prompt) + len(r.output),
                                           -r.rid))
    rest = [r for r in finished if r is not longest]
    order = np.random.default_rng([seed % 2 ** 64, 7]).permutation(len(rest))
    out, n = [longest], len(longest.output)
    for i in order:
        if n >= served_tokens:
            break
        out.append(rest[i])
        n += len(rest[i].output)
    return out


def _sequence(req, device) -> torch.Tensor:
    """Prompt and served tokens but the last: the positions that predict
    each served token."""
    toks = np.concatenate([np.asarray(req.prompt, np.int64),
                           np.asarray(req.output[:-1], np.int64)])
    return torch.as_tensor(toks, device=device)


def _sets(routes, lo: int, hi: int):
    """Per position of ``lo`` .. ``hi`` - 1, the expert set of each layer
    of a reference's ``routes`` ((ids [N, k], margins [N]) a layer)."""
    per = [ids[lo:hi].cpu().tolist() for ids, _ in routes]
    return [tuple(frozenset(p[i]) for p in per) for i in range(hi - lo)]


def _margins(routes, lo: int, hi: int) -> torch.Tensor:
    """Per position, the smallest margin over the expert layers."""
    return torch.stack([m[lo:hi] for _, m in routes]).amin(0).float().cpu()


def _compare(mine, want, k: int) -> Tuple[bool, float]:
    """(whether the program's expert sets at one position equal the
    reference's in every expert layer, the share of the program's chosen
    experts there that the reference did not choose)."""
    if mine is None:
        return False, 1.0
    missed = sum(len(a - b) for a, b in zip(mine, want))
    return mine == want, missed / (k * len(want))


def _readings(g: torch.Tensor, agree: torch.Tensor, missed: torch.Tensor,
              clear: torch.Tensor) -> Dict[str, float]:
    """The widest and mean gap, the share not the first choice, the
    widest gap where the routing is clear, the widest gap where the
    expert sets agree and the share of chosen experts the reference did
    not choose."""
    n = len(g)
    return {"": float(g.max()) if n else 0.0,
            "_clear": float(g[clear].max()) if bool(clear.any()) else 0.0,
            "_mean": float(g.mean()) if n else 0.0,
            "_miss": float((g > 0).float().mean()) if n else 0.0,
            "_agreed": float(g[agree].max()) if bool(agree.any()) else 0.0,
            "_experts_missed": float(missed.mean()) if n else 0.0,
            "_sets_differ": float((~agree).float().mean()) if n else 0.0}


@torch.no_grad()
def gaps(cfg: Dict, params: Dict, reqs: Sequence, device,
         control: bool = False, routes: Dict = None,
         route_margin: float = 0.0, positions: bool = False
         ) -> Dict[str, float]:
    """Over every served position of ``reqs``: ``program`` (the widest
    gap), ``program_mean`` (the mean gap), ``program_miss`` (the share of
    positions where the served token is not the reference's first
    choice), ``program_agreed`` (the widest gap over the positions where
    the program's expert sets, ``routes[rid][position]`` as
    ``routes.RouteLog.sets`` gives them, equal the reference's in every
    expert layer) and ``program_experts_missed`` (the share of the
    experts the program chose, over every position and expert layer,
    that the reference did not choose; 0 without experts),
    ``program_clear`` (the widest gap over the positions whose routing
    is clear: where the reference's k-th expert score leads its
    (k + 1)-th by ``route_margin`` or more in every expert layer, a rule
    on the reference alone; every position without experts),
    ``program_sets_differ`` (the share of positions where some layer's
    sets differ);
    ``tokens`` (positions compared), ``seconds`` (the reference's time),
    ``widest`` (the ten widest gaps, each with whether the sets differ
    there); with ``control`` the same of float8's first choices and
    float8's expert sets as ``control``, ``control_mean``, ...; with
    ``positions`` also ``positions``: per served position, the program's
    gap, the control's, the reference's margin and whether the
    program's sets agreed."""
    ref = reference(cfg)
    moe = bool(families.of(cfg).routed_experts(cfg))
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    sides = ("program", "control") if control else ("program",)
    got = {s: ([], [], []) for s in sides}
    margins = []
    try:
        for r in reqs:
            seq = _sequence(r, device)
            p = len(r.prompt)
            lo, hi = p - 1, len(seq)
            kw = {"routes": []} if moe else {}
            lg = ref.logits(cfg, params, seq, p, lo, "f32", **kw)
            best = lg.max(-1).values
            want = _sets(kw["routes"], lo, hi) if moe else None
            margins.append(_margins(kw["routes"], lo, hi) if moe
                           else torch.full((hi - lo,), float("inf")))
            mine = (routes or {}).get(r.rid, {})
            picks = {"program": (torch.as_tensor(
                np.asarray(r.output, np.int64), device=device),
                [mine.get(i) for i in range(lo, hi)] if moe else None)}
            if control:
                ckw = {"routes": []} if moe else {}
                picks["control"] = (ref.logits(cfg, params, seq, p, lo,
                                               "fp8", **ckw).argmax(-1),
                                    _sets(ckw["routes"], lo, hi)
                                    if moe else None)
            k = cfg.get("num_experts_per_tok", 1)
            for side, (pick, sets) in picks.items():
                cmp = ([_compare(a, b, k) for a, b in zip(sets, want)]
                       if moe else [(True, 0.0)] * (hi - lo))
                got[side][0].append((best - lg.gather(1, pick[:, None])[:, 0])
                                    .float().cpu())
                got[side][1].append(torch.tensor([c[0] for c in cmp]))
                got[side][2].append(torch.tensor([c[1] for c in cmp]))
            del lg
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    out = {"tokens": sum(len(r.output) for r in reqs),
           "seconds": time.perf_counter() - t0}
    margin = torch.cat(margins) if margins else torch.zeros(0)
    clear = margin >= route_margin
    out["clear_share"] = float(clear.float().mean()) if len(clear) else 0.0
    for side, (parts, agrees, missed) in got.items():
        g = torch.cat(parts) if parts else torch.zeros(0)
        agree = torch.cat(agrees) if agrees else torch.zeros(0, dtype=bool)
        missed = torch.cat(missed) if missed else torch.zeros(0)
        for suffix, v in _readings(g, agree, missed, clear).items():
            out[side + suffix] = v
        if side == "program":
            top = torch.argsort(g, descending=True)[:10].tolist()
            out["widest"] = [[float(g[i]), not bool(agree[i])] for i in top]
            prog = (g, agree)
    if positions:
        cg = torch.cat(got["control"][0]) if control else None
        out["positions"] = [
            [round(float(prog[0][i]), 5),
             round(float(cg[i]), 5) if cg is not None else None,
             float(margin[i]), bool(prog[1][i])] for i in range(len(margin))]
    return out


# a number the limits file may hold -> the reading it bounds from above
GAP_READINGS = {"logit_gap_max": "program", "logit_gap_mean": "program_mean",
                "expert_miss_share": "program_experts_missed",
                "logit_gap_max_clear": "program_clear"}


def judge(limits: Dict, readings: Dict[str, float],
          side: str = "program") -> Dict[str, Dict]:
    """Each number compared beside its limit, and whether it holds: no
    request failed, at least ``served_tokens`` compared, and each gap the
    cell's limits file bounds within its limit.  ``side="control"``
    judges the control's readings in the program's place."""
    checks = {
        "failed_requests": {"value": readings["failed"], "limit": 0,
                            "ok": readings["failed"] == 0},
        "tokens_compared": {"value": readings["tokens"],
                            "limit": limits["served_tokens"],
                            "ok": readings["tokens"]
                            >= limits["served_tokens"]},
    }
    for name, key in GAP_READINGS.items():
        if name in limits:
            v = readings[key.replace("program", side)]
            checks[name] = {"value": v, "limit": limits[name],
                            "ok": v <= limits[name]}
    return checks
