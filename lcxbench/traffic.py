"""The one traffic generator: a mix file of ``lcxbench/traffic/`` in, the
requests of a run out, the same from the same seed.

A mix states its loop (``"open"``: Poisson arrivals at ``rate_rps``;
``"closed"``: ``clients`` clients, each sending its next request when its
last one finished), ``n_slots`` (the engine's batch), and the prompt and
output lengths as ``{"dist": "loguniform", "min": a, "max": b}``.

Every seed gets the same set of sizes and arrivals, so the seed changes
which tokens, not how much work: the lengths are the distribution's
quantiles at ``(i + 0.5) / n`` and the gaps between arrivals the
exponential's.  An open run replays one schedule, the same for every
seed: its ``round(rate x seconds)`` requests are all due inside the
window, the gaps in an order drawn once from ``SCHEDULE_SEED`` (Poisson
arrivals, with their bursts and lulls) and scaled to fill it, each with
its prompt and output length drawn from the same stream; the run's seed
draws the prompts' tokens.  As MLPerf Inference's LoadGen fixes the
query schedule of its server scenario (``schedule_rng_seed``), so that a
run's tail is not a draw of which long prompts meet in one burst.  A
closed run deals its clients one such set of ``clients`` requests per
round, shuffled by the seed: a client's r-th request comes from round r.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List

import numpy as np


@dataclasses.dataclass
class Req:
    rid: int
    due: float              # seconds after the window opens
    prompt: np.ndarray      # int32 token ids
    out_len: int
    client: int = -1        # closed loop: the client that sends it
    round: int = 0


def quantile_lengths(spec: Dict, n: int) -> List[int]:
    """``n`` lengths at the quantiles ``(i + 0.5) / n`` of ``spec``."""
    if spec["dist"] != "loguniform":
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    lo, hi = math.log(spec["min"]), math.log(spec["max"])
    return [int(round(math.exp(lo + (i + 0.5) / n * (hi - lo))))
            for i in range(n)]


SCHEDULE_SEED = 0      # the open runs' one schedule


def _rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng([seed % 2 ** 64, *stream])


def max_seq(mix: Dict) -> int:
    """Cache rows a slot needs: the longest prompt and output, and one."""
    return mix["prompt"]["max"] + mix["output"]["max"] + 1


class Traffic:
    """The requests of one run of ``mix`` from ``seed`` over a window of
    ``seconds``, for a model of ``vocab`` tokens."""

    def __init__(self, mix: Dict, seed: int, seconds: float, vocab: int):
        self.mix, self.seed, self.seconds = mix, seed, seconds
        self.vocab = vocab
        self.loop = mix["loop"]
        if self.loop not in ("open", "closed"):
            raise ValueError(f"unknown loop {self.loop!r}")
        self._next_rid = 0

    def _request(self, due: float, plen: int, olen: int, tok_rng,
                 client: int = -1, rnd: int = 0) -> Req:
        rid = self._next_rid
        self._next_rid += 1
        prompt = tok_rng.integers(0, self.vocab, plen).astype(np.int32)
        return Req(rid, due, prompt, olen, client, rnd)

    def open_requests(self) -> List[Req]:
        """Every request of an open run, in order of due time."""
        rate = float(self.mix["rate_rps"])
        n = max(1, int(round(rate * self.seconds)))
        rng = _rng(SCHEDULE_SEED, 0)
        plens = rng.permutation(quantile_lengths(self.mix["prompt"], n))
        olens = rng.permutation(quantile_lengths(self.mix["output"], n))
        gaps = rng.permutation([-math.log(1.0 - (i + 0.5) / n)
                                for i in range(n)])
        due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
        due = due * (self.seconds / float(np.sum(gaps)))
        tok = _rng(self.seed, 1)
        return [self._request(float(due[i]), int(plens[i]), int(olens[i]),
                              tok) for i in range(n)]

    def closed_round(self, rnd: int) -> List[Req]:
        """Round ``rnd`` of a closed run: one request for each client, due
        when that client's previous one finished (set by the caller)."""
        c = int(self.mix["clients"])
        rng = _rng(self.seed, 2, rnd)
        plens = rng.permutation(quantile_lengths(self.mix["prompt"], c))
        olens = rng.permutation(quantile_lengths(self.mix["output"], c))
        tok = _rng(self.seed, 3, rnd)
        return [self._request(0.0, int(plens[i]), int(olens[i]), tok, i, rnd)
                for i in range(c)]
