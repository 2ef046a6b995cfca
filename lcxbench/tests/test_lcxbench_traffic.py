"""The traffic generator: the same requests from the same seed, the
stated length ranges, and the same sizes for every seed."""
import math

import numpy as np
import pytest

from lcxbench.traffic import Traffic, quantile_lengths
from lcxbench.tests import smoke

OPEN = smoke.mix("open", rate_rps=20.0,
                 prompt={"dist": "loguniform", "min": 128, "max": 1024},
                 output={"dist": "loguniform", "min": 64, "max": 512})


def _key(reqs):
    return [(r.rid, r.due, r.prompt.tolist(), r.out_len) for r in reqs]


def test_same_seed_same_schedule():
    a = Traffic(OPEN, 2 ** 31 + 5, 3.0, 1000).open_requests()
    b = Traffic(OPEN, 2 ** 31 + 5, 3.0, 1000).open_requests()
    assert _key(a) == _key(b)
    c = Traffic(OPEN, 2 ** 31 + 6, 3.0, 1000).open_requests()
    assert _key(a) != _key(c)


def test_open_lengths_in_range_and_every_seed_the_same_sizes():
    sizes = None
    for seed in (1, 2, 3):
        reqs = Traffic(OPEN, seed, 3.0, 1000).open_requests()
        assert len(reqs) == 60
        assert all(128 <= len(r.prompt) <= 1024 for r in reqs)
        assert all(64 <= r.out_len <= 512 for r in reqs)
        assert all(0 <= r.prompt.min() and r.prompt.max() < 1000
                   for r in reqs)
        due = [r.due for r in reqs]
        assert due == sorted(due) and due[0] == 0.0 and due[-1] < 3.0
        s = (sorted(len(r.prompt) for r in reqs),
             sorted(r.out_len for r in reqs),
             sorted(np.round(np.diff(due + [3.0]), 9)))
        assert sizes is None or s == sizes
        sizes = s


def test_closed_rounds_deal_one_set_per_round():
    mix = smoke.mix("closed", clients=8)
    t = Traffic(mix, 11, 1.0, 50)
    r0, r1 = t.closed_round(0), t.closed_round(1)
    assert [r.client for r in r0] == list(range(8))
    assert sorted(len(r.prompt) for r in r0) == sorted(
        len(r.prompt) for r in r1) == sorted(quantile_lengths(
            mix["prompt"], 8))
    assert _key(r0) != _key(r1)
    assert _key(Traffic(mix, 11, 1.0, 50).closed_round(0)) == _key(r0)


def test_quantile_lengths_span_the_range():
    v = quantile_lengths({"dist": "loguniform", "min": 2048, "max": 8192},
                         100)
    assert v == sorted(v) and 2048 <= v[0] and v[-1] <= 8192
    with pytest.raises(ValueError):
        quantile_lengths({"dist": "zipf", "min": 1, "max": 2}, 3)


def test_open_runs_replay_one_schedule_for_every_seed():
    """163 requests (dsv3-chat's 3.2 req/s over 51 s): every seed gets the
    same due times, prompt lengths and answers, drawn from
    ``SCHEDULE_SEED``, and its own tokens; the gaps between arrivals are
    the exponential set in an order that bunches some (Poisson)."""
    from lcxbench.traffic import SCHEDULE_SEED, _rng
    mix = smoke.mix("open", rate_rps=3.2,
                    prompt={"dist": "loguniform", "min": 256, "max": 4096})
    runs = [Traffic(mix, seed, 51.0, 1000).open_requests()
            for seed in (1, 2 ** 33 + 7)]
    sched = [[(r.due, len(r.prompt), r.out_len) for r in reqs]
             for reqs in runs]
    assert sched[0] == sched[1]
    assert [len(r.prompt) for r in runs[0]] == _rng(
        SCHEDULE_SEED, 0).permutation(
            quantile_lengths(mix["prompt"], 163)).tolist()
    assert any(a.prompt.tolist() != b.prompt.tolist()
               for a, b in zip(*runs))
    gaps = np.diff([r.due for r in runs[0]])
    full = [-math.log(1.0 - (i + 0.5) / 163) for i in range(163)]
    full = np.sort(full) * (51.0 / sum(full))
    at = np.clip(np.searchsorted(full, gaps), 1, 162)
    near = np.where(full[at] - gaps < gaps - full[at - 1], at, at - 1)
    np.testing.assert_allclose(full[near], gaps, rtol=0, atol=1e-9)
    assert len(set(near.tolist())) == 162      # all but one, none twice
    # bursts: some second of the window holds twice the mean arrivals
    per_s = np.bincount(np.floor([r.due for r in runs[0]]).astype(int))
    assert per_s.max() >= 2 * 3.2
