"""The traffic generator: the same requests from the same seed, the
stated length ranges, and the same sizes for every seed."""
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
