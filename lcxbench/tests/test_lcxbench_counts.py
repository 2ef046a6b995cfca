"""The yardstick's operation and byte counts against counts by hand."""
import pytest

torch = pytest.importorskip("torch")

from lcxbench import counts, readers  # noqa: E402
from lcxbench.families import decoder  # noqa: E402
from lcxbench.tests import smoke  # noqa: E402


def test_flash_counts_causal_pairs_once():
    # 4 x 4 causal keeps 1 + 2 + 3 + 4 = 10 pairs
    assert counts.flash_work(2, 1, 4, 4, 8, True) == (
        4 * 2 * 8 * 10, (2 * 2 * 4 * 8 + 2 * 1 * 4 * 8) * 2)
    assert counts.flash_work(2, 1, 4, 4, 8, False)[0] == 4 * 2 * 8 * 16


def test_gmm_counts_rows_and_chosen_experts():
    assert counts.gmm_work(5, 3, 4, 6) == (2 * 5 * 4 * 6,
                                           (3 * 24 + 5 * 4 + 5 * 6) * 2)


def test_gmm_bounds_read_chosen_experts_and_capacity():
    """Rows [[0, 1], [1, 2], [0, 1]] over 4 experts: experts 0-2 chosen
    (2, 3, 1 rows); a capacity of 2 keeps 2 + 2 + 1 of them."""
    cfg = smoke.config("deepseek-v3-5l")
    ids = torch.tensor([[0, 1], [1, 2], [0, 1]])
    recs = [("route", ids), ("moe_gmm", (4, 8, 64), (4, 64, 32), True),
            ("moe_gmm", (4, 2, 64), (4, 64, 32), True)]
    got = readers.launch_bounds(cfg, recs, "moe_gmm")
    assert got == [counts.bound_s(*counts.gmm_work(6, 3, 64, 32)),
                   counts.bound_s(*counts.gmm_work(5, 3, 64, 32))]


def test_flash_bounds_scale_with_batch():
    recs = [("flash_attention", (2, 16, 4, 8), (2, 16, 2, 8), True)]
    fl, nb = counts.flash_work(4, 2, 16, 16, 8, True)
    assert readers.launch_bounds({}, recs, "flash_attention") == [
        counts.bound_s(2 * fl, 2 * nb)]


def test_dense_model_counts():
    cfg = smoke.config("internlm2-20b")
    d, h, hkv, f, v, n = 96, 6, 2, 256, 128, 2
    hd = d // h
    body = n * (d * h * hd + 2 * d * hkv * hd + h * hd * d + 3 * d * f)
    assert decoder.body_params(cfg) == body
    per_key = 4 * h * hd
    assert counts.prefill_flops(cfg, 5) == (2 * body * 5 + per_key * n * 15
                                            + 2 * d * v)
    assert counts.decode_flops(cfg, [3, 0]) == (
        2 * (2 * body + 2 * d * v) + per_key * n * (4 + 1))


def test_mla_moe_model_counts():
    cfg = smoke.config("deepseek-v3-5l")
    d, h, ql, kl, nope, rope, vd = 64, 4, 32, 16, 16, 8, 16
    mla = (d * ql + ql * h * (nope + rope) + d * (kl + rope) + kl * h * nope
           + kl * h * vd + h * vd * d)
    dense = 3 * d * 160
    moe = d * 8 + (2 + 1) * 3 * d * 64
    assert decoder.body_params(cfg) == 3 * mla + 1 * dense + 2 * moe
    assert decoder.attn_flops_per_key(cfg) == 2 * h * (nope + rope + vd)


def test_peaks_are_the_datasheet_values():
    assert counts.PEAK_FLOPS_BF16 == 989e12
    assert counts.PEAK_BYTES_PER_S == 3.35e12
