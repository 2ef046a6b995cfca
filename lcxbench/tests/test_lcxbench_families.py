"""Families and kernel-bounds files: the decoder family draws and counts
what the harness drew and counted before families existed (digests and
values taken from that tree), the gmm and flash bounds are the same to
the bit, the decode-attention bound is a hand count; and two families
brought only from ``tests/fixtures/`` enter the harness: a Mamba-2 +
attention + MoE hybrid fits the program's layout and counts by kind, and
Qwen3-MoE (other key names, qk-norm, no shared expert) runs whole and
correct, and a planted fault fails it."""
import copy
import hashlib
import json
from pathlib import Path
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

from lcxbench import bench, counts, harness, kernels, model, readers  # noqa
from lcxbench import families, weights  # noqa: E402
from lcxbench.bench import Cell  # noqa: E402
from lcxbench.tests import smoke  # noqa: E402
from lcxbench.tracing import Profile, Tracer  # noqa: E402

FIXTURES = Path(__file__).resolve().parent / "fixtures"

# sha256 of every leaf's path, dtype and bytes at smoke size from seed
# 2**31 + 77, and counts at smoke and full size, from the tree before
# families (commit 2cebc74)
WEIGHTS = {
    ("deepseek-v3-5l", "float32"):
    "f5b12b54341c9fc23a5cb34bb1eefe981bcabcaa94027d9d931ceea81172c7fe",
    ("deepseek-v3-5l", "bfloat16"):
    "2bb385c41736f20163c5563e8ffdc1229dac56ec074a189a33e33d5ec70f6461",
    ("internlm2-20b", "float32"):
    "7fcaeb0acc655922768627c19788ca9b4beef4218fe523d9ba0472145e3d60d9",
    ("internlm2-20b", "bfloat16"):
    "ea113d03108c89e51c690dbbea7a4ccd99afb4041716743f22df6f4624e17939",
}
COUNTS = {
    ("deepseek-v3-5l", "smoke"): [143872, 305088, 513756352, 19890257920,
                                  6116352, 195005376],
    ("deepseek-v3-5l", "full"): [2921005056, 7695777792, 4664898043904,
                                 43627362910208, 32872071168,
                                 552269922304],
    ("internlm2-20b", "smoke"): [196608, 418560, 537683712, 16913817600,
                                 5591040, 166822656],
    ("internlm2-20b", "full"): [18723373056, 38585106432, 29453811056640,
                                252342679633920, 160356630528,
                                2608655892480],
}


def _digest(params) -> str:
    h = hashlib.sha256()
    for k, t in sorted(weights.flatten(params).items(),
                       key=lambda kv: str(kv[0])):
        h.update(repr(k).encode())
        h.update(str(t.dtype).encode())
        h.update(t.contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _config_file(name):
    return bench.load_json(bench.HERE / "configs" / f"{name}.json")


@pytest.mark.parametrize("name,dtype", sorted(WEIGHTS))
def test_decoder_weights_match_the_parent_digests(name, dtype):
    cfg = smoke.config(name)
    assert "family" not in cfg and families.of(cfg).__name__.endswith(
        ".decoder")
    params = weights.draw(cfg, 2 ** 31 + 77, "cpu", getattr(torch, dtype))
    assert _digest(params) == WEIGHTS[(name, dtype)]


@pytest.mark.parametrize("name,size", sorted(COUNTS))
def test_decoder_counts_match_the_parent(name, size):
    from lcxbench.families import decoder
    cfg = smoke.config(name) if size == "smoke" else _config_file(name)
    assert [decoder.body_params(cfg), counts.prefill_flops(cfg, 1),
            counts.prefill_flops(cfg, 777), counts.prefill_flops(cfg, 6144),
            counts.decode_flops(cfg, [0, 5, 1000, 4095]),
            counts.decode_flops(cfg, list(range(0, 6000, 97)))] \
        == COUNTS[(name, size)]


def test_gmm_bounds_match_the_parent_to_the_bit():
    cfg = _config_file("deepseek-v3-5l")
    ids = torch.tensor([[0, 1], [1, 2], [0, 1], [3, 1], [5, 7], [2, 2]])
    a = torch.arange(512).reshape(64, 8)
    recs = [("route", ids),
            ("moe_gmm", (256, 8, 7168), (256, 7168, 2048)),
            ("moe_gmm", (256, 8, 2048), (256, 2048, 7168)),
            ("route", (a * 37 + a // 9) % 256),
            ("moe_gmm", (256, 24, 7168), (256, 7168, 2048)),
            ("moe_gmm", (256, 2, 2048), (256, 2048, 7168))]
    assert readers.launch_bounds(cfg, recs, "moe_gmm") == [
        5.265132895522388e-05, 5.265132895522388e-05,
        0.0022464567020895523, 0.0022460660537313433]


def test_flash_bounds_match_the_parent_to_the_bit():
    recs = [("flash_attention", (1, 777, 48, 128), (1, 777, 8, 128), True),
            ("flash_attention", (2, 6144, 48, 128), (2, 6144, 8, 128), True),
            ("flash_attention", (1, 100, 48, 128), (1, 300, 8, 128), False),
            ("flash_attention", (3, 500, 32, 64), (3, 200, 4, 64), True)]
    assert readers.launch_bounds({}, recs, "flash_attention") == [
        7.510788400404449e-06, 0.0009381839543781597,
        1.1004179104477611e-06, 3.851462686567164e-06]


def _decode_record(b=32, smax=1185, hkv=8, g=6, hd=128, lengths=None,
                   window=None):
    from lcxbench.kernels import decode_attention as da
    q = torch.zeros(b, 1, hkv * g, hd, dtype=torch.bfloat16)
    kc = torch.zeros(b, smax, hkv, hd, dtype=torch.bfloat16)
    args = (q, None, None, None, None, kc, kc, lengths)
    return ("decode_attention", *da.record(args, {"scale": 0.1, "window": window}))


def test_decode_attention_bound_is_a_hand_count():
    """InternLM2-20B's chat shape: 32 slots of a 1,185-row cache, 48 query
    heads on 8 KV heads of 128; four free slots (one row each) and 28 at
    lengths 0-1184, the last clamped to the cache's last row."""
    lens = [0] * 4 + [37 * i for i in range(28)]
    lens[-1] = 1300
    lengths = torch.tensor(lens, dtype=torch.int32)
    rec = _decode_record(lengths=lengths)
    rows = 4 + sum(min(n, 1184) + 1 for n in lens[4:])
    assert rows == 4 + sum(37 * i + 1 for i in range(27)) + 1185
    flops = 4 * 48 * 128 * rows
    nbytes = (8 * 128 * rows * 2 * 2      # the valid rows of K and V
              + 32 * 48 * 128 * 2 * 2     # q read, the output written
              + 32 * 8 * 128 * 2 * 4      # k_new, v_new read, two rows
              + 32 * 64 * 4 * 2           # cos and sin, float32
              + 32 * 4)                   # the lengths
    got = readers.launch_bounds({}, [rec], "decode_attention")
    assert got == [max(flops / 989e12, nbytes / 3.35e12)]
    assert got[0] == nbytes / 3.35e12          # bound by the bytes
    # the engine's own lengths change after the step: the record copies
    # a CPU tensor, so a later write does not move the bound
    lengths[4:] = 0
    assert readers.launch_bounds({}, [rec], "decode_attention") == got


def test_decode_attention_window_keeps_its_rows():
    lengths = torch.tensor([0, 10, 5000], dtype=torch.int32)
    rec = _decode_record(b=3, smax=6000, lengths=lengths, window=4096)
    from lcxbench.kernels.decode_attention import valid_rows
    assert valid_rows(lengths, 6000, 4096) == 1 + 11 + 4096
    fl, nb = counts.decode_attention_work(3, 48, 8, 128, 1 + 11 + 4096)
    assert readers.launch_bounds({}, [rec], "decode_attention") == [
        counts.bound_s(fl, nb)]


def test_decode_roofline_pairs_calls_and_kernels_from_the_end():
    """Three recorded calls, two decode kernels left in the profile (the
    profiler lost the first): the last two bounds over their two times."""
    lengths = torch.tensor([100] * 32, dtype=torch.int32)
    recs = [_decode_record(lengths=lengths) for _ in range(3)]
    bound = readers.launch_bounds({}, recs[:1], "decode_attention")[0]
    kern = [("void decode_attn_kernel<128>", 0.0, 50.0),
            ("gemm", 50.0, 60.0),
            ("void decode_attn_kernel<128>", 60.0, 110.0)]
    run = SimpleNamespace(cfg={}, profile=Profile(200.0, kern, [], recs))
    want = 100.0 * 2 * bound / 100e-6
    assert readers.reader("kernel.decode_roofline")(run) == pytest.approx(
        want, rel=1e-12)
    assert 0 < want < 100


def test_every_hook_of_the_program_has_a_bounds_file():
    from repro_torch.kernels import model_kernels
    pc = model.port_config(_config_file("internlm2-20b"))
    hooks = set(model_kernels(pc))
    assert hooks == {"flash_attention", "ssd_scan", "moe_gmm",
                     "decode_attention"}
    for hook in hooks:
        f = kernels.for_hook(hook)
        assert f is not None and f.marks and callable(f.bound_s), hook
    assert {p.stem for p in kernels.HERE.glob("*.py")} == hooks | {
        "__init__"}


def test_tracer_records_every_hook_that_has_a_bounds_file():
    seen = []
    hooks = {"moe_gmm": lambda xb, w: seen.append("gmm"),
             "mystery": lambda x: seen.append("mystery")}
    eng = SimpleNamespace(tick=lambda: None, _admit_one=lambda r: None,
                          _decode_tick=lambda: None,
                          device=torch.device("cpu"))
    tr = Tracer(eng, hooks, 0.0, 1).install()
    try:
        tr.recording = True
        hooks["moe_gmm"](torch.zeros(4, 2, 8), torch.zeros(4, 8, 3))
        hooks["mystery"](1)
    finally:
        tr.uninstall()
    assert seen == ["gmm", "mystery"]
    assert tr.launches == [("moe_gmm", (4, 2, 8), (4, 8, 3))]


def test_ssd_bound_counts_shared_groups_once():
    from lcxbench.kernels import ssd_scan as sb
    x = torch.zeros(1, 512, 24, 64, dtype=torch.bfloat16)
    shared = torch.zeros(1, 512, 1, 128).expand(1, 512, 24, 128)
    rec = ("ssd_scan", *sb.record((x, None, None, shared, shared), {}))
    fl, nb = counts.ssd_work(1, 512, 24, 64, 128, 1, sb.CHUNK)
    assert readers.launch_bounds({}, [rec], "ssd_scan") == [counts.bound_s(fl, nb)]
    # three kernels a call: one call's bound over its three kernels
    kern = [("ssd_state_mma<128>", 0.0, 5.0), ("ssd_pass_kernel", 5.0, 7.0),
            ("ssd_out_mma<128>", 7.0, 17.0)]
    run = SimpleNamespace(cfg={}, profile=Profile(20.0, kern, [], [rec]))
    assert readers.kernel_roofline(run, "ssd_scan") == pytest.approx(
        100.0 * counts.bound_s(fl, nb) / 17e-6)


# -- the fixtures: families brought from tests/fixtures/ only -------------
def _fixture(name):
    return json.loads((FIXTURES / f"{name}.json").read_text())


def test_hybrid_family_fits_the_program_layout():
    cfg = _fixture("hybrid")
    pc = model.port_config(cfg)
    assert pc.family == "hybrid" and pc.n_experts == 4 \
        and pc.ssm_groups == 2 and pc.moe_d_ff == 160
    model.check_kinds(cfg, pc)
    params = weights.draw(cfg, 11, "cpu", pc.param_dtype)
    model.check_layout(pc, params)
    assert params["stack"][0]["l0"]["mixer"]["A_log"].dtype == torch.float32
    kinds = families.of(cfg).layer_kinds(cfg)
    assert [m for m, _ in kinds].count("attn") == 1 \
        and [f for _, f in kinds].count("moe") == 4


def test_hybrid_counts_sum_per_kind():
    """A prefill of n tokens: one GQA layer, seven Mamba-2 layers, four
    expert and four dense FFNs, and the head, each counted by hand."""
    cfg = _fixture("hybrid")
    d, h, hkv, hd, v, f, e, k = 64, 4, 2, 16, 128, 160, 4, 2
    di, g, n_st, heads, conv, p = 128, 2, 16, 8, 4, 16
    attn = 2 * (d * h * hd + 2 * d * hkv * hd + h * hd * d)
    mamba = (2 * (d * (2 * di + 2 * g * n_st + heads) + di * d)
             + 4 * heads * n_st * p + 2 * conv * (di + 2 * g * n_st))
    dense_ffn, moe_ffn = 2 * 3 * d * f, 2 * (d * e + k * 3 * d * f)
    token = attn + 7 * mamba + 4 * dense_ffn + 4 * moe_ffn
    for n in (1, 5, 300):
        want = token * n + 4 * h * hd * n * (n + 1) // 2 + 2 * d * v
        assert counts.prefill_flops(cfg, n) == want
    assert counts.decode_flops(cfg, [3, 0]) == (
        2 * (token + 2 * d * v) + 4 * h * hd * (4 + 1))


def _qwen3_cell(**mix):
    b = bench.load_json(bench.ROOT / "BENCHMARK.json")
    return Cell(name="qwen3-smoke", chips=1, cfg=_fixture("qwen3_moe"),
                mix=smoke.mix("closed", **mix),
                limits={"served_tokens": 8, "route_margin": 0.01,
                        "logit_gap_max_clear": 1e-3,
                        "logit_gap_mean": 2.5e-4,
                        "expert_miss_share": 0.05},
                end_to_end=copy.deepcopy(b["end_to_end"]),
                per_layer=[])


def _qwen3_run(cell):
    clock = smoke.StepClock()
    return harness.run(cell, 7, 0.3, False, "cpu", 0.0, clock=clock,
                       sleep=clock.sleep)


def test_qwen3_moe_family_runs_whole_and_correct():
    cell = _qwen3_cell()
    pc = model.port_config(cell.cfg)
    assert pc.qk_norm and pc.n_experts == 8 and pc.n_shared_experts == 0 \
        and pc.moe_d_ff == 48 and pc.n_layers == 2
    res, lines = _qwen3_run(cell)
    assert res["correct"] is True, lines
    assert res["attempted"] > 0 and res["failed"] == 0
    assert res["checks"]["expert_miss_share"]["value"] == 0.0, lines
    assert res["checks"]["tokens_compared"]["value"] >= 8


@pytest.mark.parametrize("fault", ["token altered", "experts altered"])
def test_qwen3_moe_planted_fault_is_not_correct(monkeypatch, fault):
    from repro_torch.serving import engine as eng
    if fault == "token altered":
        sample = eng.sample_token
        monkeypatch.setattr(eng, "sample_token", lambda lg, t, g: (
            sample(lg, t, g) + 1) % lg.shape[-1])
    else:
        from repro_torch.models import moe
        route = moe.route

        def shifted(cfg, router_p, x):
            ids, w, aux = route(cfg, router_p, x)
            return (ids + 1) % cfg.n_experts, w, aux
        monkeypatch.setattr(moe, "route", shifted)
    res, lines = _qwen3_run(_qwen3_cell())
    assert res["correct"] is False, lines


def test_a_family_setting_the_program_does_not_compute_is_refused():
    cfg = _fixture("qwen3_moe")
    cfg["use_sliding_window"] = True
    with pytest.raises(ValueError, match="use_sliding_window"):
        model.port_config(cfg)
    cfg["departures"] = {"use_sliding_window": "no window: the program "
                         "attends to every key"}
    assert model.port_config(cfg).sliding_window is None


def test_layer_kinds_that_are_not_the_programs_plan_are_refused():
    cfg = _fixture("hybrid")
    pc = model.port_config(cfg)
    cfg["attn_layer_offset"] = 3
    with pytest.raises(ValueError, match="layer kinds"):
        model.check_kinds(cfg, pc)
