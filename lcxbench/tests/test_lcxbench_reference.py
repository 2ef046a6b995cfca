"""Each plain reference against the program at its smoke size, on the same
float32 weights: the prefill's last logits and four decode steps."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lcxbench import check, model, weights  # noqa: E402
from lcxbench.tests import smoke  # noqa: E402


@pytest.mark.parametrize("name", ["deepseek-v3-5l", "internlm2-20b"])
def test_reference_matches_program_prefill_and_decode(name):
    from repro_torch.models import decode_step, init_cache, prefill
    cfg = smoke.config(name)
    pc = model.port_config(cfg)
    params = weights.draw(cfg, 5, "cpu", torch.float32)
    model.check_layout(pc, params)
    rng = np.random.default_rng(0)
    p, steps = 24, 4
    toks = rng.integers(0, cfg["vocab_size"], p + steps)
    cache = init_cache(pc, 1, 64, device="cpu")
    lg, _ = prefill(pc, params, torch.as_tensor(toks[None, :p]), cache)
    got = [lg[0, -1]]
    for i in range(steps):
        lg, _ = decode_step(pc, params, torch.as_tensor(toks[None, p + i:
                                                             p + i + 1]),
                            cache, p + i)
        got.append(lg[0, -1])
    ref = check.reference(cfg).logits(cfg, params, torch.as_tensor(toks),
                                      p, p - 1)
    torch.testing.assert_close(torch.stack(got), ref, rtol=1e-4, atol=1e-4)


def test_moe_reference_drops_past_capacity_like_the_program():
    """At capacity factor 1.0 a 24-token prompt overfills some of 8
    experts: both sides drop the same assignments (dropping none would
    differ)."""
    from repro_torch.models import init_cache, prefill
    cfg = smoke.config("deepseek-v3-5l")
    ref = check.reference(cfg)
    params = weights.draw(cfg, 9, "cpu", torch.float32)
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg["vocab_size"], 24))
    pc = model.port_config(cfg)
    lg, _ = prefill(pc, params, toks[None], init_cache(pc, 1, 32,
                                                        device="cpu"))
    dropped = ref.logits(cfg, params, toks, 24, 23)
    kept = ref.logits(cfg, params, toks, 0, 23)
    torch.testing.assert_close(lg[0], dropped, rtol=1e-4, atol=1e-4)
    assert (kept - dropped).abs().max() > 1e-3
