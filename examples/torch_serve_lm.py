"""Serving example on the PyTorch port: continuous batching over a hybrid
(Mamba + attention) model, with prefill into slots, per-tick batched
decode, slot recycling, and a greedy-consistency check against the full
forward pass.

Run:  PYTHONPATH=src python examples/torch_serve_lm.py [--device cpu]
      [--requests 10]

The port of ``examples/serve_lm.py``: the same jamba-mini config (the
sort MoE), random weights drawn from a seed on the device (the card by
default), and the engine built with no kernels, as the reference's.
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.models import apply_model, init_model  # noqa: E402
from repro_torch.serving import (Request, ServeConfig,  # noqa: E402
                                 ServingEngine)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    p.add_argument("--requests", type=int, default=10)
    args = p.parse_args()
    dev = resolve_device(args.device)

    cfg = ModelConfig(
        name="jamba-mini", family="hybrid",
        n_layers=8, d_model=128, n_heads=8, n_kv_heads=2, d_ff=256,
        vocab=1024, attn_layer_period=4, attn_layer_offset=1,
        n_experts=4, n_experts_per_tok=2, moe_d_ff=128,
        expert_layer_period=2, expert_layer_offset=1,
        moe_backend="sort", capacity_factor=4.0,
        ssm_state=16, ssm_head_dim=16, ssm_chunk=16,
        dtype=torch.float32, param_dtype=torch.float32, q_block=32,
    )
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_model(gen, cfg, device=dev)
    eng = ServingEngine(cfg, params, ServeConfig(
        n_slots=4, max_seq=128, max_new_tokens=16), device=dev)

    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    for rid in range(args.requests):
        plen = int(rng.integers(4, 16))
        eng.submit(Request(
            rid=rid,
            prompt=rng.integers(0, cfg.vocab, plen).astype(np.int32)))
    done = eng.run_until_drained()
    dt = time.perf_counter() - t0

    tok = sum(len(r.output) for r in done)
    print(f"served {len(done)} requests / {tok} tokens in {dt:.1f}s "
          f"({tok/dt:.1f} tok/s) on {dev}  stats={eng.stats}")

    # consistency: engine output == token-by-token full forward (greedy)
    r = done[0]
    toks = list(r.prompt)
    with torch.no_grad():
        for _ in range(len(r.output)):
            lg, _ = apply_model(cfg, params, torch.tensor(
                [toks], dtype=torch.int32, device=dev))
            toks.append(int(lg[0, -1].argmax()))
    assert toks[len(r.prompt):] == r.output, "engine diverged from model"
    print("greedy consistency OK")
    for r in done[:3]:
        print(f"  rid={r.rid}: {r.prompt[:5].tolist()}... -> {r.output[:8]}")
    print("serve_lm OK")


if __name__ == "__main__":
    main()
