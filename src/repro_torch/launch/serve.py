"""Serving driver: continuous-batching engine over a model of the port.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \
        --requests 16 --max-new 24
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-130m \
        --full
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch qwen3-moe-30b-a3b --full

Runs on the CUDA card by default, with the port's kernels; ``--device
cpu`` runs the smoke config's plain path on the CPU.  ``--full`` takes
the published config, else the smoke config.  Encoder-only (audio)
architectures are refused: they have no decode path.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs.base import get_config, get_smoke_config, list_archs
from repro_torch.device import resolve_device
from repro_torch.kernels import model_kernels
from repro_torch.models import init_model
from repro_torch.serving import Request, ServeConfig, ServingEngine


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", required=True,
                   help=f"one of {', '.join(list_archs())}")
    p.add_argument("--full", action="store_true",
                   help="full config (one card holds qwen2-0.5b, "
                   "mamba2-130m, qwen3-moe-30b-a3b, internlm2-20b, "
                   "starcoder2-7b and llava-next-mistral-7b; "
                   "deepseek-v3-671b, command-r-plus-104b and "
                   "jamba-1.5-large-398b do not fit one)")
    p.add_argument("--requests", type=int, default=8)
    p.add_argument("--slots", type=int, default=4)
    p.add_argument("--max-seq", type=int, default=256)
    p.add_argument("--max-new", type=int, default=16)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args()

    cfg = get_config(args.arch) if args.full else get_smoke_config(args.arch)
    if cfg.family == "audio":
        raise SystemExit("encoder-only architectures have no decode path")
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = init_model(gen, cfg, device=dev)
    eng = ServingEngine(cfg, params, ServeConfig(
        n_slots=args.slots, max_seq=args.max_seq,
        max_new_tokens=args.max_new, temperature=args.temperature,
        seed=args.seed), kernels=model_kernels(cfg), device=dev)
    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    for i in range(args.requests):
        plen = int(rng.integers(4, 12))
        eng.submit(Request(rid=i, prompt=rng.integers(
            0, cfg.vocab, size=plen).astype(np.int32)))
    done = eng.run_until_drained()
    dt = time.perf_counter() - t0
    total_tokens = sum(len(r.output) for r in done)
    print(f"served {len(done)} requests, {total_tokens} tokens in "
          f"{dt:.2f}s ({total_tokens/dt:.1f} tok/s) on {dev}; "
          f"stats={eng.stats}")
    for r in done[:4]:
        print(f"  rid={r.rid} prompt={r.prompt[:6].tolist()}... "
              f"output={r.output}")


if __name__ == "__main__":
    main()
