"""End-to-end training driver on the PyTorch port: a smoke-size
qwen2-style LM trained for a few hundred steps with the production
substrate: a mesh over the CUDA devices there are (none on one card),
microbatched gradient accumulation, checkpointing, an injected node
failure (recovered from the last checkpoint), and straggler monitoring.

Run:  PYTHONPATH=src python examples/torch_train_lm.py [--device cpu]
      [--steps 300]

The port of ``examples/train_lm.py``, on the card by default.
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch  # noqa: E402

from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.runtime import (FailureInjector, TrainConfig,  # noqa: E402
                                 Trainer)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--d-model", type=int, default=128)
    p.add_argument("--layers", type=int, default=4)
    args = p.parse_args()
    dev = resolve_device(args.device)

    # ~100M-class config scaled down: same family as qwen2
    cfg = ModelConfig(
        name="qwen2-mini", family="dense",
        n_layers=args.layers, d_model=args.d_model, n_heads=8,
        n_kv_heads=2, d_ff=4 * args.d_model, vocab=2048,
        qkv_bias=True, tie_embeddings=True,
        dtype=torch.float32, param_dtype=torch.float32, remat="none",
        q_block=64,
    )
    with tempfile.TemporaryDirectory() as ckpt_dir:
        tcfg = TrainConfig(
            lr=1e-3, warmup=30, total_steps=args.steps,
            seq_len=128, global_batch=16, grad_accum=2,
            ckpt_dir=ckpt_dir, ckpt_every=50, log_every=20,
        )
        injector = FailureInjector(fail_at=[args.steps // 2])
        mesh = make_host_mesh() if dev.type == "cuda" else None
        trainer = Trainer(cfg, tcfg, mesh=mesh, device=dev,
                          failure_injector=injector)
        out = trainer.run(args.steps)
        print(f"\nfinal step {out['final_step']}, "
              f"{out['failures']} failure(s) recovered on {dev}")
        first = trainer.metrics_log[0]
        last = trainer.metrics_log[-1]
        print(f"loss: {first['loss']:.3f} -> {last['loss']:.3f}")
        for m in trainer.metrics_log:
            print(f"  step {m['step']:4d}  loss={m['loss']:.4f}  "
                  f"lr={m['lr']:.2e}  {m['dt']*1e3:6.0f}ms  "
                  f"{m['straggler']}")
        assert out["final_step"] == args.steps and out["failures"] == 1, \
            "the injected failure was not recovered"
        assert last["loss"] < first["loss"], "training did not learn"
        print("train_lm OK")


if __name__ == "__main__":
    main()
