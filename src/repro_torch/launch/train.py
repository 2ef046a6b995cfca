"""End-to-end training driver.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \
        --seq-len 1024 --batch 8 --steps 8
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \
        --smoke --device cpu --steps 20 --seq-len 64 --batch 4

Runs on the CUDA card by default; ``--device cpu`` runs on the CPU.
``--smoke`` takes the arch's reduced config, else the published one.
On one 80 GB H100 at seq 1024 x batch 8, qwen2-0.5b, mamba2-130m and
hubert-xlarge train at full width and depth.  The others fit only cut,
and this driver takes no cut (the reference's has none): ``chip_smoke.py``
trains them at full width with the cuts of its ``TRAIN_CUTS``:
qwen3-moe-30b-a3b at 4 of 48 layers, llava-next-mistral-7b at the depth
its memory probes pick (20 of 32 layers), and deepseek-v3-671b with its
MTP loss at its 3 dense layers and one MoE layer, 32 of 256 routed
experts.  Their CPU twins at smoke widths:
``PYTHONPATH=src python -m pytest -q tests/test_torch_train_cuts.py``.
The trainer wires checkpoint/restart, failure recovery and straggler
monitoring (see ``repro_torch.runtime``).
"""
import argparse
import json

from repro_torch.configs.base import get_config, get_smoke_config, list_archs
from repro_torch.runtime import FailureInjector, TrainConfig, Trainer


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", required=True,
                   help=f"one of {', '.join(list_archs())}")
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--seq-len", type=int, default=256)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--warmup", type=int, default=20)
    p.add_argument("--grad-accum", type=int, default=1)
    p.add_argument("--compressed-accum", action="store_true")
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--ckpt-every", type=int, default=50)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--inject-failure-at", type=int, action="append",
                   default=[])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args()

    cfg = get_smoke_config(args.arch) if args.smoke \
        else get_config(args.arch)
    tcfg = TrainConfig(
        lr=args.lr, warmup=args.warmup, total_steps=args.steps,
        seq_len=args.seq_len, global_batch=args.batch,
        grad_accum=args.grad_accum,
        compressed_accum=args.compressed_accum,
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        seed=args.seed,
    )
    injector = FailureInjector(fail_at=args.inject_failure_at) \
        if args.inject_failure_at else None
    trainer = Trainer(cfg, tcfg, device=args.device,
                      failure_injector=injector)
    if args.resume:
        restored = trainer.restore()
        print(f"resume: {'ok, step ' + str(trainer.step_count) if restored else 'no checkpoint found'}")
    result = trainer.run(args.steps)
    print(json.dumps(result, indent=2, default=str))
    for m in trainer.metrics_log:
        print(f"step {m['step']:5d} loss={m['loss']:.4f} "
              f"lr={m['lr']:.2e} dt={m['dt']*1e3:.0f}ms {m['straggler']}")


if __name__ == "__main__":
    main()
