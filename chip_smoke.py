#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA Hopper card.

    python3 chip_smoke.py

Phases, in order; the first that fails raises and the script exits
non-zero:

1. device: CUDA with compute capability (9, 0), the card's name and
   power limit as ``nvidia-smi`` reports them;
2. build: every CUDA source of the port, one ``nvcc`` each, in parallel;
3. kernel check: each kernel against its plain PyTorch version on the
   card, at the serving shapes and a few others, then timed beside its
   plain version and one PyTorch library call;
4. serve: ``qwen2-0.5b`` at full width in bf16 (random weights from seed
   0) answers 16 requests through ``ServingEngine`` (LCX runtime + AMT
   executor) with the port's kernels; every kernel must have launched.
   Then a prefill and four decode ticks run under ``torch.profiler``,
   which reports the device's busy share and the kernels that take its
   time;
5. greedy consistency: at full width in float32, the engine's greedy
   tokens equal token-by-token ``apply_model`` with the same kernels.

Output: one line per check, then a ``{"kernels": [...]}`` JSON line, the
card's name and power limit, and as the last line
``{"ok": true, "device": {...}}``.  It imports nothing of JAX: the
reference package is not used here.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

SERVE_SLOTS, SERVE_MAX_SEQ, SERVE_NEW, SERVE_REQUESTS = 8, 1024, 32, 16
CHECK_SEQS = (1, 7, 100, 512, 1024)
# kernel vs plain version (atol, rtol): the two sum in another order, and
# in bf16 each rounds p and the output, so they may land one bf16 step
# (2^-8 relative) apart; the f32 bound is tests/test_kernels.py's
TOL = {"bfloat16": (2e-2, 1e-2), "float32": (2e-5, 1e-5)}


def log(*a) -> None:
    print(*a, flush=True)


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def require(ok: bool, what: str) -> None:
    """A check of the run that holds under ``python -O`` too."""
    if not ok:
        raise AssertionError(what)


def is_prime(n: int) -> bool:
    return n > 1 and all(n % d for d in range(2, int(n ** 0.5) + 1))


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean time per call between CUDA events around ``reps`` calls in a
    row: device time, plus the gaps where the host launches slower than
    the card runs."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def trace(fn):
    """Run ``fn`` once under torch.profiler: (wall ms, the card's kernel
    events)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    return wall, [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]


def device_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time per call: the card's kernel time over ``reps``
    calls, without the host's launch gaps."""
    for _ in range(warmup):
        fn()
    _, kern = trace(lambda: [fn() for _ in range(reps)])
    return sum(e.self_device_time_total for e in kern) / 1e3 / reps


def flash_bound_ms(hq, hkv, sq, sk, d, causal, dtype_name) -> tuple:
    """(operations ms, bytes ms) for the flash forward on these inputs:
    the two products over the pairs the mask keeps against the
    tensor-core rate; q, k, v read once and o written once against the
    memory rate.  The least time is the larger of the two."""
    esz = 2 if dtype_name == "bfloat16" else 4
    nbytes = (2 * hq * sq * d + 2 * hkv * sk * d) * esz
    if causal:   # top-left aligned: row i keeps keys 0..min(i, sk-1)
        pairs = sum(min(i + 1, sk) for i in range(sq))
    else:
        pairs = sq * sk
    flops = 4 * hq * d * pairs
    return (flops / PEAK_FLOPS[dtype_name] * 1e3,
            nbytes / PEAK_BYTES_PER_S * 1e3)


# ---------------------------------------------------------------------------
def phase_device():
    import torch
    from repro_torch.device import on_hopper
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    if not on_hopper():
        raise SystemExit(f"chip_smoke: needs a Hopper card (9, 0), found "
                         f"{torch.cuda.get_device_capability(0)}")
    log("python", sys.version.split()[0], "torch", torch.__version__,
        "cuda", torch.version.cuda)
    log("card:", smi())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def phase_build():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    libs = build.build()
    log(f"build: {len(libs)} libraries in "
        f"{time.perf_counter() - t0:.2f} s")


def _qkv(gen, b, hq, hkv, sq, sk, dk, dv, dtype):
    import torch
    mk = lambda *s: torch.randn(s, generator=gen, device="cuda").to(dtype)
    return mk(b, hq, sq, dk), mk(b, hkv, sk, dk), mk(b, hkv, sk, dv)


def phase_kernel_check(serve_lens):
    """Returns the flash kernel's row of the kernels line (without the
    launch count, which comes from the serve phase)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [(1, 14, 2, s, s, 64, 64, True, bf16) for s in CHECK_SEQS]
    cases += [(1, 14, 2, s, s, 64, 64, True, bf16)
              for s in sorted(set(serve_lens))]
    cases += [(2, 4, 2, 64, 192, 32, 32, False, bf16),
              (1, 4, 2, 33, 77, 24, 40, False, f32),
              (1, 14, 2, 100, 100, 64, 64, True, f32),
              (2, 8, 8, 256, 256, 128, 128, True, f32)]
    launches0 = fa.launches
    path_err = 0.0
    for (b, hq, hkv, sq, sk, dk, dv, causal, dt) in cases:
        q, k, v = _qkv(gen, b, hq, hkv, sq, sk, dk, dv, dt)
        out = fa.flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        ref = fa.flash_attention_plain(q, k, v, causal=causal)
        err = (out.float() - ref.float()).abs()
        atol, rtol = TOL[str(dt).split(".")[1]]
        ok = bool((err <= atol + rtol * ref.float().abs()).all())
        log(f"flash check B={b} Hq={hq} Hkv={hkv} Sq={sq} Sk={sk} "
            f"Dk={dk} Dv={dv} causal={causal} {str(dt)[6:]}: "
            f"max_abs_err={err.max().item():.3e} (atol {atol}, rtol {rtol})"
            f" {'ok' if ok else 'FAIL'}")
        require(ok, "flash kernel disagrees with its plain version")
        if dt == bf16 and (b, hq, hkv, dk) == (1, 14, 2, 64):
            path_err = max(path_err, err.max().item())

    # device time at the shapes the serve phase gives the kernel: one
    # (B=1, Hq=14, Hkv=2, S, D=64) causal bf16 call per prompt length
    rows, host = [], []
    for s in serve_lens:
        q, k, v = _qkv(gen, 1, 14, 2, s, s, 64, 64, bf16)
        launch = lambda: fa.flash_attention(q, k, v, causal=True)
        rows.append((
            device_ms(launch),
            device_ms(lambda: fa.flash_attention_plain(q, k, v, causal=True)),
            device_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True)),
            flash_bound_ms(14, 2, s, s, 64, True, "bfloat16")))
        host.append(cuda_ms(launch))
    n = len(rows)
    t_ops = sum(r[3][0] for r in rows)
    t_bytes = sum(r[3][1] for r in rows)
    row = {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:28",
        "launches": None, "max_abs_err": path_err,
        "ms": sum(r[0] for r in rows) / n,
        "plain_ms": sum(r[1] for r in rows) / n,
        "bound_ms": sum(max(r[3]) for r in rows) / n,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": sum(r[2] for r in rows) / n,
    }
    log(f"flash device time over the {n} serve prompt lengths (mean per "
        f"call, ms): kernel {row['ms']:.5f}, plain {row['plain_ms']:.5f}, "
        f"sdpa {row['library_ms']:.5f}, bound {row['bound_ms']:.6f} "
        f"({row['bound_by']}); kernel with host launch gaps (CUDA events) "
        f"{sum(host) / n:.5f}")
    q, k, v = _qkv(gen, 1, 14, 2, 1024, 1024, 64, 64, bf16)
    k_ms = device_ms(lambda: fa.flash_attention(q, k, v, causal=True))
    l_ms = device_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True))
    bound = max(flash_bound_ms(14, 2, 1024, 1024, 64, True, "bfloat16"))
    log(f"flash device time at S=1024 (ms): kernel {k_ms:.5f}, sdpa "
        f"{l_ms:.5f}, bound {bound:.6f}")
    log(f"flash checks and timing launched the kernel "
        f"{fa.launches - launches0} times (not counted below)")
    return row


def _prompts(vocab):
    import numpy as np
    rng = np.random.default_rng(0)
    lens = [int(x) for x in rng.integers(32, 513, SERVE_REQUESTS)]
    if not any(is_prime(x) for x in lens):
        lens[-1] = 509
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lens]


def _profiled(label, fn, n_kernels=6):
    """Print ``fn``'s wall time, the device's busy and idle share,
    launches, and the kernels that took the most device time."""
    wall, kern = trace(fn)
    busy = sum(e.self_device_time_total for e in kern) / 1e3
    launches = sum(e.count for e in kern)
    log(f"profile {label}: wall {wall:.3f} ms, device busy {busy:.3f} ms "
        f"({100 * busy / wall:.1f}%), idle {100 * (1 - busy / wall):.1f}%, "
        f"{launches} kernel launches")
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[
            :n_kernels]:
        t = e.self_device_time_total / 1e3
        log(f"profile {label}:   {t:9.3f} ms {100 * t / max(busy, 1e-9):5.1f}%"
            f" x{e.count:<5d} {e.key[:90]}")


def phase_profile(cfg, params, kernels, prompts):
    """Where the time of a prefill and of a full decode tick goes, after
    the measured run (its counts are already read)."""
    from repro_torch.serving import Request, ServeConfig, ServingEngine
    one = ServingEngine(cfg, params, ServeConfig(
        n_slots=1, max_seq=SERVE_MAX_SEQ, max_new_tokens=SERVE_NEW),
        kernels=kernels)
    one.submit(Request(rid=0, prompt=prompts[0]))
    _profiled(f"prefill ({len(prompts[0])} tokens) + 1 decode tick",
              one.tick)
    eng = ServingEngine(cfg, params, ServeConfig(
        n_slots=SERVE_SLOTS, max_seq=SERVE_MAX_SEQ,
        max_new_tokens=SERVE_NEW), kernels=kernels)
    for i, p in enumerate(prompts[:SERVE_SLOTS]):
        eng.submit(Request(rid=i, prompt=p))
    eng.tick()
    _profiled(f"4 decode ticks of {SERVE_SLOTS} slots",
              lambda: [eng.tick() for _ in range(4)])


def phase_serve(prompts):
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import model_kernels
    from repro_torch.models import init_model
    from repro_torch.models.common import param_bytes, param_count
    from repro_torch.serving import Request, ServeConfig, ServingEngine

    cfg = get_config("qwen2-0.5b")
    torch.cuda.reset_peak_memory_stats()
    params = init_model(torch.Generator(device="cuda").manual_seed(0), cfg,
                        device="cuda")
    log(f"serve: {cfg.name} full width, {cfg.n_layers} layers, "
        f"{param_count(params)} params, {param_bytes(params)} bytes, "
        f"{str(cfg.dtype)[6:]}")
    kernels = model_kernels(cfg)

    # warm-up: one short request through a small engine (cuBLAS handles,
    # allocator); the counts are reset below, before the measured run
    warm = ServingEngine(cfg, params, ServeConfig(n_slots=1, max_seq=64,
                                                  max_new_tokens=2),
                         kernels=kernels)
    warm.submit(Request(rid=-1, prompt=prompts[0][:16]))
    warm.run_until_drained()
    del warm

    eng = ServingEngine(cfg, params, ServeConfig(
        n_slots=SERVE_SLOTS, max_seq=SERVE_MAX_SEQ,
        max_new_tokens=SERVE_NEW), kernels=kernels)
    torch.cuda.synchronize()
    fa.launches = 0
    t0 = time.perf_counter()
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p))
    done = eng.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fa.launches

    require(len(done) == len(prompts) and not eng.failed,
            f"{len(done)} of {len(prompts)} finished, failed: "
            f"{[r.error for r in eng.failed]}")
    require(all(len(r.output) == SERVE_NEW for r in done),
            f"output lengths {[len(r.output) for r in done]}")
    require(eng.stats["prefills"] == len(prompts), f"stats {eng.stats}")
    require(launches == cfg.n_layers * eng.stats["prefills"],
            f"flash launches {launches}, stats {eng.stats}")
    tasks = list(eng._executor.graph.tasks.values())
    admitted = {t.name for t in tasks
                if t.name.startswith("prefill:") and t.done}
    decodes = sum(1 for t in tasks if t.name == "decode" and t.done)
    require(admitted == {f"prefill:{i}" for i in range(len(prompts))},
            f"admission tasks run: {sorted(admitted)}")
    require(decodes >= eng.stats["ticks"] > 0,
            f"{decodes} decode tasks, stats {eng.stats}")
    toks = sum(len(r.output) for r in done)
    pre, dec = eng.timings["prefill_ms"], eng.timings["decode_ms"]
    log(f"serve: {len(done)} requests, prompt lengths "
        f"{[len(p) for p in prompts]}, {toks} tokens in {wall:.3f} s = "
        f"{toks / wall:.1f} tokens/s; mean prefill {sum(pre) / len(pre):.3f}"
        f" ms, mean decode tick {sum(dec) / len(dec):.3f} ms "
        f"({len(dec)} ticks of {SERVE_SLOTS} slots); "
        f"max_memory_allocated {torch.cuda.max_memory_allocated()} bytes; "
        f"stats {eng.stats}; executor {eng._executor.stats}; "
        f"flash launches {launches} = {cfg.n_layers} x "
        f"{eng.stats['prefills']} prefills; card {smi()}")
    phase_profile(cfg, params, kernels, prompts)
    return launches


def phase_greedy(prompts):
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import model_kernels
    from repro_torch.models import apply_model, init_model
    from repro_torch.serving import Request, ServeConfig, ServingEngine

    cfg = dataclasses.replace(get_config("qwen2-0.5b"), dtype=torch.float32,
                              param_dtype=torch.float32)
    log(f"greedy: dtype override {cfg.name} -> float32 (params and "
        f"activations), allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    params = init_model(torch.Generator(device="cuda").manual_seed(0), cfg,
                        device="cuda")
    kernels = model_kernels(cfg)
    prompt = next(p for p in prompts if is_prime(len(p)))[:61]
    n_new = 16
    eng = ServingEngine(cfg, params, ServeConfig(n_slots=2, max_seq=256,
                                                 max_new_tokens=n_new),
                        kernels=kernels)
    eng.submit(Request(rid=0, prompt=prompt))
    out = eng.run_until_drained()[0].output
    toks = [int(t) for t in prompt]
    for _ in range(n_new):
        lg = apply_model(cfg, params,
                         torch.as_tensor(toks, device="cuda")[None],
                         kernels=kernels)
        toks.append(int(torch.argmax(lg[0, -1])))
    ref = toks[len(prompt):]
    log(f"greedy: prompt {len(prompt)} tokens; engine {out}; "
        f"apply_model {ref}")
    require(out == ref, "engine diverged from token-by-token apply_model")
    log("greedy: consistent")


def main() -> int:
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found: run from a "
              f"checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    t0 = time.perf_counter()
    phase_device()
    phase_build()
    import torch
    from repro_torch.configs.base import get_config
    prompts = _prompts(get_config("qwen2-0.5b").vocab)
    row = phase_kernel_check([len(p) for p in prompts])
    row["launches"] = phase_serve(prompts)
    torch.cuda.empty_cache()
    phase_greedy(prompts)
    require("jax" not in sys.modules and "repro" not in sys.modules,
            "the reference package or JAX was imported")
    log(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": [row]}))
    print(smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
