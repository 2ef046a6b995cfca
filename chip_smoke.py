#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA Hopper card.

    python3 chip_smoke.py

Phases, in order; the first that fails raises and the script exits
non-zero:

1. device: CUDA with compute capability (9, 0), the card's name and
   power limit as ``nvidia-smi`` reports them;
2. build: every CUDA source of the port, one ``nvcc`` each, in parallel;
3. kernel checks: each kernel (flash attention, SSD scan) against its
   plain PyTorch version on the card, at the serving shapes and a few
   others, then timed beside its plain version and, where one exists,
   one PyTorch library call;
4. serve, one path after another: ``qwen2-0.5b`` and then
   ``mamba2-130m``, each at full width in bf16 (random weights from seed
   0), answer 16 requests through ``ServingEngine`` (LCX runtime + AMT
   executor) with the port's kernels.  The launch counts are set to 0
   just before each run and read just after: every kernel of the path
   must have launched once per layer of its kind and prefill, and no
   other.  Then a prefill and four decode ticks run under
   ``torch.profiler``, which reports the device's busy share and the
   kernels that take its time;
5. greedy consistency: for each of the two models at full width in
   float32, the engine's greedy tokens equal token-by-token
   ``apply_model`` with the same kernels;
6. hybrid: a reduced stack of attention and Mamba layers (a check of the
   layer plan, not a published model) passes the same greedy check, and
   both kernels launch in its prefill.

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
SSD_SEQS = (1, 7, 64, 100, 257, 512, 1024)
# kernel vs plain version (atol, rtol): the two sum in another order, and
# in bf16 each rounds p and the output, so they may land one bf16 step
# (2^-8 relative) apart; the f32 bound is tests/test_kernels.py's
TOL = {"bfloat16": (2e-2, 1e-2), "float32": (2e-5, 1e-5)}
# SSD kernel vs plain version: both sum in f32, in another order (about
# 1e-6 relative apart), so h_final, which stays f32, is held to
# tests/test_kernels.py's f32 bound at every dtype; y is rounded once to
# its dtype, and in bf16 two f32 values that close may round to
# neighbouring bf16 values, one step (at most 2^-7 of |y|) apart
SSD_TOL = {"bfloat16": (1e-2, 1e-2), "float32": (1e-4, 0.0)}
SSD_H_ATOL = 1e-4


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


def ssd_bound_ms(b, h, s, p, n, groups, dtype_name, chunk) -> tuple:
    """(operations ms, bytes ms) for the SSD scan on these inputs: x, dt,
    A and B and C (once per group: the heads of a group share them) read
    once, y and h_final written once against the memory rate; against
    the tensor-core rate the products the data needs: C.B and w.x over
    the pairs j <= i within each chunk of ``chunk`` rows, C.h and the
    state update B (x) x for every row and head."""
    esz = 2 if dtype_name == "bfloat16" else 4
    nbytes = (2 * b * s * h * p + 2 * b * s * groups * n) * esz \
        + b * s * h * 4 + h * 4 + b * h * n * p * 4
    pairs = sum(r * (r + 1) // 2 for r in
                [chunk] * (s // chunk) + ([s % chunk] if s % chunk else []))
    flops = b * h * (2 * (n + p) * pairs + 4 * n * p * s)
    return (flops / PEAK_FLOPS[dtype_name] * 1e3,
            nbytes / PEAK_BYTES_PER_S * 1e3)


def _kernel_modules():
    from repro_torch.kernels import flash_attention, ssd_scan
    return {"flash_attention": flash_attention, "ssd_scan": ssd_scan}


def reset_counts() -> None:
    for m in _kernel_modules().values():
        m.launches = 0


def read_counts() -> dict:
    return {k: m.launches for k, m in _kernel_modules().items()}


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


def _ssd_inputs(gen, b, s, h, p, n, dtype, groups=None):
    """x, dt (after softplus, mostly small as the model's), A (negative,
    the model's -1 .. -16), B, C.  With ``groups`` x, B and C are laid out
    as the Mamba mixer gives them to the kernel: views of one conv output
    [b, s, h*p + 2*groups*n] cut by ``models.ssm._heads`` (x strided over
    S, each group's B/C repeated over its heads, with stride 0 for one
    group).  Without, all three are contiguous and B/C are per head."""
    import types
    import torch
    import torch.nn.functional as F
    from repro_torch.models.ssm import _heads
    r = lambda *shape: torch.randn(shape, generator=gen, device="cuda")
    dt = F.softplus(r(b, s, h) - 2.0)
    A = -torch.linspace(1.0, 16.0, h, device="cuda")
    if groups is None:
        return (r(b, s, h, p).to(dtype), dt, A,
                (0.3 * r(b, s, h, n)).to(dtype),
                (0.3 * r(b, s, h, n)).to(dtype))
    xbc = torch.cat([r(b, s, h * p), 0.3 * r(b, s, 2 * groups * n)],
                    dim=-1).to(dtype)
    cfg = types.SimpleNamespace(ssm_d_inner=h * p, ssm_groups=groups,
                                ssm_state=n, ssm_heads=h, ssm_head_dim=p)
    x, Bm, Cm = _heads(cfg, xbc)
    return x, dt, A, Bm, Cm


def _layout(args) -> str:
    x, _, _, Bm, _ = args
    return (f"x strides {tuple(x.stride())}, B strides "
            f"{tuple(Bm.stride())}")


def phase_ssd_check(serve_lens):
    """Returns the SSD kernel's row of the kernels line (without the
    launch count, which comes from the mamba2-130m serve phase)."""
    import torch
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.kernels.ref import ssd_scan_ref

    gen = torch.Generator(device="cuda").manual_seed(1)
    bf16, f32 = torch.bfloat16, torch.float32
    # (B, S, H, P, N, dtype, groups): groups set = the mixer's layout (see
    # _ssd_inputs), None = contiguous per-head inputs.  mamba2-130m's
    # prefill is B=1, H=24, P=64, N=128, one group, bf16
    serve = (1, 24, 64, 128, bf16, 1)
    cases = [(1, s, 24, 64, 128, bf16, 1)
             for s in sorted(set(SSD_SEQS) | set(serve_lens))]
    cases += [(1, 100, 24, 64, 128, bf16, None),
              (1, 1024, 24, 64, 128, bf16, None),
              (2, 100, 24, 64, 128, f32, None), (2, 100, 24, 64, 128, f32, 1),
              (1, 77, 3, 40, 24, f32, None), (1, 130, 2, 128, 96, bf16, None),
              (1, 130, 4, 40, 24, bf16, 2)]
    launches0 = ssd.launches
    path_err = 0.0
    for (b, s, h, p, n, dt, g) in cases:
        args = _ssd_inputs(gen, b, s, h, p, n, dt, g)
        y, hf = ssd.ssd_scan(*args)
        torch.cuda.synchronize()
        ry, rh = ssd.ssd_scan_plain(*args)
        refs = [("plain", ry, rh)]
        if dt == f32 and b == 2:
            refs.append(("sequential ref", *ssd_scan_ref(*args)))
        atol, rtol = SSD_TOL[str(dt)[6:]]
        for name, want_y, want_h in refs:
            ey = (y.float() - want_y.float()).abs()
            eh = (hf - want_h).abs()
            ok = bool((ey <= atol + rtol * want_y.float().abs()).all()
                      and (eh <= SSD_H_ATOL).all())
            log(f"ssd check B={b} S={s} H={h} P={p} N={n} {str(dt)[6:]} "
                f"groups={g} ({_layout(args)}) vs {name}: y max_abs_err="
                f"{ey.max().item():.3e} (atol {atol}, rtol {rtol}), "
                f"h_final max_abs_err={eh.max().item():.3e} (atol "
                f"{SSD_H_ATOL}) {'ok' if ok else 'FAIL'}")
            require(ok, f"SSD kernel disagrees with its {name}")
        if (b, h, p, n, dt, g) == serve:
            path_err = max(path_err, (y.float() - ry.float()).abs().max()
                           .item())

    # device time at the shapes and layout the mamba2-130m serve phase
    # gives the kernel: one (B=1, S, H=24, P=64, N=128, one group) bf16
    # call per prompt length
    rows, host = [], []
    for s in serve_lens:
        args = _ssd_inputs(gen, 1, s, 24, 64, 128, bf16, 1)
        launch = lambda: ssd.ssd_scan(*args)
        rows.append((device_ms(launch),
                     device_ms(lambda: ssd.ssd_scan_plain(*args)),
                     ssd_bound_ms(1, 24, s, 64, 128, 1, "bfloat16",
                                  ssd.CHUNK)))
        host.append(cuda_ms(launch))
    n = len(rows)
    t_ops = sum(r[2][0] for r in rows)
    t_bytes = sum(r[2][1] for r in rows)
    row = {
        "name": "ssd_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:27",
        "launches": None, "max_abs_err": path_err,
        "ms": sum(r[0] for r in rows) / n,
        "plain_ms": sum(r[1] for r in rows) / n,
        "bound_ms": sum(max(r[2]) for r in rows) / n,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        # PyTorch has no op for the SSD scan and the machine has no mamba
        # package; composing it from torch calls is the plain version
        "library_ms": None,
    }
    log(f"ssd device time over the {n} serve prompt lengths (mean per "
        f"call, ms): kernel {row['ms']:.5f}, plain {row['plain_ms']:.5f}, "
        f"bound {row['bound_ms']:.6f} ({row['bound_by']}; chunk "
        f"{ssd.CHUNK}); no library call computes it; kernel with host "
        f"launch gaps (CUDA events) {sum(host) / n:.5f}")
    for g in (1, None):
        args = _ssd_inputs(gen, 1, 1024, 24, 64, 128, bf16, g)
        k_ms = device_ms(lambda: ssd.ssd_scan(*args))
        p_ms = device_ms(lambda: ssd.ssd_scan_plain(*args))
        ops_ms, bytes_ms = ssd_bound_ms(1, 24, 1024, 64, 128, g or 24,
                                        "bfloat16", ssd.CHUNK)
        log(f"ssd device time at S=1024, "
            f"{'the mixer layout' if g else 'contiguous per-head B/C'} "
            f"(ms): kernel {k_ms:.5f}, plain {p_ms:.5f}, bound "
            f"{max(ops_ms, bytes_ms):.6f} (operations {ops_ms:.6f}, bytes "
            f"{bytes_ms:.6f})")
    log(f"ssd checks and timing launched the kernel "
        f"{ssd.launches - launches0} times (not counted below)")
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
    _profiled(f"{cfg.name} prefill ({len(prompts[0])} tokens) + 1 decode "
              f"tick", one.tick)
    eng = ServingEngine(cfg, params, ServeConfig(
        n_slots=SERVE_SLOTS, max_seq=SERVE_MAX_SEQ,
        max_new_tokens=SERVE_NEW), kernels=kernels)
    for i, p in enumerate(prompts[:SERVE_SLOTS]):
        eng.submit(Request(rid=i, prompt=p))
    eng.tick()
    _profiled(f"{cfg.name} 4 decode ticks of {SERVE_SLOTS} slots",
              lambda: [eng.tick() for _ in range(4)])


def expected_launches(cfg, prefills) -> dict:
    """Each kernel's launches in a serve run: one per prefill and layer
    of its kind (decode is plain PyTorch, as in the reference)."""
    plan = cfg.layer_plan()
    return {"flash_attention": prefills * sum(l.mixer == "attn"
                                              for l in plan),
            "ssd_scan": prefills * sum(l.mixer == "mamba" for l in plan)}


def phase_serve(arch, prompts):
    """Serve ``prompts`` at ``arch``'s full width; returns the launch
    counts of the run."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import model_kernels
    from repro_torch.models import init_model
    from repro_torch.models.common import param_bytes, param_count
    from repro_torch.serving import Request, ServeConfig, ServingEngine

    cfg = get_config(arch)
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
    reset_counts()
    t0 = time.perf_counter()
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p))
    done = eng.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()

    require(len(done) == len(prompts) and not eng.failed,
            f"{len(done)} of {len(prompts)} finished, failed: "
            f"{[r.error for r in eng.failed]}")
    require(all(len(r.output) == SERVE_NEW for r in done),
            f"output lengths {[len(r.output) for r in done]}")
    require(eng.stats["prefills"] == len(prompts), f"stats {eng.stats}")
    want = expected_launches(cfg, eng.stats["prefills"])
    require(counts == want and any(counts.values()),
            f"launches {counts}, expected {want}, stats {eng.stats}")
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
        f"launches {counts} for {eng.stats['prefills']} prefills of "
        f"{cfg.n_layers} layers; card {smi()}")
    phase_profile(cfg, params, kernels, prompts)
    return counts


def _greedy(cfg, params, prompt, n_new):
    """The engine's greedy tokens for ``prompt`` (and the launch counts
    of that run), then token-by-token ``apply_model``'s."""
    import torch
    from repro_torch.kernels import model_kernels
    from repro_torch.models import apply_model
    from repro_torch.serving import Request, ServeConfig, ServingEngine

    kernels = model_kernels(cfg)
    eng = ServingEngine(cfg, params, ServeConfig(n_slots=2, max_seq=256,
                                                 max_new_tokens=n_new),
                        kernels=kernels)
    reset_counts()
    eng.submit(Request(rid=0, prompt=prompt))
    out = eng.run_until_drained()[0].output
    counts = read_counts()
    toks = [int(t) for t in prompt]
    for _ in range(n_new):
        lg = apply_model(cfg, params,
                         torch.as_tensor(toks, device="cuda")[None],
                         kernels=kernels)
        toks.append(int(torch.argmax(lg[0, -1])))
    return out, toks[len(prompt):], counts


def phase_greedy(arch, prompts):
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.models import init_model

    cfg = dataclasses.replace(get_config(arch), dtype=torch.float32,
                              param_dtype=torch.float32)
    log(f"greedy: dtype override {cfg.name} -> float32 (params and "
        f"activations), allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    params = init_model(torch.Generator(device="cuda").manual_seed(0), cfg,
                        device="cuda")
    prompt = next(p for p in prompts if is_prime(len(p)))[:61]
    out, ref, counts = _greedy(cfg, params, prompt, 16)
    log(f"greedy: {cfg.name} prompt {len(prompt)} tokens; engine {out}; "
        f"apply_model {ref}; engine launches {counts}")
    require(out == ref, "engine diverged from token-by-token apply_model")
    log(f"greedy: {cfg.name} consistent")


def phase_hybrid(prompts):
    """The hybrid layer plan (attention every 4th layer at offset 1, the
    rest Mamba, dense FFNs, no experts) at mamba2-130m's SSM widths, cut
    to 8 layers, in float32."""
    import torch
    from repro_torch.configs.base import ModelConfig, get_config
    from repro_torch.models import init_model

    m = get_config("mamba2-130m")
    cfg = ModelConfig(
        name="hybrid-check", family="hybrid", n_layers=8, d_model=768,
        n_heads=12, n_kv_heads=4, d_ff=2048, vocab=m.vocab,
        attn_layer_period=4, attn_layer_offset=1, ssm_state=m.ssm_state,
        ssm_expand=m.ssm_expand, ssm_head_dim=m.ssm_head_dim,
        ssm_groups=m.ssm_groups, ssm_conv=m.ssm_conv,
        ssm_chunk=m.ssm_chunk, dtype=torch.float32,
        param_dtype=torch.float32)
    plan = "".join("a" if l.mixer == "attn" else "m"
                   for l in cfg.layer_plan())
    log(f"hybrid: a check of the layer plan, not a published model: "
        f"{cfg.n_layers} layers ({plan}), d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads / {cfg.n_kv_heads} KV heads, d_ff "
        f"{cfg.d_ff}, SSM state {cfg.ssm_state} x {cfg.ssm_heads} heads of "
        f"{cfg.ssm_head_dim}, float32")
    params = init_model(torch.Generator(device="cuda").manual_seed(0), cfg,
                        device="cuda")
    prompt = next(p for p in prompts if is_prime(len(p)))[:61]
    out, ref, counts = _greedy(cfg, params, prompt, 16)
    want = expected_launches(cfg, 1)
    log(f"hybrid: prompt {len(prompt)} tokens; engine {out}; apply_model "
        f"{ref}; engine launches {counts} (expected {want})")
    require(counts == want and all(want.values()),
            f"hybrid launches {counts}, expected {want}")
    require(out == ref, "hybrid engine diverged from token-by-token "
            "apply_model")
    log("hybrid: consistent")


def release() -> None:
    """Free the last phase's model before the next: an engine and its
    executor's task closures refer to each other, so only the garbage
    collector frees them (else the next phase's peak memory counts them)."""
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()


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
    m_prompts = _prompts(get_config("mamba2-130m").vocab)
    flash = phase_kernel_check([len(p) for p in prompts])
    ssd = phase_ssd_check([len(p) for p in m_prompts])
    flash["launches"] = phase_serve("qwen2-0.5b", prompts)["flash_attention"]
    release()
    ssd["launches"] = phase_serve("mamba2-130m", m_prompts)["ssd_scan"]
    release()
    phase_greedy("qwen2-0.5b", prompts)
    release()
    phase_greedy("mamba2-130m", m_prompts)
    release()
    phase_hybrid(m_prompts)
    require("jax" not in sys.modules and "repro" not in sys.modules,
            "the reference package or JAX was imported")
    log(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": [flash, ssd]}))
    print(smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
