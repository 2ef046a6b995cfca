#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA Hopper card.

    python3 chip_smoke.py
    python3 chip_smoke.py --serve ARCH [ARCH ...]   # phases 1, 2, serve

Phases, in order; the first that fails raises and the script exits
non-zero:

1. device: CUDA with compute capability (9, 0), the card's name and
   power limit as ``nvidia-smi`` reports them;
2. build: every CUDA source of the port, one ``nvcc`` each, in parallel;
3. kernel checks: each kernel (flash attention, SSD scan, the ring
   all-gather, the MoE grouped matmul) against its plain PyTorch version
   on the card (the ring bit for bit, x aligned and not), at the
   serving shapes and a few others (flash also at qwen3-moe-30b-a3b's
   attention shape and on the strided seq-major views the model's hook
   passes), then timed beside its plain version and, where one exists,
   one PyTorch library call; the GQA decode-attention kernel (RoPE, the
   cache-row write and split-KV attention in one launch) against its
   plain version at internlm2-20b's two benchmark cells' shapes (32 slots
   of 1,185 rows, 24 of 6,187), starcoder2-7b's window, qwen2-0.5b's head
   dim of 64 and command-r-plus's 12 query heads a KV head, free slots at
   length 0 and full ones included: the caches bit for bit, the output
   within ``TOL``; timed beside its plain version and SDPA;
4. serve, one path after another: ``qwen2-0.5b``, ``mamba2-130m`` and
   ``qwen3-moe-30b-a3b`` (48 layers, ~30.5 B parameters), each at full
   width in bf16 (random weights from seed 0, drawn on the card), answer
   16 requests through ``ServingEngine`` (LCX runtime + AMT executor)
   with the port's kernels.  The launch counts are set to 0 just before
   each run and read just after: flash and SSD must have launched once
   per layer of their kind and prefill, the grouped matmul three times
   per MoE layer and prefill or decode tick (decode runs the experts
   too), decode attention once per GQA layer and decode tick (bf16
   configs with a head dim of 64 or 128), and no kernel of another path.
   Then a prefill and four decode ticks run under ``torch.profiler``,
   which reports the device's busy
   share and the kernels that take its time, and one prefill and one
   decode tick run with the engine's dispatch spans under CUDA's sync
   debug mode, which logs any call in them that waits for the card
   (``sync check:`` lines).  Before the first, ``trace cost:`` times the
   engine's tick on the host with its trace on and off, its dispatch
   stubbed;
5. greedy consistency: for each model at full width in float32
   (qwen3-moe-30b-a3b cut to 4 layers, capacity factor E/k so that
   nothing drops), the engine's greedy tokens equal token-by-token
   ``apply_model`` with the same kernels;
6. hybrid: reduced stacks of attention and Mamba layers, without and
   with Jamba's experts (checks of the layer plan, not published models),
   pass the same greedy check, and each kernel of the plan launches in
   its prefill;
7. LCX expert-parallel dispatch: one qwen3-moe-30b-a3b MoE layer at full
   width, 8 ranks of 512 tokens stacked on the card, through
   ``models.moe._moe_ep_shard`` with the native and the pairwise
   all-to-all, each rank bit-equal to its own sort-path MoE;
8. collectives at qwen2-0.5b's sizes, 8 ranks stacked on the card: each
   of the 24 decoder layers (14,912,384 bf16 parameters) gathered
   FSDP-style from 8 shards through ``kernels.ops.ring_all_gather`` (24
   ring launches), bit for bit against LCX's ring and native all-gather;
   reduce-scatter, all-reduce, all-to-all and broadcast on a layer in f32
   and bf16, ring against native, with their ``Device.stats`` transfer
   counts; a ring all-reduce of the full parameter count in f32 over 4
   ranks (7.9 GB) against native;
9. the quickstart (``examples/quickstart.py``'s flow, ring all-reduce
   included) on 4 ranks as CUDA tensors;
10. remote spawn: ``RemoteSpawner`` on 8 ranks with a ``[8, 4096]``
   payload, and an unknown handler resolving to a ``RemoteFailure``;
11. failover serving: the 16 requests of phase 4 through
   ``ServingEngine(failover=True)`` at full qwen2-0.5b width, with the
   serving device frozen after the first 8 admissions while hand-off
   transfers are in flight; the heartbeat migrates them, every request
   finishes, and the tokens equal phase 4's;
12. the other reference architectures at full width in bf16, one at a
   time, through the same serve run as phase 4 (launch counts, profile):
   ``deepseek-v3-671b`` cut to 5 of 61 layers (its 3 dense prefix layers
   and 2 MoE layers, MLA attention, 256 experts: the grouped matmul 3
   times per MoE layer per prefill and tick, flash never),
   ``internlm2-20b`` (48 layers, flash once per layer and prefill),
   ``starcoder2-7b`` (32 layers; windowed, so flash never) and
   ``command-r-plus-104b`` cut to 8 of 64 layers;
13. the f32 greedy check of phase 5 for each of them, cut in depth
   (deepseek-v3 to 2 layers with capacity factor E/k, which holds the
   absorbed MLA decode against the up-projected prefill; starcoder2's
   window cut to 32 rows so that prompt and decode cross it);
14. the frontends: ``llava-next-mistral-7b`` at full width, a prefill of
   576 patch embeddings ahead of a 64-token prompt and 16 decode steps,
   and in f32 at 4 layers against token-by-token
   ``apply_model(frontend_embeds=)``; ``hubert-xlarge`` at full width,
   ``apply_model`` on 1024 frames through the non-causal flash kernel,
   and in f32 at 4 layers against plain attention.

15. training, with no kernel of the port (the reference trains with
   ``kernels=None``; the four kernels must launch 0 times): qwen2-0.5b at
   full width and depth (bf16 params, f32 moments, ``remat="full"``, seq
   1024 x batch 8, so the chunked attention and its custom backward run
   on 4 blocks of 256) through ``Trainer.run`` for 8 steps; the same run
   again checkpointing every 2 steps with a node failure injected at
   step 5, which must recover to step 8 with the uninterrupted run's
   losses; one step each with ``grad_accum=2`` (f32 and int8
   accumulators); mamba2-130m for 4 steps; qwen3-moe-30b-a3b at full
   width cut to 4 of 48 layers for 4 steps; the paths whose training
   state a card holds only cut (``TRAIN_CUTS``), at full width for 4
   steps each: hubert-xlarge whole (non-causal, on frames),
   llava-next-mistral-7b (576 patch rows ahead of each row's 1024 tokens,
   cut from the logits) at the depth two probe runs at 2 and 4 layers
   pick from the slope of their peak memory, and DeepSeek-V3 with its MTP
   loss at its 3 dense layers and one MoE layer with 32 of 256 routed
   experts (16 if 32 run out of memory); each of these paths at smoke
   widths in f32, one step on the card against the same step on the CPU;
   and the attention's custom backward against autograd through
   ``attention_full`` in f32 at qwen2's head shape.  Each step prints its
   loss and its parts, host ms, tokens/s and model flop/s, each run its
   peak memory, one profiled step its busy share, and each short run its
   step's one-card bound counted on ``meta`` (below the measured median
   step, or the run fails).

16. the mesh paths, every rank on this card (the port's rank-stacked
   mesh; each phase counts the calls of its mesh branch, so a silent
   fall-through to the meshless path fails): pipeline parallelism,
   qwen2-0.5b at full width and depth over (pipe=4, data=2), batch 8 x
   1024 in 8 micro-batches, ``pp_loss`` forward and backward through
   GPipe over LCX puts against ``loss_fn`` (and in f32 at 4 layers the
   logits and every gradient against ``apply_model`` / ``loss_fn``);
   GPipe over 4 stages with the stage device frozen before tick 0 (one
   failover, outputs equal to the sequential stack); the
   context-parallel decode, qwen2-0.5b under (data=2, model=4) with
   ``decode_rules`` (sequence-sharded cache), a flash prefill of 8 x 512
   and 32 ticks with and without the mesh; the resident-expert decode
   with the context-parallel MLA decode, deepseek-v3-671b cut to 5
   layers, 32 experts resident a rank, 16 ticks (the grouped matmul 3
   times per MoE layer and tick), its MoE layer bit-equal to the
   meshless decode at B = 8, where their capacities agree (this one
   right after phase 12's DeepSeek-V3 serve, on its params); expert
   parallelism through
   ``moe_apply``, qwen3-moe-30b-a3b's prefill of 8 x 512 (512 tokens a
   rank, C = 40; the grouped matmul is timed at that shape with the
   kernel checks); each with its f32 check
   against the meshless path at a cut depth; ``compressed_psum`` of
   qwen2-0.5b's full gradient over 4 stacked ranks; and
   ``Trainer(mesh=(data=4, model=2))`` for 2 steps, ``remesh`` to (2, 2)
   and 2 more, losses bitwise equal to an unmeshed run's.

17. the causal-skip schedule (after training, before the mesh phases):
   qwen2-0.5b's loss and gradients at the train phase's 1024 x 8 in bf16
   through ``loss_fn(impl="chunked")`` and ``"chunked_causal_skip"``,
   timed once each after a warm-up round, with peak memory; losses within
   one bf16 step, no kernel launches; in f32 at 2 layers the loss and
   every gradient within 1e-5;
18. the example scripts (after the mesh phases): ``examples/torch_*.py``
   on the card in child processes started together, each exiting 0 with
   its ``... OK`` line (``torch_train_lm.py`` at 300 steps);
19. the dry run: ``run_cell("qwen2-0.5b", "train_4k")`` on the 16 x 16
   mesh (256 ranks stacked on ``meta``), its ``RooflineReport`` on the
   H100's constants, and the train phase's qwen2-0.5b step counted the
   same way on one card: its compute and memory terms must lie below the
   step time phase 15 measured.

Phase 3 also checks flash at internlm2-20b's, command-r-plus-104b's,
llava's and hubert's attention shapes (head dim 80, not causal) and the
grouped matmul at deepseek-v3's expert shape (256 experts, 7168 <-> 2048),
and that ``backend="xla"`` on CUDA tensors raises, naming each kernel's
plain function, with no launch.

Output: one line per check, then a ``{"kernels": [...]}`` JSON line
(flash attention, SSD scan, ring all-gather, grouped matmul, decode
attention at each checked shape; the flash and grouped-matmul launches of
the mesh paths counted in), the card's name and power limit, and as the
last line ``{"ok": true, "device": {...}}``.  It
imports nothing of JAX: the reference package is not used here.
"""
from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit): the
# package's constants (``repro_torch.launch.mesh``), read by
# ``_load_peaks`` once ``src`` is on the path
PEAK_BYTES_PER_S = 0.0
PEAK_FLOPS = {}

SERVE_SLOTS, SERVE_MAX_SEQ, SERVE_NEW, SERVE_REQUESTS = 8, 1024, 32, 16
CHECK_SEQS = (1, 7, 100, 512, 1024)
# 65: one row in the second chunk; 2048: a 32-chunk state pass
SSD_SEQS = (1, 7, 64, 65, 100, 257, 512, 1024, 2048)
# the SSD kernel's previous design (one block per (b, h) walking its
# chunks), measured by this script on an NVIDIA H100 80GB HBM3 at 700.00 W:
# mean ms over the mamba2-130m serve prompt lengths, and at S = 1024 in
# the mixer's layout and with contiguous per-head B/C
SSD_OLD_MS = {"serve": 0.15873, 1: 0.56021, None: 0.56140}
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
# ring all-gather sweep: ranks, dtypes and per-rank shard bytes (4 B to
# 64 MiB, the range of the paper's Fig. 1 message sizes; 6 B is 3 bf16)
RING_NS = (1, 2, 4, 8)
RING_DTYPES = ("float32", "bfloat16", "int32")
RING_BYTES = (4, 6, 8, 4096, 1 << 20, 64 << 20)
# sweep cases with x a contiguous view at these byte offsets into a larger
# buffer: a body that is not 16-byte aligned takes narrower vectors
RING_OFFSETS = (2, 4, 8)
# the ring kernel's previous design (the TPU kernel's ring: n - 1
# forwarding steps with per-span flags, a memset and a cooperative launch
# a call), measured by this script on an NVIDIA H100 80GB HBM3 at
# 700.00 W: at the FSDP gather's shape and at 64 MiB shards over n ranks
RING_OLD_MS = {"fsdp": 0.16077, 2: 0.19078, 4: 0.74331, 8: 3.27737}
FSDP_RANKS, FULL_GRAD_RANKS = 8, 4
# ring against native sums: the ring rounds after each of its n - 1 adds,
# native once (or n - 1 times in f32), so the two differ by at most
# 2 * n * eps * sum_i |x_i| elementwise (eps = 2^-24 f32, 2^-8 bf16)
SUM_EPS = {"float32": 2.0 ** -24, "bfloat16": 2.0 ** -8}
# qwen2-0.5b: parameters of one decoder layer and of the whole model
QWEN_LAYER_PARAMS, QWEN_PARAMS = 14_912_384, 494_032_768
# grouped matmul vs plain version: both sum d products in f32 in other
# orders, each within d * u * sum_k |x_k w_k| of the exact sum (u = 2^-24),
# so they differ by at most 2 d u sum_k |x_k w_k|; each output is then
# rounded once to its dtype, which in bf16 can put the two one bf16 step
# (at most 2^-7 of the larger magnitude) apart
GMM_U = 2.0 ** -24
GMM_ROUND = {"bfloat16": 2.0 ** -7, "float32": 0.0}
# qwen3-moe-30b-a3b's expert shapes [E, C, d] @ [E, d, f], per projection
MOE_E, MOE_D, MOE_F = 128, 2048, 768
GMM_CAPS = (8, 16, 24, 40)             # decode (8 slots) and prefills
GMM_RAGGED = ((4, 24, 80, 96), (3, 5, 100, 7), (2, 130, 33, 65))
EP_RANKS, EP_TOKENS = 8, 512           # C = 40 a rank, ep * C = 320
MOE_GREEDY_LAYERS = 4
# the flash kernel at the attention shapes of the dense, VLM and audio
# paths (heads, KV heads and head dim from each config; causal but hubert)
FLASH_ARCHS = ("internlm2-20b", "command-r-plus-104b",
               "llava-next-mistral-7b", "hubert-xlarge")
# deepseek-v3-671b's expert capacities: decode (8 slots), the largest
# serve prefill (498 tokens at capacity factor 1.25)
DSV3_CAPS = (8, 24)
# depth cuts of the full-width paths that do not fit one card whole: the
# layers kept (DeepSeek-V3: its 3 dense prefix layers and 2 MoE layers)
DSV3_SERVE_LAYERS, CMDR_SERVE_LAYERS = 5, 8
SERVE_CUTS = {
    "deepseek-v3-671b": dict(
        n_layers=DSV3_SERVE_LAYERS,
        cut="its 3 dense prefix layers and 2 MoE layers, with the MTP "
        "params; the whole model, ~1.3 TB in bf16, does not fit one card"),
    "command-r-plus-104b": dict(
        n_layers=CMDR_SERVE_LAYERS,
        cut="the whole model, ~208 GB in bf16, does not fit one card"),
}
# the f32 greedy checks' cuts: depth, and starcoder2's window cut so that
# the 61-token prompt and its 16 new tokens cross it
GREEDY_CUTS = {
    "deepseek-v3-671b": dict(n_layers=2, first_k_dense=1),
    "internlm2-20b": dict(n_layers=4),
    "starcoder2-7b": dict(n_layers=4, sliding_window=32),
    "command-r-plus-104b": dict(n_layers=2),
}
# the VLM frontend: 576 patch embeddings ahead of a 64-token prompt, 16 new
# tokens; the audio encoder: 1024 frames.  Their f32 checks keep 4 layers
LLAVA_PROMPT, LLAVA_NEW, HUBERT_FRAMES, FRONTEND_CHECK_LAYERS = 64, 16, 1024, 4
# training: qwen2-0.5b at seq 1024 x batch 8 for 8 steps, the second run
# failing at step 5 with a checkpoint every 2 steps; mamba2-130m and
# qwen3-moe-30b-a3b (cut to 4 layers) for 4 steps
TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS, TRAIN_SHORT_STEPS = 1024, 8, 8, 4
TRAIN_FAIL_AT, TRAIN_CKPT_EVERY, MOE_TRAIN_LAYERS = 5, 2, 4
# the training paths at full width that a card holds only cut, each cut
# applied to the published config, in the order tried.  hubert-xlarge
# whole.  llava-next-mistral-7b at the depth its two probe runs pick (the
# largest that leaves TRAIN_FREE_BYTES of TRAIN_CARD_BYTES free, its peak
# extrapolated along the probes' slope), at most the depth listed here.
# DeepSeek-V3: its 3 dense layers and one MoE layer, one whole period
# (scan_plan refuses n_layers == first_k_dense), with 32 routed experts, or
# 16 where 32 run out of memory: neither package has an expert layer that
# holds a share of the experts and routes over all of them, so the expert
# count itself is cut.  tests/test_torch_train_cuts.py holds every cut to
# the reference's scan_plan and to less than TRAIN_STATE_CAP bytes of
# params, grads and two moments counted on ``meta``, with no card.
TRAIN_CUTS = {
    "hubert-xlarge": ({},),
    "llava-next-mistral-7b": (dict(n_layers=20),),
    "deepseek-v3-671b": (dict(n_layers=4, first_k_dense=3, n_experts=32),
                         dict(n_layers=4, first_k_dense=3, n_experts=16)),
}
TRAIN_STATE_CAP = 60e9
LLAVA_PROBE_LAYERS = (2, 4)
TRAIN_CARD_BYTES, TRAIN_FREE_BYTES = 80e9, 10e9
# the same paths at smoke widths, cut as their CPU twins are
# (tests/test_torch_train_cuts.py), in f32: one train step on the card
# against the port's own step on the CPU, for the same params and batch.
# The loss, its parts and the grad norm are the same f32 sums in other
# orders: within 1e-5 relative, the twins' bound against the reference
TRAIN_SMOKE_CUTS = {
    "hubert-xlarge": {},
    "llava-next-mistral-7b": dict(n_layers=1),
    "deepseek-v3-671b": dict(n_layers=4, first_k_dense=3, n_experts=4),
}
TRAIN_F32_SEQ, TRAIN_F32_BATCH, TRAIN_F32_RTOL = 20, 2, 1e-5
# the reference's training driver's default learning rate (at 1e-3 the
# loss of qwen3-moe-30b-a3b's 4-layer cut rose from 11.1 to 19.7 at step
# 4, measured by this script on an NVIDIA H100 80GB HBM3 at 700.00 W)
TRAIN_LR = 3e-4
# the failed run's losses against the uninterrupted run's, step for step:
# the same bf16 steps on the same batches from a bit-exact restore, equal
# but for the order of any atomic adds
TRAIN_LOSS_RTOL = 1e-4
# grad_accum=2 against one step on the same batch: the same gradient, its
# bf16 products summed over other token sets (the int8 accumulator
# carries its quantisation error in f32, so it sums as the f32 one does)
ACCUM_NORM_RTOL = 5e-2
# parallel execution on rank-stacked meshes (every rank on this card):
# pipeline parallelism over (pipe=4, data=2), batch 8 x 1024 in 8
# micro-batches; its f32 check at 4 layers (one period a stage).  The bf16
# pipeline loss sums the same bf16 products in micro-batches of 1 against
# the whole batch's; the f32 bound is the reference's own
# (tests/test_multidevice.py)
PP_MESH = ((4, 2), ("pipe", "data"))
PP_BATCH, PP_SEQ, PP_MICRO, PP_CHECK_LAYERS = 8, 1024, 8, 4
PP_LOSS_RTOL, PP_CHECK_TOL = 1e-2, 1e-4
# GPipe with the stage device frozen (f32; tests/test_failover.py's bound)
GPIPE_TOL = 1e-5
# the decode and expert-parallel meshes (data=2, model=4): 8 sequences,
# qwen2's prompt of 512 and 32 ticks, DeepSeek-V3's prompt of 64 and 16
# ticks; the f32 checks (2 layers, or the smoke config) prefill 15 tokens
# and decode 4, rows 15-18 crossing from rank 1's shard of 16 to rank 2's
CP_MESH = ((2, 4), ("data", "model"))
CP_BATCH, CP_PROMPT, CP_SMAX, CP_TICKS = 8, 512, 1024, 32
CP_CHECK_LAYERS, CP_CHECK_PROMPT, CP_CHECK_TICKS, CP_CHECK_SMAX = 2, 15, 4, 64
RES_BATCH, RES_PROMPT, RES_TICKS = 8, 64, 16
# (B, S) of the flash prefills on the mesh paths (cp decode, ep mesh)
MESH_PREFILL = (CP_BATCH, CP_PROMPT)
EP_MESH_BATCH, EP_MESH_SEQ = MESH_PREFILL
# f32 bounds of the mesh paths against the meshless ones: the reference's
# own (tests/test_multidevice.py)
MESH_DECODE_TOL, EP_MESH_TOL = 1e-4, 5e-5
# compressed_psum over 4 stacked ranks; the trainer's mesh and the ranks
# its remesh loses
PSUM_RANKS = 4
TRAIN_MESH = ((4, 2), ("data", "model"))
# the params after two sharded steps (tests/test_multidevice.py)
TRAIN_MESH_PARAM_TOL = 2e-4
TRAIN_MESH_LOST, TRAIN_MESH_STEPS = 4, 2
# the attention's custom backward against autograd through attention_full
# in f32 (no TF32): the same products summed in other orders; each of out,
# dq, dk, dv within 1e-5 of its reference's largest magnitude (the CPU
# at this shape: 1.2e-6)
FLASH_BWD_RTOL = 1e-5
# the causal-skip schedule against "chunked": qwen2-0.5b's bf16 loss at
# the train phase's shape.  Both sum the same blocks below the diagonal
# (the skip schedule visits no other), the chunked one every q chunk in one
# product with its custom backward, the skip one a product per q chunk, so
# a bf16 activation may round the other way after any layer: the losses
# are held to one bf16 step (2^-7) of the loss.  In f32 at 2 layers the
# loss and every gradient are held to 1e-5.
SKIP_LOSS_RTOL = 2.0 ** -7
SKIP_F32_LAYERS, SKIP_F32_TOL = 2, 1e-5
SKIP_REPS = 1
# the port's example scripts and the line each prints last
EXAMPLES = (("torch_quickstart.py", "quickstart OK"),
            ("torch_serve_lm.py", "serve_lm OK"),
            ("torch_train_lm.py", "train_lm OK"))
EXAMPLE_TIMEOUT_S = 300
# the dry run's production cell (counted on ``meta``: seconds of host time)
DRYRUN_CELL = ("qwen2-0.5b", "train_4k")


def _load_peaks() -> None:
    global PEAK_BYTES_PER_S
    from repro_torch.launch.mesh import (HBM_BW, PEAK_FLOPS_BF16,
                                         PEAK_FLOPS_F32)
    PEAK_BYTES_PER_S = HBM_BW
    PEAK_FLOPS.update(bfloat16=PEAK_FLOPS_BF16, float32=PEAK_FLOPS_F32)


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


# A window that recorded no kernel is traced again with ``fn`` started
# later inside it, after each of these host delays (s): the card's
# timestamps can lag the host's (by up to 1.2 s, kineto's "GPU op
# timestamp < runtime timestamp" warnings on this machine), and the
# profiler drops a kernel whose timestamp falls before the window opened,
# so a short window can come back empty; a later launch is kept
TRACE_DELAYS = (0.0, 0.1, 0.5, 1.5, 3.0)


def trace(fn, cpu=True, delay=0.0):
    """Run ``fn`` once under torch.profiler, ``delay`` seconds into the
    window: (wall ms of ``fn``, the card's kernel events).  ``cpu=False``
    traces the card alone: a window of ~10^5 host operations (an autograd
    step in micro-batches) takes the profiler a minute to aggregate with
    them."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    activities = ([ProfilerActivity.CPU] if cpu else []) \
        + [ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
        time.sleep(delay)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    return wall, [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]


def _traced(fn, cpu=True, delays=TRACE_DELAYS):
    """``trace`` tried after each of ``delays`` until a window records a
    kernel; the last try's result if none did."""
    for delay in delays:
        wall, kern = trace(fn, cpu, delay)
        if sum(e.count for e in kern):
            break
    return wall, kern


def _events(fn):
    """The card's kernel events of one traced run of ``fn``; fails when
    no window recorded one."""
    kern = _traced(fn)[1]
    require(sum(e.count for e in kern) > 0, f"the profiler recorded no "
            f"kernel in {len(TRACE_DELAYS)} windows")
    return kern


def device_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time per call, without the host's launch gaps: the
    kernel time the profiler recorded over ``reps`` calls, divided by the
    calls it recorded, which are its kernel events over the events of one
    call.  A window that drops events then reads the mean of those it
    kept, not low or zero; one that recorded none fails."""
    for _ in range(warmup):
        fn()
    per_call = sum(e.count for e in _events(fn))
    kern = _events(lambda: [fn() for _ in range(reps)])
    return (sum(e.self_device_time_total for e in kern) / 1e3 * per_call
            / sum(e.count for e in kern))


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


def gmm_bound_ms(e, c, d, f, dtype_name) -> tuple:
    """(operations ms, bytes ms) for one grouped matmul on these inputs:
    2 E C d f operations against the tensor-core rate; xb and w read
    once and the output written once against the memory rate."""
    esz = 2 if dtype_name == "bfloat16" else 4
    nbytes = (e * c * d + e * d * f + e * c * f) * esz
    return (2 * e * c * d * f / PEAK_FLOPS[dtype_name] * 1e3,
            nbytes / PEAK_BYTES_PER_S * 1e3)


def _kernel_modules():
    from repro_torch.kernels import (decode_attention, flash_attention,
                                     moe_gmm, ring_allgather, ssd_scan)
    return {"flash_attention": flash_attention, "ssd_scan": ssd_scan,
            "ring_allgather": ring_allgather, "moe_gmm": moe_gmm,
            "decode_attention": decode_attention}


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


def _qkv(gen, b, hq, hkv, sq, sk, dk, dv, dtype, seq_major=False):
    """q, k, v as [B, H, S, D]; with ``seq_major`` the transposed views of
    [B, S, H, D] tensors, as the model's attention hook passes them."""
    import torch
    mk = lambda *s: torch.randn(s, generator=gen, device="cuda").to(dtype)
    if seq_major:
        return tuple(mk(b, s, h, d).transpose(1, 2) for s, h, d in
                     ((sq, hq, dk), (sk, hkv, dk), (sk, hkv, dv)))
    return mk(b, hq, sq, dk), mk(b, hkv, sk, dk), mk(b, hkv, sk, dv)


def _flash_shape_times(gen, b, hq, hkv, s, d, causal=True):
    """Device ms per call at one (B, Hq, Hkv, S, D) bf16 shape: kernel,
    plain version, SDPA, the (operations, bytes) bound, and the kernel
    with host launch gaps."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    q, k, v = _qkv(gen, b, hq, hkv, s, s, d, d, torch.bfloat16)
    launch = lambda: fa.flash_attention(q, k, v, causal=causal)
    bound = flash_bound_ms(hq, hkv, s, s, d, causal, "bfloat16")
    return (device_ms(launch),
            device_ms(lambda: fa.flash_attention_plain(q, k, v,
                                                       causal=causal)),
            device_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal, enable_gqa=True)),
            (bound[0] * b, bound[1] * b), cuda_ms(launch))


def _flash_times(gen, hq, hkv, d, lens, causal=True):
    """Mean device ms per call over ``lens`` (B = 1, bf16): kernel, plain
    version, SDPA, the bound, and the kernel with host launch gaps; and
    what bounds it."""
    rows = [_flash_shape_times(gen, 1, hq, hkv, s, d, causal) for s in lens]
    k_ms, p_ms, l_ms, b_ms, bound_by = _flash_mean([(r, 1) for r in rows])
    return (k_ms, p_ms, l_ms, b_ms, sum(r[4] for r in rows) / len(rows),
            bound_by)


def _flash_mean(entries):
    """(kernel, plain, SDPA, bound ms, what bounds it) per call, averaged
    over ``entries``, a list of (:func:`_flash_shape_times` of a shape,
    the calls at that shape); the bound of each call the larger of its
    two times."""
    n = sum(c for _, c in entries)
    mean = lambda f: sum(f(t) * c for t, c in entries) / n
    ops, nbytes = mean(lambda t: t[3][0]), mean(lambda t: t[3][1])
    return (mean(lambda t: t[0]), mean(lambda t: t[1]), mean(lambda t: t[2]),
            mean(lambda t: max(t[3])),
            "operations" if ops >= nbytes else "bytes")


def flash_row(entries, path_err, launches):
    """The flash kernel's row of the kernels line: times per launch
    averaged over every launch counted, ``entries`` a list of (the times
    at a shape, the launches at that shape)."""
    calls = sum(c for _, c in entries)
    require(calls == launches, f"flash row: {calls} launches timed, "
            f"{launches} counted")
    k_ms, p_ms, l_ms, b_ms, bound_by = _flash_mean(entries)
    return {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:28",
        "launches": launches, "max_abs_err": path_err,
        "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
        "bound_by": bound_by, "library_ms": l_ms,
    }


def phase_kernel_check(serve_lens, moe_lens):
    """Checks the flash kernel against its plain version and times it at
    the shapes its counted launches run: qwen2-0.5b's over its serve
    prompt lengths (B = 1), and B = 8 x 512 at qwen2-0.5b's (the
    context-parallel prefill) and qwen3-moe-30b-a3b's (the EP prefill).
    Returns the largest bf16 error at those shapes and {serve prompt
    length, "cp" or "ep": the times at that shape} for the kernels line.
    Also checks and times the kernel at qwen3-moe-30b-a3b's attention
    shape over ``moe_lens``, at internlm2-20b's and
    command-r-plus-104b's over ``serve_lens``, at llava-next-mistral-7b's
    over its 576 patches and 64 tokens, and at hubert-xlarge's (head dim
    80, not causal) over 1024 frames."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [(1, 14, 2, s, s, 64, 64, True, bf16) for s in CHECK_SEQS]
    cases += [(1, 14, 2, s, s, 64, 64, True, bf16)
              for s in sorted(set(serve_lens))]
    cases += [(1, 32, 4, s, s, 128, 128, True, bf16)
              for s in sorted(set(moe_lens))]
    cases += [(2, 4, 2, 64, 192, 32, 32, False, bf16),
              (1, 4, 2, 33, 77, 24, 40, False, bf16),
              (1, 4, 2, 77, 33, 24, 40, True, bf16),
              (1, 4, 2, 33, 77, 24, 40, False, f32),
              (1, 14, 2, 100, 100, 64, 64, True, f32),
              (2, 8, 8, 256, 256, 128, 128, True, f32)]
    # the model's layout: transposed views of [B, S, H, D] tensors
    strided = [(1, 14, 2, s, s, 64, 64, True, bf16) for s in (7, 100, 512)]
    strided += [(1, 32, 4, s, s, 128, 128, True, bf16) for s in (61, 441)]
    strided += [(1, 14, 2, 100, 100, 64, 64, True, f32),
                (1, 32, 4, 61, 61, 128, 128, True, f32)]
    # the mesh phases' prefills of 8 x 512 (qwen2-0.5b, qwen3-moe-30b-a3b)
    strided += [(MESH_PREFILL[0], hq, hkv, MESH_PREFILL[1],
                 MESH_PREFILL[1], d, d, True, bf16)
                for hq, hkv, d in ((14, 2, 64), (32, 4, 128))]
    # the dense, VLM and audio paths' shapes: their serve prompts, the
    # VLM's 576 + 64 rows, the encoder's 1024 frames, and the f32 checks'
    arch_shape = {}
    for arch in FLASH_ARCHS:
        c = get_config(arch)
        arch_shape[arch] = (c.n_heads, c.n_kv_heads, c.head_dim, c.causal)
    for arch in ("internlm2-20b", "command-r-plus-104b"):
        hq, hkv, d, _ = arch_shape[arch]
        cases += [(1, hq, hkv, s, s, d, d, True, bf16) for s in (7, 100, 512)]
        strided += [(1, hq, hkv, s, s, d, d, True, bf16) for s in (61, 441)]
        strided += [(1, hq, hkv, 61, 61, d, d, True, f32)]
    hq, hkv, d, _ = arch_shape["llava-next-mistral-7b"]
    vlm_len = get_config("llava-next-mistral-7b").frontend_len + LLAVA_PROMPT
    strided += [(1, hq, hkv, vlm_len, vlm_len, d, d, True, dt)
                for dt in (bf16, f32)]
    hq, hkv, d, causal = arch_shape["hubert-xlarge"]
    cases += [(1, hq, hkv, s, s, d, d, causal, bf16) for s in (100, 1024)]
    strided += [(1, hq, hkv, HUBERT_FRAMES, HUBERT_FRAMES, d, d, causal, dt)
                for dt in (bf16, f32)]
    launches0 = fa.launches
    path_err = 0.0
    for case, seq_major in ([(c, False) for c in cases]
                            + [(c, True) for c in strided]):
        (b, hq, hkv, sq, sk, dk, dv, causal, dt) = case
        q, k, v = _qkv(gen, b, hq, hkv, sq, sk, dk, dv, dt, seq_major)
        out = fa.flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        ref = fa.flash_attention_plain(q, k, v, causal=causal)
        err = (out.float() - ref.float()).abs()
        atol, rtol = TOL[str(dt).split(".")[1]]
        ok = bool((err <= atol + rtol * ref.float().abs()).all())
        log(f"flash check B={b} Hq={hq} Hkv={hkv} Sq={sq} Sk={sk} "
            f"Dk={dk} Dv={dv} causal={causal} {str(dt)[6:]}"
            f"{' strided (seq-major views)' if seq_major else ''}: "
            f"max_abs_err={err.max().item():.3e} (atol {atol}, rtol {rtol})"
            f" {'ok' if ok else 'FAIL'}")
        require(ok, "flash kernel disagrees with its plain version")
        # the shapes of the launches the kernels line counts
        if dt == bf16 and ((hq, hkv, dk) == (14, 2, 64)
                           or (b, sq) == MESH_PREFILL):
            path_err = max(path_err, err.max().item())

    # device time at the shapes the counted launches run: one (B=1,
    # Hq=14, Hkv=2, S, D=64) causal bf16 call per serve prompt length,
    # and the mesh phases' 8 x 512 prefills
    times = {s: _flash_shape_times(gen, 1, 14, 2, s, 64)
             for s in sorted(set(serve_lens))}
    n = len(serve_lens)
    k_ms, p_ms, l_ms, b_ms, bound_by = _flash_mean(
        [(times[s], 1) for s in serve_lens])
    host = sum(times[s][4] for s in serve_lens) / n
    log(f"flash device time over the {n} serve prompt lengths (mean per "
        f"call, ms): kernel {k_ms:.5f}, plain {p_ms:.5f}, sdpa {l_ms:.5f}, "
        f"bound {b_ms:.6f} ({bound_by}); kernel with host launch gaps "
        f"(CUDA events) {host:.5f}")
    b, s = MESH_PREFILL
    for key, arch, (hq, hkv, d) in (("cp", "qwen2-0.5b", (14, 2, 64)),
                                    ("ep", "qwen3-moe-30b-a3b",
                                     (32, 4, 128))):
        t = times[key] = _flash_shape_times(gen, b, hq, hkv, s, d)
        log(f"flash device time at {arch}'s {b} x {s} mesh prefill (Hq={hq}"
            f", Hkv={hkv}, D={d}; ms a call): kernel {t[0]:.5f} "
            f"({t[0] / t[2]:.2f}x sdpa), plain {t[1]:.5f}, sdpa {t[2]:.5f}, "
            f"bound {max(t[3]):.6f} "
            f"({'operations' if t[3][0] >= t[3][1] else 'bytes'}); kernel "
            f"with host launch gaps (CUDA events) {t[4]:.5f}")
    k_ms, p_ms, l_ms, b_ms, host, bound_by = _flash_times(
        gen, 32, 4, 128, moe_lens)
    log(f"flash device time at qwen3-moe-30b-a3b's attention shape (Hq=32, "
        f"Hkv=4, D=128) over the {len(moe_lens)} serve prompt lengths (mean "
        f"per call, ms): kernel {k_ms:.5f}, plain {p_ms:.5f}, sdpa "
        f"{l_ms:.5f}, bound {b_ms:.6f} ({bound_by}); kernel with host "
        f"launch gaps (CUDA events) {host:.5f}")
    for arch, lens in (("internlm2-20b", serve_lens),
                       ("command-r-plus-104b", serve_lens),
                       ("llava-next-mistral-7b", [vlm_len]),
                       ("hubert-xlarge", [HUBERT_FRAMES])):
        hq, hkv, d, causal = arch_shape[arch]
        k_ms, p_ms, l_ms, b_ms, host, bound_by = _flash_times(
            gen, hq, hkv, d, lens, causal)
        where = (f"S={lens[0]}" if len(lens) == 1
                 else f"the {len(lens)} serve prompt lengths")
        log(f"flash device time at {arch}'s attention shape (Hq={hq}, "
            f"Hkv={hkv}, D={d}, causal={causal}) over {where} "
            f"(mean per call, ms): kernel {k_ms:.5f} ({k_ms / l_ms:.2f}x "
            f"sdpa), plain {p_ms:.5f}, sdpa {l_ms:.5f}, bound {b_ms:.6f} "
            f"({bound_by}); kernel with host launch gaps (CUDA events) "
            f"{host:.5f}")
    q, k, v = _qkv(gen, 1, 14, 2, 1024, 1024, 64, 64, bf16)
    k_ms = device_ms(lambda: fa.flash_attention(q, k, v, causal=True))
    l_ms = device_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True))
    bound = max(flash_bound_ms(14, 2, 1024, 1024, 64, True, "bfloat16"))
    log(f"flash device time at S=1024 (ms): kernel {k_ms:.5f}, sdpa "
        f"{l_ms:.5f}, bound {bound:.6f}")
    log(f"flash checks and timing launched the kernel "
        f"{fa.launches - launches0} times (not counted below)")
    return path_err, times


def phase_backend_xla():
    """``backend="xla"`` on CUDA tensors: each entry point of
    ``kernels.ops`` (and ``model_kernels(cfg, backend="xla")``'s hooks)
    raises a ValueError that names its ``*_plain`` function, and launches
    no kernel: on the card a wrapper launches its kernel or raises."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.core import ranks
    from repro_torch.kernels import ops
    gen = torch.Generator(device="cuda").manual_seed(11)
    bf16 = torch.bfloat16
    rnd = lambda *shape, dt=bf16: torch.randn(  # noqa: E731
        shape, generator=gen, device="cuda").to(dt)
    q, k, v = rnd(1, 14, 64, 64), rnd(1, 2, 64, 64), rnd(1, 2, 64, 64)
    x, bm, cm = rnd(1, 64, 4, 32), rnd(1, 64, 4, 16), rnd(1, 64, 4, 16)
    dt = torch.nn.functional.softplus(rnd(1, 64, 4, dt=torch.float32))
    a = -torch.exp(rnd(4, dt=torch.float32))
    xb, w = rnd(4, 8, 64), rnd(4, 64, 32)
    r = rnd(4, 1, 1000)
    hooks = ops.model_kernels(get_config("qwen2-0.5b"), backend="xla")
    dq, dkv = rnd(2, 1, 14, 64), rnd(2, 1, 2, 64)
    dcs, dcache = rnd(2, 32, dt=torch.float32), rnd(2, 64, 2, 64)
    dlen = torch.tensor([0, 9], dtype=torch.int32, device="cuda")
    dargs = (dq, dkv, dkv, dcs, dcs, dcache, dcache, dlen)

    def ring():
        with ranks.bind_axis("r", 4):
            return ops.ring_all_gather(r, "r", axis_size=4, backend="xla")

    calls = {
        "flash_attention_plain": lambda: ops.flash_attention(
            q, k, v, causal=True, block_q=256, block_k=256, backend="xla"),
        "ssd_scan_plain": lambda: ops.ssd_scan(x, dt, a, bm, cm, chunk=256,
                                               backend="xla"),
        "moe_gmm_plain": lambda: ops.moe_gmm(xb, w, backend="xla"),
        "ring_all_gather_plain": ring,
        "flash_attention_plain (hook)": lambda: hooks["flash_attention"](
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=True, scale=0.125),
        "moe_gmm_plain (hook)": lambda: hooks["moe_gmm"](xb, w),
        "decode_attention_plain": lambda: ops.decode_attention(
            *dargs, scale=0.125, backend="xla"),
        "decode_attention_plain (hook)": lambda: hooks["decode_attention"](
            *dargs, scale=0.125, window=None),
    }
    reset_counts()
    for plain, call in calls.items():
        try:
            call()
        except ValueError as e:
            require(f"call {plain.split()[0]} " in str(e),
                    f'backend="xla" raised without naming {plain}: {e}')
        else:
            require(False, f'backend="xla" on CUDA tensors ran ({plain}): '
                    f"a wrapper must launch its kernel or raise on the card")
    counts = read_counts()
    require(not any(counts.values()),
            f'backend="xla" launched a kernel: {counts}')
    log(f'backend="xla" on CUDA tensors: {len(calls)} calls each raised '
        f"ValueError naming {sorted({p.split()[0] for p in calls})}; "
        f"kernel launches {counts}")


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


def _kernel_name(key: str) -> str:
    """A profiler key's kernel name with its template arguments, without
    the namespace and the parameter list."""
    import re
    m = re.search(r"(\w+(<[^<>]*>)?)\(", key)
    return m.group(1) if m else key[:60]


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
    cases += [(2, 300, 24, 64, 128, bf16, 1),
              (1, 100, 24, 64, 128, bf16, None),
              (1, 1024, 24, 64, 128, bf16, None),
              (2, 100, 24, 64, 128, f32, None), (2, 100, 24, 64, 128, f32, 1),
              (1, 77, 3, 40, 24, f32, None), (1, 130, 2, 128, 96, bf16, None),
              (1, 130, 4, 40, 24, bf16, 2),
              # head dim and state not multiples of 8: element-wise loads
              (1, 70, 2, 7, 5, bf16, None)]
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
        f"call, ms): kernel {row['ms']:.5f} (previous design "
        f"{SSD_OLD_MS['serve']:.5f}), plain {row['plain_ms']:.5f}, "
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
            f"(ms): kernel {k_ms:.5f} (previous design {SSD_OLD_MS[g]:.5f}"
            f"), plain {p_ms:.5f}, bound "
            f"{max(ops_ms, bytes_ms):.6f} (operations {ops_ms:.6f}, bytes "
            f"{bytes_ms:.6f})")
    # each of a call's three launches (chunk states, the pass over them,
    # the outputs) by the kernel's name, in the mixer's layout
    for s in (512, 1024):
        args = _ssd_inputs(gen, 1, s, 24, 64, 128, bf16, 1)
        reps = 20
        for _ in range(3):
            ssd.ssd_scan(*args)
        kern = _events(lambda: [ssd.ssd_scan(*args) for _ in range(reps)])
        parts = ", ".join(
            f"{_kernel_name(e.key)} "
            f"{e.self_device_time_total / 1e3 / e.count:.5f} (x{e.count})"
            for e in kern)
        log(f"ssd device time a launch at S={s}, the mixer layout (ms, mean "
            f"of {reps} calls): {parts}")
    log(f"ssd checks and timing launched the kernel "
        f"{ssd.launches - launches0} times (not counted below)")
    return row


def _gmm_case(gen, e, c, d, f, dtype):
    """Inputs of one grouped matmul: x as normed hidden states, w with
    the init's 1/sqrt(d) scale."""
    import torch
    x = torch.randn((e, c, d), generator=gen, device="cuda").to(dtype)
    w = torch.randn((e, d, f), generator=gen, device="cuda").mul_(
        d ** -0.5).to(dtype)
    return x, w


def _gmm_err(out, ref, x, w):
    """(max abs error, within the stated bound?) of ``out`` against the
    plain version's ``ref``."""
    import torch
    bound = 2 * x.shape[2] * GMM_U * torch.einsum(
        "ecd,edf->ecf", x.float().abs(), w.float().abs())
    big = torch.maximum(out.float().abs(), ref.float().abs())
    err = (out.float() - ref.float()).abs()
    ok = bool((err <= bound + GMM_ROUND[str(x.dtype)[6:]] * big).all())
    return err.max().item(), ok


def _gmm_check(gen, e, c, d, f, dtype):
    """One grouped matmul against its plain version; returns its error."""
    import torch
    from repro_torch.kernels import moe_gmm as gm
    x, w = _gmm_case(gen, e, c, d, f, dtype)
    out = gm.moe_gmm(x, w)
    torch.cuda.synchronize()
    err, ok = _gmm_err(out, gm.moe_gmm_plain(x, w), x, w)
    log(f"gmm check E={e} C={c} d={d} f={f} {str(dtype)[6:]}: "
        f"max_abs_err={err:.3e} (bound 2 d u sum|x||w| + "
        f"{GMM_ROUND[str(dtype)[6:]]} |out|) {'ok' if ok else 'FAIL'}")
    require(ok, "grouped-matmul kernel disagrees with its plain version")
    return err


def _gmm_rows_independent(gen, e, c, n, d, f):
    """Rows do not depend on the launch: each ``c``-row slice of one
    bf16 ``[e, n * c, d]`` launch equals its own launch bit for bit."""
    import torch
    from repro_torch.kernels import moe_gmm as gm
    x, w = _gmm_case(gen, e, n * c, d, f, torch.bfloat16)
    big = gm.moe_gmm(x, w)
    require(all(torch.equal(big[:, c * r:c * (r + 1)], gm.moe_gmm(
        x[:, c * r:c * (r + 1)].contiguous(), w))
        for r in range(n)), "a row of the grouped matmul depends on the "
        "other rows of its launch")
    log(f"gmm check: each {c}-row slice of one [{e}, {n * c}, {d}] bf16 "
        f"launch equals its own launch bit for bit")


def _gmm_layer_times(gen, label, e, d, f, caps):
    """{C: (kernel, plain, bmm, operations bound, bytes bound)} ms summed
    over the three bf16 projections of one MoE layer (gate and up
    [d -> f], down [f -> d]) at each capacity of ``caps``."""
    import torch
    from repro_torch.kernels import moe_gmm as gm
    times = {}
    for c in caps:
        t = [0.0] * 5
        for di, fo, n in ((d, f, 2), (f, d, 1)):
            x, w = _gmm_case(gen, e, c, di, fo, torch.bfloat16)
            row = (device_ms(lambda: gm.moe_gmm(x, w)),
                   device_ms(lambda: gm.moe_gmm_plain(x, w)),
                   device_ms(lambda: torch.bmm(x, w)),
                   *gmm_bound_ms(e, c, di, fo, "bfloat16"))
            t = [a + n * b for a, b in zip(t, row)]
            del x, w
        times[c] = tuple(t)
        k_ms, p_ms, l_ms, ops, nbytes = t
        bound = max(ops, nbytes)
        log(f"gmm device time, one {label} MoE layer's 3 projections (E={e},"
            f" d={d}, f={f}) at C={c} bf16 (ms): kernel {k_ms:.5f} "
            f"({100 * bound / k_ms:.1f}% of bound), plain {p_ms:.5f}, "
            f"torch.bmm {l_ms:.5f}, bound {bound:.6f} "
            f"({'operations' if ops >= nbytes else 'bytes'})")
    return times


def phase_gmm_check(prefill_caps, ep_cap, ds_caps, mesh_caps=()):
    """The grouped-matmul kernel against its plain version at the serving
    shapes of qwen3-moe-30b-a3b (decode C = 8, the prefills' capacities
    ``prefill_caps``, the EP phase's ep * C = 8 * ``ep_cap``; gate/up
    [2048 -> 768] and down [768 -> 2048]) and ragged ones, in bf16 and
    f32, and at deepseek-v3-671b's (256 experts, [7168 -> 2048] and back,
    C = 8 and 24); then timed at each serving capacity of both (``ds_caps``
    for deepseek-v3) and, for qwen3-moe, at the rows an expert gets in
    the mesh's expert parallelism (``mesh_caps``).  Returns qwen3-moe's
    {C: (kernel, plain, bmm, operations bound, bytes bound)} ms summed
    over the three projections of a layer, the largest bf16 error at its
    serving shapes, and deepseek-v3's times."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import moe_gmm as gm

    gen = torch.Generator(device="cuda").manual_seed(5)
    caps = sorted(set(GMM_CAPS) | set(prefill_caps))
    shapes = [(MOE_E, c, d, f) for c in caps + [EP_RANKS * ep_cap]
              for d, f in ((MOE_D, MOE_F), (MOE_F, MOE_D))]
    launches0 = gm.launches
    path_err = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for (e, c, d, f) in shapes + list(GMM_RAGGED):
            err = _gmm_check(gen, e, c, d, f, dtype)
            if dtype == torch.bfloat16 and e == MOE_E:
                path_err = max(path_err, err)
    _gmm_rows_independent(gen, MOE_E, ep_cap, EP_RANKS, MOE_D, MOE_F)
    ds = get_config("deepseek-v3-671b")
    ds_e, ds_d, ds_f = ds.n_experts, ds.d_model, ds.moe_d_ff
    for dtype in (torch.bfloat16, torch.float32):
        for c in DSV3_CAPS:
            for d, f in ((ds_d, ds_f), (ds_f, ds_d)):
                _gmm_check(gen, ds_e, c, d, f, dtype)
    _gmm_rows_independent(gen, ds_e, DSV3_CAPS[0],
                          DSV3_CAPS[1] // DSV3_CAPS[0], ds_d, ds_f)

    times = _gmm_layer_times(gen, "qwen3-moe-30b-a3b", MOE_E, MOE_D, MOE_F,
                             sorted(set(caps) | set(mesh_caps)))
    ds_times = _gmm_layer_times(gen, "deepseek-v3-671b", ds_e, ds_d, ds_f,
                                sorted(set(ds_caps)))
    log(f"gmm checks and timing launched the kernel "
        f"{gm.launches - launches0} times (not counted below)")
    return times, path_err, ds_times


def gmm_row(entries, path_err, launches):
    """The grouped matmul's row of the kernels line: times per launch,
    averaged over every launch counted, ``entries`` a list of (one MoE
    layer's (kernel, plain, bmm, operations bound, bytes bound) ms at its
    shape, the MoE layer calls at that shape)."""
    calls = sum(n for _, n in entries)
    require(3 * calls == launches, f"gmm row: {3 * calls} launches timed, "
            f"{launches} counted")
    mean = lambda i: sum(t[i] * n for t, n in entries) / (3 * calls)
    return {
        "name": "moe_gmm", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/moe_gmm.cu",
        "replaces": "src/repro/kernels/moe_gmm.py:19",
        "launches": launches, "max_abs_err": path_err,
        "ms": mean(0), "plain_ms": mean(1),
        "bound_ms": max(mean(3), mean(4)),
        "bound_by": "operations" if mean(3) >= mean(4) else "bytes",
        "library_ms": mean(2),
    }


# the decode-attention kernel's checked shapes: (label, slots, Smax, KV
# heads, query heads a KV head, head dim, window, share of slots free)
DECODE_CASES = (
    ("internlm2-chat", 32, 1185, 8, 6, 128, None, 0.0),
    ("internlm2-code", 24, 6187, 8, 6, 128, None, 0.5),
    ("starcoder2 window", 8, 6187, 4, 9, 128, 4096, 0.0),
    ("qwen2 hd 64", 8, 1024, 2, 7, 64, None, 0.25),
    ("command-r-plus G 12", 8, 1024, 8, 12, 128, None, 0.25),
)


def decode_bound_ms(b, hq, hkv, hd, rows) -> tuple:
    """(operations ms, bytes ms) for one decode-attention launch: the two
    products over each slot's ``rows`` valid rows against the tensor-core
    rate; those rows of K and V, q, k_new, v_new, cos, sin and the lengths
    read once, the output and the two cache rows written once against the
    memory rate."""
    nbytes = (4 * hkv * hd * rows + 2 * b * hq * hd * 2
              + 2 * b * hkv * hd * 2 * 2 + b * hd * 4 + b * 4)
    return (4 * hq * hd * rows / PEAK_FLOPS["bfloat16"] * 1e3,
            nbytes / PEAK_BYTES_PER_S * 1e3)


def phase_decode_check():
    """The decode-attention kernel against its plain version at
    ``DECODE_CASES``: random bf16 q, new rows and caches (every row
    filled, so a row read past a slot's length shows), lengths of free
    slots (0), one row, Smax - 1 and random ones.  The caches after the
    call must be equal bit for bit (the same f32 RoPE, rounded once, in
    the same row); the outputs within ``TOL["bfloat16"]``: the kernel
    rounds p to bf16 before dividing by the row sum, the plain version
    after, and the two sum in another order, so they may land one bf16
    step apart.  Each is also held against ``ref.decode_attention_ref``
    (f32, a slot at a time).  Then each shape is timed: the kernel, the
    plain version, and ``F.scaled_dot_product_attention`` over the same
    rows (the attention alone, on roped q and the written cache) as the
    library yardstick.  Returns the kernels line's row."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ref
    from repro_torch.models.common import apply_rope, rope_cos_sin

    gen = torch.Generator(device="cuda").manual_seed(5)
    bf16 = torch.bfloat16
    rnd = lambda *shape: torch.randn(shape, generator=gen,  # noqa: E731
                                     device="cuda").to(bf16)
    shapes, worst = {}, 0.0
    launches0 = da.launches
    for label, b, smax, hkv, g, hd, window, free in DECODE_CASES:
        rng = np.random.default_rng(smax + g)
        lens = rng.integers(0, smax - 1, b)
        lens[:3] = (0, 1, smax - 1)
        lens[3:3 + int(free * b)] = 0
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        hq, scale = hkv * g, hd ** -0.5
        q, k_new, v_new = rnd(b, 1, hq, hd), rnd(b, 1, hkv, hd), \
            rnd(b, 1, hkv, hd)
        cos, sin = rope_cos_sin(lengths, hd, 1e6)
        kc, vc = rnd(b, smax, hkv, hd), rnd(b, smax, hkv, hd)
        caches = {n: (kc.clone(), vc.clone()) for n in ("kernel", "plain")}
        args = lambda n: (q, k_new, v_new, cos, sin) + caches[n] + (lengths,)
        got = da.decode_attention(*args("kernel"), scale=scale, window=window)
        want = da.decode_attention_plain(*args("plain"), scale=scale,
                                         window=window)
        torch.cuda.synchronize()
        exact, _, _ = ref.decode_attention_ref(q, k_new, v_new, cos, sin, kc,
                                               vc, lengths, scale=scale,
                                               window=window)
        same = all(torch.equal(a, c) for a, c in
                   zip(caches["kernel"], caches["plain"]))
        err = float((got.float() - want.float()).abs().max())
        err_k = float((got.float() - exact.float()).abs().max())
        err_p = float((want.float() - exact.float()).abs().max())
        atol, rtol = TOL["bfloat16"]
        ok = same and bool(torch.allclose(got.float(), want.float(),
                                          atol=atol, rtol=rtol))
        worst = max(worst, err)
        lo = np.maximum(0, lens - window + 1) if window else 0
        rows = int((np.minimum(lens, smax - 1) - lo + 1).sum())
        log(f"decode check: {label}: B {b}, Smax {smax}, Hq {hq}, Hkv {hkv}, "
            f"hd {hd}, window {window}, lengths {sorted(lens.tolist())[:4]}"
            f"..{int(lens.max())} ({rows} valid rows): caches equal {same}, "
            f"max |kernel - plain| {err:.3e}, against f32: kernel "
            f"{err_k:.3e}, plain {err_p:.3e} {'ok' if ok else 'FAIL'}")
        require(ok, f"decode check {label}: caches equal {same}, max abs "
                f"error {err}")
        qr = apply_rope(q, cos[:, None], sin[:, None]).transpose(1, 2)
        kpos = torch.arange(smax, device="cuda")
        mask = (kpos[None] <= lengths[:, None].long()) & (
            kpos[None] > lengths[:, None].long() - (window or smax + 1))
        kt, vt = (t.transpose(1, 2) for t in caches["kernel"])
        times = (device_ms(lambda: da.decode_attention(
                     *args("kernel"), scale=scale, window=window)),
                 device_ms(lambda: da.decode_attention_plain(
                     *args("plain"), scale=scale, window=window)),
                 device_ms(lambda: F.scaled_dot_product_attention(
                     qr, kt, vt, attn_mask=mask[:, None, None], scale=scale,
                     enable_gqa=True)))
        ops_ms, bytes_ms = decode_bound_ms(b, hq, hkv, hd, rows)
        bound = max(ops_ms, bytes_ms)
        shapes[label] = {
            "ms": times[0], "plain_ms": times[1], "library_ms": times[2],
            "bound_ms": bound,
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "roofline_pct": 100 * bound / times[0], "valid_rows": rows}
        log(f"decode device time a launch: {label}: kernel {times[0]:.5f} "
            f"ms, plain {times[1]:.5f} ms, SDPA {times[2]:.5f} ms, bound "
            f"{bound:.6f} ms ({shapes[label]['bound_by']}; "
            f"{100 * bound / times[0]:.1f}% of it); card {smi()}")
        del caches, kc, vc
    log(f"decode check: {len(DECODE_CASES)} shapes; the kernel launched "
        f"{da.launches - launches0} times (not counted below)")
    return {"name": "decode_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
            "replaces": None, "max_abs_err": worst, "shapes": shapes}


def _prompts(vocab):
    import numpy as np
    rng = np.random.default_rng(0)
    lens = [int(x) for x in rng.integers(32, 513, SERVE_REQUESTS)]
    if not any(is_prime(x) for x in lens):
        lens[-1] = 509
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lens]


def _profiled(label, fn, n_kernels=6, cpu=True):
    """Print ``fn``'s wall time, the device's busy and idle share,
    launches, and the kernels that took the most device time."""
    wall, kern = _traced(fn, cpu, TRACE_DELAYS[:3])
    busy = sum(e.self_device_time_total for e in kern) / 1e3
    launches = sum(e.count for e in kern)
    if not launches:
        log(f"profile {label}: busy share not measured (the profiler "
            f"recorded no kernel in 3 windows)")
        return
    log(f"profile {label}: wall {wall:.3f} ms, device busy {busy:.3f} ms "
        f"({100 * busy / wall:.1f}%), idle {100 * (1 - busy / wall):.1f}%, "
        f"{launches} kernel launches; card {smi()}")
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


SYNC_MSG = "synchronizing CUDA operation"


def _sync_free(label, fn):
    """``fn()`` under CUDA's sync debug mode "error".  A synchronizing
    call inside it (one that makes the host wait for the card) is logged
    with the port's line that made it, and ``fn`` runs again under "warn"
    to log every such line; nothing fails.  Returns ``fn()``."""
    import traceback
    import warnings
    import torch
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = fn()
        log(f"sync check: {label}: no synchronizing call")
        return out
    except RuntimeError as e:
        if SYNC_MSG not in str(e):
            raise
        first = [f"{Path(f.filename).name}:{f.lineno}"
                 for f in traceback.extract_tb(e.__traceback__)
                 if "repro_torch" in f.filename][-1:]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    every = sorted({f"{w.filename}:{w.lineno}" for w in seen
                    if SYNC_MSG in str(w.message)})
    log(f"sync check: {label}: synchronizing call at {first}; every one: "
        f"{every}")
    return out


def phase_sync_check(cfg, params, kernels, prompt):
    """One prefill and one decode tick of ``cfg`` with the engine's two
    dispatch spans (``prefill.dispatch``: ``_dispatch_prefill``,
    ``decode.dispatch``: ``_dispatch_decode``) run through
    ``_sync_free``: a synchronizing call inside one would make the span
    hold time spent waiting for the card."""
    from repro_torch.serving import Request, ServeConfig, ServingEngine
    eng = ServingEngine(cfg, params, ServeConfig(
        n_slots=2, max_seq=len(prompt) + 4, max_new_tokens=2),
        kernels=kernels)
    for name in ("_dispatch_prefill", "_dispatch_decode"):
        fn = getattr(eng, name)
        setattr(eng, name, lambda *a, _fn=fn, _n=name: _sync_free(
            f"{cfg.name} {_n[1:]}", lambda: _fn(*a)))
    eng.submit(Request(rid=0, prompt=prompt))
    done = eng.run_until_drained()
    require(len(done) == 1 and not eng.failed and len(done[0].output) == 2
            and eng.stats["ticks"] == 1,
            f"sync check: {[r.error for r in eng.failed]}, {eng.stats}")


def trace_cost(ticks=500, rounds=20, n_slots=8):
    """Host microseconds the engine's trace costs a served tick.  The
    real ``ServingEngine.tick`` runs a two-layer model on the CPU with
    its two dispatch methods stubbed to hand back fixed tokens, so that a
    tick holds only the engine's own code: the executor, an admission,
    a decode of ``n_slots - 1`` live slots, the bookkeeping and the
    spans.  One request is submitted before each tick.  Engines with
    the trace on and with ``trace=False`` take turns, ``rounds`` of
    each, a new engine each round (the executor's retained graph grows
    over a run).  Returns (enabled, disabled: the median of the rounds'
    means, spans a tick)."""
    import statistics
    import numpy as np
    import torch
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models import init_model
    from repro_torch.serving import Request, ServeConfig, ServingEngine

    cfg = ModelConfig(name="trace-cost", n_layers=2, d_model=64, n_heads=4,
                      n_kv_heads=2, d_ff=128, vocab=211,
                      dtype=torch.float32, param_dtype=torch.float32)
    params = init_model(torch.Generator().manual_seed(0), cfg, device="cpu")
    first = torch.ones(1, dtype=torch.int32)
    step = torch.ones(n_slots, dtype=torch.int32)
    prompt = np.arange(8, dtype=np.int32)
    warm = n_slots

    def run(trace):
        eng = ServingEngine(cfg, params, ServeConfig(
            n_slots=n_slots, max_seq=64, max_new_tokens=n_slots),
            device="cpu", trace=trace)
        eng._dispatch_prefill = lambda prompt, slot: first
        eng._dispatch_decode = lambda tokens, lengths: step
        for k in range(warm + ticks):
            if k == warm:
                t, opened = time.perf_counter(), eng.trace.opened
            eng.submit(Request(rid=k, prompt=prompt))
            eng.tick()
        require(not eng.failed and not eng.queue,
                f"trace cost: {eng.stats}")
        return ((time.perf_counter() - t) / ticks * 1e6,
                (eng.trace.opened - opened) / ticks)

    on, off = [], []
    for _ in range(rounds):
        on.append(run(True))
        off.append(run(False)[0])
    return (statistics.median(u for u, _ in on), statistics.median(off),
            on[-1][1])


def phase_trace_cost():
    """The engine's trace cost a tick on this machine's host."""
    on, off, spans = trace_cost()
    log(f"trace cost: {on - off:.2f} us a tick of {spans:.0f} spans "
        f"({on:.2f} us enabled, {off:.2f} us disabled: the engine's own "
        f"code, dispatch stubbed, medians of 20 rounds of 500 ticks); card "
        f"{smi()}")


def expected_launches(cfg, prefills, ticks=0) -> dict:
    """Each kernel's launches in a run of ``prefills`` prefills (or
    full-sequence forwards: an encoder's ``apply_model`` is one) and
    ``ticks`` decode ticks: flash and SSD once per prefill and layer of
    their kind (Mamba decode is plain PyTorch, as in the reference), flash
    only for a config without a sliding window (``model_kernels`` gives a
    windowed config no flash hook) and never in an MLA layer (the
    reference gives MLA no flash hook), causal or not; the grouped matmul
    once per expert projection (3) of every MoE layer in every prefill and
    decode tick; decode attention once per GQA layer and decode tick where
    ``model_kernels`` gives its hook (``decode_attention.takes``)."""
    from repro_torch.kernels import decode_attention
    plan = cfg.layer_plan()
    flash = 0 if cfg.sliding_window else 1
    decode = ticks if decode_attention.takes(cfg) else 0
    return {"flash_attention": flash * prefills * sum(l.mixer == "attn"
                                                      for l in plan),
            "ssd_scan": prefills * sum(l.mixer == "mamba" for l in plan),
            "ring_allgather": 0,
            "moe_gmm": 3 * (prefills + ticks) * sum(l.ffn == "moe"
                                                    for l in plan),
            "decode_attention": decode * sum(l.mixer == "attn"
                                             for l in plan)}


class _RecordRoutes:
    """Record the expert ids of every decode tick's routing (``x`` of
    ``n_slots`` rows) in the block, without a host sync; ``distinct()``
    counts the experts each MoE layer's tick chose."""

    def __init__(self, n_slots):
        self.n_slots, self.ids = n_slots, []

    def __enter__(self):
        from repro_torch.models import moe
        self._moe, self._route = moe, moe.route

        def route(cfg, router_p, x):
            out = self._route(cfg, router_p, x)
            if x.shape[0] == self.n_slots:
                self.ids.append(out[0])
            return out

        moe.route = route
        return self

    def __exit__(self, *exc):
        self._moe.route = self._route

    def distinct(self):
        return [int(i.unique().numel()) for i in self.ids]


def phase_serve(arch, prompts, cut=None, then=None, **overrides):
    """Serve ``prompts`` at ``arch``'s full width; ``overrides`` cut the
    config's depth where the whole model does not fit the card, and
    ``cut`` says so.  ``then(cfg, params)``, a phase of its own, runs
    after on the same params (drawing a second copy of a 55-61 GB model
    would cost the time again and need the card's whole memory free).
    Returns the launch counts of the run, each request's tokens, the
    engine's stats and what ``then`` returned."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import model_kernels
    from repro_torch.models import init_model
    from repro_torch.models.common import param_bytes, param_count
    from repro_torch.serving import Request, ServeConfig, ServingEngine

    full = get_config(arch)
    cfg = dataclasses.replace(full, **overrides)
    torch.cuda.reset_peak_memory_stats()
    params = init_model(torch.Generator(device="cuda").manual_seed(0), cfg,
                        device="cuda")
    depth = (f"{cfg.n_layers} layers" if cfg.n_layers == full.n_layers
             else f"cut to {cfg.n_layers} of {full.n_layers} layers "
                  f"({cut})")
    log(f"serve: {cfg.name} full width, {depth}, "
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
    with _RecordRoutes(SERVE_SLOTS) as routes:
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
    # only a windowed config (no flash hook) may serve with no kernel
    want = expected_launches(cfg, eng.stats["prefills"], eng.stats["ticks"])
    require(counts == want and (any(want.values()) or cfg.sliding_window),
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
        f"launches {counts} for {eng.stats['prefills']} prefills and "
        f"{eng.stats['ticks']} decode ticks of {cfg.n_layers} layers; "
        f"card {smi()}")
    moe_layers = sum(l.ffn == "moe" for l in cfg.layer_plan())
    if moe_layers:
        chosen = routes.distinct()
        read = 3 * moe_layers * cfg.n_experts * cfg.d_model * cfg.moe_d_ff \
            * torch.empty((), dtype=cfg.param_dtype).element_size()
        log(f"serve: {cfg.name} decode ticks chose {min(chosen)}-"
            f"{max(chosen)} of {cfg.n_experts} experts a MoE layer (mean "
            f"{sum(chosen) / len(chosen):.1f} over {len(chosen)} layer "
            f"ticks; at most {SERVE_SLOTS} slots x top-"
            f"{cfg.n_experts_per_tok}); the grouped matmul reads all "
            f"{cfg.n_experts} experts' weights, {read} bytes a tick")
    phase_profile(cfg, params, kernels, prompts)
    phase_sync_check(cfg, params, kernels, prompts[0])
    tokens, stats = {r.rid: list(r.output) for r in done}, eng.stats
    after = None
    if then is not None:
        del eng, done
        release()
        after = then(cfg, params)
    return counts, tokens, stats, after


def _greedy(cfg, params, prompt, n_new):
    """The engine's greedy tokens for ``prompt`` (and the launch counts
    and decode ticks of that run), then token-by-token
    ``apply_model``'s."""
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
    ticks = eng.stats["ticks"]
    toks = [int(t) for t in prompt]
    for _ in range(n_new):
        with torch.no_grad():
            lg = apply_model(cfg, params,
                             torch.as_tensor(toks, device="cuda")[None],
                             kernels=kernels)[0]
        toks.append(int(torch.argmax(lg[0, -1])))
    return out, toks[len(prompt):], counts, ticks


def phase_greedy(arch, prompts, **overrides):
    """``overrides`` cut the config (depth, capacity factor); each is
    printed."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.models import init_model

    full = get_config(arch)
    cfg = dataclasses.replace(full, dtype=torch.float32,
                              param_dtype=torch.float32, **overrides)
    log(f"greedy: dtype override {cfg.name} -> float32 (params and "
        f"activations), allow_tf32={torch.backends.cuda.matmul.allow_tf32}"
        f"; {cfg.n_layers} of {full.n_layers} layers; overrides "
        f"{overrides}")
    params = init_model(torch.Generator(device="cuda").manual_seed(0), cfg,
                        device="cuda")
    prompt = next(p for p in prompts if is_prime(len(p)))[:61]
    out, ref, counts, ticks = _greedy(cfg, params, prompt, 16)
    want = expected_launches(cfg, 1, ticks)
    log(f"greedy: {cfg.name} prompt {len(prompt)} tokens; engine {out}; "
        f"apply_model {ref}; engine launches {counts} (expected {want}, "
        f"{ticks} decode ticks)")
    require(counts == want, f"greedy launches {counts}, expected {want}")
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
    out, ref, counts, ticks = _greedy(cfg, params, prompt, 16)
    want = expected_launches(cfg, 1, ticks)
    log(f"hybrid: prompt {len(prompt)} tokens; engine {out}; apply_model "
        f"{ref}; engine launches {counts} (expected {want})")
    require(counts == want and want["flash_attention"] and want["ssd_scan"],
            f"hybrid launches {counts}, expected {want}")
    require(out == ref, "hybrid engine diverged from token-by-token "
            "apply_model")
    log("hybrid: consistent")


def phase_hybrid_moe(prompts):
    """Jamba's layer plan (attention at offset 4 of a period of 8, experts
    every second layer at offset 1, dense FFNs between) at mamba2-130m's
    SSM widths, cut to 8 layers: d_model 768, 16 experts, top-2, expert
    width 2048, capacity factor 8, float32.  A check of the layer plan,
    not a published model: flash, SSD and the grouped matmul must all
    launch, and the greedy check must hold."""
    import torch
    from repro_torch.configs.base import ModelConfig, get_config
    from repro_torch.models import init_model

    m = get_config("mamba2-130m")
    j = get_config("jamba-1.5-large-398b")
    cfg = ModelConfig(
        name="hybrid-moe-check", family="hybrid", n_layers=8, d_model=768,
        n_heads=12, n_kv_heads=4, d_ff=2048, vocab=m.vocab,
        attn_layer_period=j.attn_layer_period,
        attn_layer_offset=j.attn_layer_offset, n_experts=16,
        n_experts_per_tok=j.n_experts_per_tok, moe_d_ff=2048,
        expert_layer_period=j.expert_layer_period,
        expert_layer_offset=j.expert_layer_offset, capacity_factor=8.0,
        ssm_state=m.ssm_state, ssm_expand=m.ssm_expand,
        ssm_head_dim=m.ssm_head_dim, ssm_groups=m.ssm_groups,
        ssm_conv=m.ssm_conv, ssm_chunk=m.ssm_chunk, dtype=torch.float32,
        param_dtype=torch.float32)
    plan = " ".join(("a" if l.mixer == "attn" else "m")
                    + ("E" if l.ffn == "moe" else "d")
                    for l in cfg.layer_plan())
    log(f"hybrid moe: a check of the layer plan, not a published model: "
        f"{cfg.n_layers} layers ({plan}; a/m attention or Mamba, E/d "
        f"experts or dense FFN), d_model {cfg.d_model}, {cfg.n_experts} "
        f"experts top-{cfg.n_experts_per_tok} of width {cfg.moe_d_ff}, "
        f"capacity factor {cfg.capacity_factor}, SSM state "
        f"{cfg.ssm_state} x {cfg.ssm_heads} heads of {cfg.ssm_head_dim}, "
        f"float32")
    params = init_model(torch.Generator(device="cuda").manual_seed(0), cfg,
                        device="cuda")
    prompt = next(p for p in prompts if is_prime(len(p)))[:61]
    out, ref, counts, ticks = _greedy(cfg, params, prompt, 16)
    want = expected_launches(cfg, 1, ticks)
    log(f"hybrid moe: prompt {len(prompt)} tokens; engine {out}; "
        f"apply_model {ref}; engine launches {counts} (expected {want}, "
        f"{ticks} decode ticks)")
    require(counts == want and all(
        want[k] for k in ("flash_attention", "ssd_scan", "moe_gmm")),
        f"hybrid moe launches {counts}, expected {want}")
    require(out == ref, "hybrid moe engine diverged from token-by-token "
            "apply_model")
    log("hybrid moe: consistent")


def phase_llava(prompt):
    """The vision frontend of llava-next-mistral-7b.  At full width and
    depth in bf16: one ``prefill`` with 576 random patch embeddings ahead
    of a 64-token prompt, then 16 greedy ``decode_step``s, timed, with
    one flash launch per layer.  In f32 cut to 4 layers: prefill with the
    same embeddings, then greedy decode, against token-by-token
    ``apply_model(frontend_embeds=)``."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import model_kernels
    from repro_torch.models import (apply_model, decode_step, init_cache,
                                    init_model, prefill)
    from repro_torch.models.common import param_bytes, param_count

    full = get_config("llava-next-mistral-7b")
    toks = torch.as_tensor(prompt[:LLAVA_PROMPT], device="cuda")[None]
    # patch embeddings at the token embeddings' scale (std 0.02)
    patches = 0.02 * torch.randn(
        (1, full.frontend_len, full.d_model), device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(7))
    rows = full.frontend_len + LLAVA_PROMPT

    def run(cfg, params):
        """prefill + greedy decode: (tokens, prefill ms, decode ms each)."""
        kernels = model_kernels(cfg)
        caches = init_cache(cfg, 1, rows + LLAVA_NEW, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, caches = prefill(cfg, params, toks, caches,
                             frontend_embeds=patches, kernels=kernels)
        out = [int(torch.argmax(lg[0, -1]))]
        pre = (time.perf_counter() - t0) * 1e3
        dec = []
        for i in range(LLAVA_NEW - 1):
            t0 = time.perf_counter()
            lg, caches = decode_step(
                cfg, params, torch.tensor([[out[-1]]], device="cuda"),
                caches, rows + i, kernels=kernels)
            out.append(int(torch.argmax(lg[0, -1])))
            dec.append((time.perf_counter() - t0) * 1e3)
        require(bool(torch.isfinite(lg).all()), "non-finite logits")
        return out, pre, dec

    torch.cuda.reset_peak_memory_stats()
    params = init_model(torch.Generator(device="cuda").manual_seed(0), full,
                        device="cuda")
    run(full, params)                       # warm-up
    reset_counts()
    out, pre, dec = run(full, params)
    counts = read_counts()
    want = expected_launches(full, 1, LLAVA_NEW - 1)
    require(counts == want and want["flash_attention"] == full.n_layers,
            f"llava launches {counts}, expected {want}")
    log(f"llava: {full.name} full width and depth ({full.n_layers} layers, "
        f"{param_count(params)} params, {param_bytes(params)} bytes, "
        f"{str(full.dtype)[6:]}): "
        f"prefill of {full.frontend_len} patch embeddings + "
        f"{LLAVA_PROMPT} tokens {pre:.3f} ms, {LLAVA_NEW - 1} decode steps "
        f"mean {sum(dec) / len(dec):.3f} ms ({1e3 / (sum(dec) / len(dec)):.1f}"
        f" tokens/s); max_memory_allocated "
        f"{torch.cuda.max_memory_allocated()} bytes; launches {counts}; "
        f"tokens {out}; card {smi()}")
    del params
    release()

    cfg = dataclasses.replace(full, n_layers=FRONTEND_CHECK_LAYERS,
                              dtype=torch.float32, param_dtype=torch.float32)
    params = init_model(torch.Generator(device="cuda").manual_seed(0), cfg,
                        device="cuda")
    reset_counts()
    out, _, _ = run(cfg, params)
    counts = read_counts()
    seq = toks[0].tolist()
    ref = []
    for _ in range(LLAVA_NEW):
        with torch.no_grad():
            lg = apply_model(cfg, params,
                             torch.as_tensor(seq, device="cuda")[None],
                             frontend_embeds=patches,
                             kernels=model_kernels(cfg))[0]
        ref.append(int(torch.argmax(lg[0, -1])))
        seq.append(ref[-1])
    log(f"llava greedy: {cfg.name} f32, depth cut to {cfg.n_layers} of "
        f"{full.n_layers} layers; prefill + decode {out}; apply_model "
        f"{ref}; prefill launches {counts}")
    require(counts == expected_launches(cfg, 1),
            f"llava f32 launches {counts}")
    require(out == ref, "llava prefill + decode diverged from token-by-token "
            "apply_model with the same patch embeddings")
    log("llava greedy: consistent")


def phase_hubert():
    """The audio encoder of hubert-xlarge.  At full width and depth in
    bf16: ``apply_model`` on 1024 random frame embeddings through the
    non-causal flash kernel (one launch per layer), timed and profiled.
    In f32 cut to 4 layers: its logits against the same forward with
    plain attention (``kernels=None``), within ``TOL["float32"]`` times
    the layers, since each layer's attention adds its own rounding
    difference."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import model_kernels
    from repro_torch.models import apply_model, init_model
    from repro_torch.models.common import param_bytes, param_count

    full = get_config("hubert-xlarge")
    frames = torch.randn((1, HUBERT_FRAMES, full.d_model), device="cuda",
                         generator=torch.Generator(device="cuda")
                         .manual_seed(8))
    torch.cuda.reset_peak_memory_stats()
    params = init_model(torch.Generator(device="cuda").manual_seed(0), full,
                        device="cuda")
    kernels = model_kernels(full)

    def forward():
        with torch.no_grad():
            return apply_model(full, params, None, frontend_embeds=frames,
                               kernels=kernels)[0]

    forward()                               # warm-up
    reset_counts()
    lg, ms = _host_ms(forward)
    counts = read_counts()
    want = expected_launches(full, 1)
    require(counts == want and want["flash_attention"] == full.n_layers,
            f"hubert launches {counts}, expected {want}")
    require(tuple(lg.shape) == (1, HUBERT_FRAMES, full.vocab)
            and bool(torch.isfinite(lg).all()), f"logits {tuple(lg.shape)}")
    log(f"hubert: {full.name} full width and depth ({full.n_layers} layers, "
        f"{param_count(params)} params, {param_bytes(params)} bytes, "
        f"{str(full.dtype)[6:]}, "
        f"causal={full.causal}): apply_model on [1, {HUBERT_FRAMES}, "
        f"{full.d_model}] frames {ms:.3f} ms ({HUBERT_FRAMES / ms * 1e3:.0f} "
        f"frames/s); max_memory_allocated "
        f"{torch.cuda.max_memory_allocated()} bytes; launches {counts}; "
        f"card {smi()}")
    _profiled(f"{full.name} forward of {HUBERT_FRAMES} frames", forward)
    del params, lg
    release()

    cfg = dataclasses.replace(full, n_layers=FRONTEND_CHECK_LAYERS,
                              dtype=torch.float32, param_dtype=torch.float32)
    params = init_model(torch.Generator(device="cuda").manual_seed(0), cfg,
                        device="cuda")
    reset_counts()
    with torch.no_grad():
        got = apply_model(cfg, params, None, frontend_embeds=frames,
                          kernels=model_kernels(cfg))[0]
        counts = read_counts()
        ref = apply_model(cfg, params, None, frontend_embeds=frames)[0]
    atol, rtol = (t * cfg.n_layers for t in TOL["float32"])
    err = (got - ref).abs()
    ok = bool((err <= atol + rtol * ref.abs()).all())
    log(f"hubert check: {cfg.name} f32, depth cut to {cfg.n_layers} of "
        f"{full.n_layers} layers, non-causal flash kernel vs plain "
        f"attention: logits max_abs_err={err.max().item():.3e} (atol {atol:g}"
        f", rtol {rtol:g}; max |logit| {ref.abs().max().item():.3f}); "
        f"launches {counts} {'ok' if ok else 'FAIL'}")
    require(counts == expected_launches(cfg, 1), f"hubert f32 launches "
            f"{counts}")
    require(ok, "hubert's forward with the flash kernel disagrees with "
            "plain attention")


class _RecordRuntimes:
    """Record the LCX runtimes made inside the block (the expert-parallel
    body makes a private one), to read their devices' stats."""

    def __enter__(self):
        import repro_torch.core as lcx
        self.made, self._lcx, base = [], lcx, lcx.Runtime
        made = self.made

        class Recording(base):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                made.append(self)

        self._base, lcx.Runtime = base, Recording
        return self

    def __exit__(self, *exc):
        self._lcx.Runtime = self._base


def phase_ep():
    """LCX expert-parallel dispatch of one qwen3-moe-30b-a3b MoE layer at
    full width in bf16: 8 ranks of 512 tokens stacked on the card through
    ``_moe_ep_shard`` with the native and the pairwise all-to-all; every
    rank's output and aux bit-equal to ``_moe_sort_local`` on that rank's
    tokens with the same kernel (both take the capacity of 512 tokens, so
    they drop the same ones)."""
    import torch
    import repro_torch.core as lcx
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import moe_gmm as gm
    from repro_torch.kernels import ops
    from repro_torch.models import moe

    cfg = get_config("qwen3-moe-30b-a3b")
    gen = torch.Generator(device="cuda").manual_seed(6)
    p = moe.moe_init(gen, cfg, torch.device("cuda"))
    x = torch.randn((EP_RANKS, EP_TOKENS, cfg.d_model), generator=gen,
                    device="cuda").to(cfg.dtype)
    C = moe.capacity(cfg, EP_TOKENS)
    local = [moe._moe_sort_local(cfg, p, x[r], kernel_fn=ops.moe_gmm)
             for r in range(EP_RANKS)]
    ids = moe.route(cfg, p["router"], x[0])[0]
    dropped = int((torch.bincount(ids.reshape(-1), minlength=cfg.n_experts)
                   - C).clamp_min(0).sum())
    log(f"ep: {cfg.name} MoE layer ({cfg.n_experts} experts top-"
        f"{cfg.n_experts_per_tok}, "
        f"{3 * cfg.n_experts * cfg.d_model * cfg.moe_d_ff} expert params, "
        f"{str(cfg.param_dtype)[6:]}), {EP_RANKS} ranks x {EP_TOKENS} tokens, "
        f"capacity {C} a rank ({EP_RANKS * C} rows an expert after the "
        f"all-to-all); rank 0 drops {dropped} of "
        f"{ids.numel()} assignments")
    for backend in ("native", "pairwise"):
        with lcx.ranks.bind_axis("ep", EP_RANKS), _RecordRuntimes() as rec:
            before = gm.launches
            (y, aux), ms = _host_ms(lambda: moe._moe_ep_shard(
                cfg, p, x, "ep", backend, kernel_fn=ops.moe_gmm))
            launched = gm.launches - before
        require(len(rec.made) == 1, f"{len(rec.made)} runtimes made")
        stats = [d.stats["transfers"] for d in rec.made[0].devices()]
        want = 2 * (EP_RANKS - 1) if backend == "pairwise" else 0
        require(sum(stats) == want and launched == 3,
                f"ep {backend}: transfers {stats} (expected {want}), gmm "
                f"launches {launched}")
        require(all(torch.equal(y[r], local[r][0])
                    and torch.equal(aux[r], local[r][1])
                    for r in range(EP_RANKS)),
                f"ep {backend}: a rank differs from its sort-path MoE")
        log(f"ep {backend}: host {ms:.3f} ms; Device.stats transfers "
            f"{stats}; gmm launches {launched} (one per projection over "
            f"[{cfg.n_experts}, {EP_RANKS * C}, d]); every rank's output "
            f"and aux equal its sort-path MoE bit for bit")
        del y, aux
    del p, x, local


def ring_bound_ms(n, shard_bytes) -> float:
    """Least time of a ring all-gather: n * S bytes read and n * n * S
    written, against the memory rate (it does no arithmetic)."""
    return (n * shard_bytes + n * n * shard_bytes) / PEAK_BYTES_PER_S * 1e3


def _ring_library(x):
    """The one PyTorch call that computes the same function."""
    n = x.shape[0]
    return x[:, 0].unsqueeze(0).expand((n,) + tuple(x[:, 0].shape)) \
        .contiguous()


def _ring_input(gen, n, nbytes, dt, offset=0):
    """Random ``[n, 1, nbytes / esz]`` of ``dt``; with ``offset``, a
    contiguous view that starts ``offset`` bytes into a larger buffer."""
    import torch
    esz = torch.empty((), dtype=dt).element_size()
    src = torch.randint(-2 ** 15, 2 ** 15, (n, 1, nbytes // esz),
                        generator=gen, device="cuda").to(dt)
    if not offset:
        return src
    buf = torch.empty(n * nbytes + offset, dtype=torch.uint8, device="cuda")
    x = buf[offset:].view(dt).view(src.shape)
    x.copy_(src)
    return x


def _ring_registers(x):
    """The kernel through its register path where the plan takes TMA: the
    TMA path's yardstick."""
    import torch
    from repro_torch.kernels import ring_allgather as rg
    n = x.shape[0]
    out = torch.empty((n, n) + tuple(x.shape[2:]), dtype=x.dtype,
                      device="cuda")
    p = rg.plan(n, x[0].numel() * x.element_size(), x.data_ptr() % 16,
                out.data_ptr() % 16,
                torch.cuda.get_device_properties(0).multi_processor_count)
    rg.launch(x, out, p._replace(tma=False))
    return out


def _launch_ms(fn, reps: int = 20) -> float:
    """Device time of a call of ``fn``, a function that launches one
    kernel: the mean over the kernel events the profiler recorded in
    ``reps`` calls."""
    for _ in range(3):
        fn()
    kern = _events(lambda: [fn() for _ in range(reps)])
    return (sum(e.self_device_time_total for e in kern) / 1e3
            / sum(e.count for e in kern))


def _share(bound, ms) -> str:
    return f"{ms:.5f} ({100 * bound / ms:.1f}% of bound)"


def phase_ring_check():
    """The ring kernel against its plain version and the oracle, bit for
    bit, over the sweep (x aligned and at byte offsets into a buffer);
    one device operation a call; then timed at the FSDP gather's shape (a
    qwen2-0.5b layer, bf16, over 8 ranks) and at 64 MiB shards, beside
    its register path, the previous design's times, the plain version and
    the library copy.  Returns the ring's row of the kernels line (without
    the launch count, which comes from the collectives phase)."""
    import torch
    from repro_torch.kernels import ring_allgather as rg
    from repro_torch.kernels.ref import ring_allgather_ref

    gen = torch.Generator(device="cuda").manual_seed(2)
    launches0 = rg.launches
    n_cases = 0
    for n in RING_NS:
        for dt_name in RING_DTYPES:
            dt = getattr(torch, dt_name)
            esz = torch.empty((), dtype=dt).element_size()
            for nbytes in RING_BYTES:
                for offset in (0,) + RING_OFFSETS:
                    if nbytes % esz or offset % esz:
                        continue
                    x = _ring_input(gen, n, nbytes, dt, offset)
                    require(x.data_ptr() % 16 == offset,
                            f"x starts at {x.data_ptr() % 16} mod 16")
                    out = rg.ring_all_gather(x)
                    torch.cuda.synchronize()
                    ok = (torch.equal(out, rg.ring_all_gather_plain(x))
                          and torch.equal(out, ring_allgather_ref(x)))
                    require(ok, f"ring kernel differs from its plain "
                            f"version at n={n} {dt_name} shard {nbytes} B, "
                            f"x at byte offset {offset}")
                    n_cases += 1
                    del x, out
    log(f"ring check: {n_cases} cases (n {RING_NS}, {RING_DTYPES}, shard "
        f"bytes {RING_BYTES}, x aligned and at byte offsets "
        f"{RING_OFFSETS}) equal to the plain version and the oracle bit "
        f"for bit (torch.equal)")

    # the FSDP gather's shape: one layer's 14,912,384 bf16 params over 8
    n, elems = FSDP_RANKS, QWEN_LAYER_PARAMS // FSDP_RANKS
    x = torch.randn((n, 1, elems), generator=gen, device="cuda").to(
        torch.bfloat16)
    launch = lambda: rg.ring_all_gather(x)
    # one device operation a call
    ops = [(_kernel_name(e.key), e.count) for e in _events(launch)]
    require(ops == [("broadcast_tma_kernel", 1)],
            f"one ring call made the device operations {ops}")
    log(f"ring device operations a call: {ops} (the previous design: a "
        f"memset and the kernel)")
    bound = ring_bound_ms(n, elems * 2)
    row = {
        "name": "ring_allgather", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ring_allgather.cu",
        "replaces": "src/repro/kernels/ring_allgather.py:35",
        "launches": None,
        "max_abs_err": (launch().float()
                        - rg.ring_all_gather_plain(x).float()).abs().max()
        .item(),
        "ms": _launch_ms(launch),
        "plain_ms": device_ms(lambda: rg.ring_all_gather_plain(x)),
        "bound_ms": bound,
        "bound_by": "bytes",
        "library_ms": device_ms(lambda: _ring_library(x)),
    }
    log(f"ring device time at the FSDP gather's shape [{n}, 1, {elems}] "
        f"bf16 (ms): kernel {_share(bound, row['ms'])}, register path "
        f"{_share(bound, _launch_ms(lambda: _ring_registers(x)))}, "
        f"previous design {_share(bound, RING_OLD_MS['fsdp'])}, plain "
        f"{row['plain_ms']:.5f}, library copy "
        f"{_share(bound, row['library_ms'])}, bound {bound:.6f} (bytes); "
        f"kernel with host launch gaps (CUDA events) {cuda_ms(launch):.5f}")
    for offset in (2, 8):
        y = _ring_input(gen, n, elems * 2, torch.bfloat16, offset)
        log(f"ring device time at the FSDP gather's shape, x at byte "
            f"offset {offset} ({offset}-byte vectors) (ms): kernel "
            f"{_share(bound, _launch_ms(lambda: rg.ring_all_gather(y)))}")
        del y
    del x
    for n in (2, 4, 8):
        x = torch.zeros((n, 1, (64 << 20) // 2), dtype=torch.bfloat16,
                        device="cuda")
        bound = ring_bound_ms(n, 64 << 20)
        k_ms = _launch_ms(lambda: rg.ring_all_gather(x), reps=10)
        r_ms = _launch_ms(lambda: _ring_registers(x), reps=10)
        l_ms = device_ms(lambda: _ring_library(x), reps=10)
        log(f"ring device time at n={n}, 64 MiB shards (ms): kernel "
            f"{_share(bound, k_ms)}, register path {_share(bound, r_ms)}, "
            f"previous design {_share(bound, RING_OLD_MS[n])}, library "
            f"copy {_share(bound, l_ms)}, bound {bound:.6f}")
        del x
    log(f"ring checks and timing launched the kernel "
        f"{rg.launches - launches0} times (not counted below)")
    return row


def _layers(cfg, params):
    """Each decoder layer's parameters flattened into one vector."""
    import torch
    from repro_torch.models.common import tree_leaves
    prefix, period, n_periods = cfg.scan_plan()
    layers = [params[f"prefix_{i}"] for i in range(len(prefix))]
    layers += [per[f"l{j}"] for per in params["stack"]
               for j in range(len(period))]
    return [torch.cat([t.reshape(-1) for t in tree_leaves(l)])
            for l in layers]


def _host_ms(fn):
    """(result, host ms) of ``fn`` ending in a synchronise."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _collective(label, dev, fn, want_transfers, reps=3):
    """Run ``fn`` timed, then ``reps`` times in a row under the profiler;
    check its ``Device.stats`` transfers; returns the first run's
    result."""
    before = dev.stats["transfers"]
    out, ms = _host_ms(fn)
    moved = dev.stats["transfers"] - before
    require(moved == want_transfers,
            f"{label}: {moved} transfers, expected {want_transfers}")
    wall, kern = _traced(lambda: [fn() for _ in range(reps)],
                         delays=TRACE_DELAYS[:3])
    busy = sum(e.self_device_time_total for e in kern) / 1e3
    n_kern = sum(e.count for e in kern)
    share = (f"device busy {busy / reps:.3f} ms ({100 * busy / wall:.1f}%, "
             f"{n_kern} kernels recorded)" if n_kern else
             "device busy not measured (no kernel recorded in 3 windows)")
    log(f"collective {label}: host {ms:.3f} ms; {reps} profiled reruns "
        f"wall {wall / reps:.3f} ms each, {share}; {moved} transfers")
    return out


def _check_sum(label, ring, native, x, n):
    """Ring against native within 2 n eps sum_i |x_i|, rank by rank."""
    eps = SUM_EPS[str(x.dtype)[6:]]
    tol = (2 * n * eps) * x.float().abs().sum(0)
    if ring.shape != x.shape:             # reduce-scatter: rank r's slice
        tol = tol.reshape(ring.shape)
    worst = 0.0
    for r in range(ring.shape[0]):
        err = (ring[r].float() - native[r].float()).abs()
        bound = tol[r] if ring.shape != x.shape else tol
        require(bool((err <= bound).all()), f"{label}: ring and native "
                f"sums differ beyond 2 n eps sum|x| at rank {r}")
        worst = max(worst, err.max().item())
        del err
    log(f"collective {label}: ring vs native max_abs_err {worst:.3e} "
        f"(bound 2*n*eps*sum|x|, eps {eps})")


def phase_collectives():
    """LCX collectives at qwen2-0.5b's sizes on 8 (and 4) stacked ranks.
    Returns the ring kernel's launches in the FSDP gather."""
    import torch
    import repro_torch.core as lcx
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import init_model
    from repro_torch.models.common import param_count

    cfg = get_config("qwen2-0.5b")
    params = init_model(torch.Generator(device="cuda").manual_seed(0), cfg,
                        device="cuda")
    layers = _layers(cfg, params)
    n = FSDP_RANKS
    require(len(layers) == cfg.n_layers and all(
        l.numel() == QWEN_LAYER_PARAMS for l in layers),
        f"layer sizes {[l.numel() for l in layers]}")
    shards = [l.reshape(n, 1, -1) for l in layers]
    lcx.init()
    with lcx.ranks.bind_axis("x", n):
        dev = lcx.Device(axis="x")
        # FSDP-style gather through the ring kernel: the path's own run
        torch.cuda.synchronize()
        reset_counts()
        gathered, ms = _host_ms(lambda: [ops.ring_all_gather(
            s, "x", axis_size=n) for s in shards])
        counts = read_counts()
        require(counts == {"flash_attention": 0, "ssd_scan": 0,
                           "ring_allgather": cfg.n_layers, "moe_gmm": 0,
                           "decode_attention": 0},
                f"FSDP gather launches {counts}")
        log(f"fsdp gather: {cfg.n_layers} layers x {QWEN_LAYER_PARAMS} bf16 "
            f"params over {n} ranks through ops.ring_all_gather: host "
            f"{ms:.3f} ms ({ms / cfg.n_layers:.4f} ms per layer, bound "
            f"{ring_bound_ms(n, QWEN_LAYER_PARAMS // n * 2):.6f}); "
            f"launches {counts}")
        lcx_ms = {"ring": 0.0, "native": 0.0}
        for layer, s, g in zip(layers, shards, gathered):
            for backend in ("ring", "native"):
                before = dev.stats["transfers"]
                want, t = _host_ms(lambda: lcx.all_gather(
                    s, device=dev, backend=backend, tiled=False))
                lcx_ms[backend] += t
                moved = dev.stats["transfers"] - before
                require(moved == (n - 1 if backend == "ring" else 0),
                        f"{backend} all_gather made {moved} transfers")
                require(torch.equal(g, want.reshape(g.shape)),
                        f"ring kernel gather differs from LCX {backend}")
            require(all(torch.equal(g[r].reshape(-1), layer)
                        for r in range(n)), "a rank's row does not "
                    "reassemble the layer")
        require(read_counts()["ring_allgather"] == cfg.n_layers,
                "LCX's all_gather launched the ring kernel")
        log(f"fsdp gather: all {cfg.n_layers} layers equal LCX's ring and "
            f"native all_gather (tiled=False) bit for bit and every rank "
            f"reassembles each layer; LCX host ms over the {cfg.n_layers} "
            f"layers: ring "
            f"{lcx_ms['ring']:.3f}, native {lcx_ms['native']:.3f}")
        del gathered
        # the same gather again, now that the allocator holds the freed
        # outputs: the first run's host time includes their cudaMalloc
        _, warm_ms = _host_ms(lambda: [ops.ring_all_gather(
            s, "x", axis_size=n) for s in shards])
        log(f"fsdp gather, allocator warm: {cfg.n_layers} layers through "
            f"ops.ring_all_gather: host {warm_ms:.3f} ms "
            f"({warm_ms / cfg.n_layers:.4f} ms per layer; first run "
            f"{ms:.3f} ms)")

        gen = torch.Generator(device="cuda").manual_seed(3)
        for dt in (torch.float32, torch.bfloat16):
            name = str(dt)[6:]
            x = (0.02 * torch.randn((n, QWEN_LAYER_PARAMS), generator=gen,
                                    device="cuda")).to(dt)
            for op, ring_be in (("reduce_scatter", "ring"),
                                ("all_reduce", "ring"),
                                ("all_to_all", "pairwise")):
                fn = getattr(lcx, op)
                hops = 2 * (n - 1) if op == "all_reduce" else n - 1
                ring = _collective(f"{op} {ring_be} {name} [{n}, "
                                   f"{QWEN_LAYER_PARAMS}]", dev,
                                   lambda: fn(x, device=dev,
                                              backend=ring_be), hops)
                native = _collective(f"{op} native {name}", dev,
                                     lambda: fn(x, device=dev,
                                                backend="native"), 0)
                if op == "all_to_all":
                    require(torch.equal(ring, native),
                            f"all_to_all pairwise differs from native "
                            f"({name})")
                else:
                    _check_sum(f"{op} {name}", ring, native, x, n)
                del ring, native
            out = _collective(f"broadcast root 3 {name}", dev,
                              lambda: lcx.broadcast(x, device=dev, root=3),
                              0)
            require(all(torch.equal(out[r], x[3]) for r in range(n)),
                    f"broadcast differs from root 3's row ({name})")
            del out, x
        lcx.barrier(device=dev)
        log("collective barrier: ok")

    # the full gradient of qwen2-0.5b in f32, all-reduced over 4 ranks
    m, total = FULL_GRAD_RANKS, param_count(params)
    del params, layers, shards
    release()
    require(total == QWEN_PARAMS, f"qwen2-0.5b has {total} params")
    with lcx.ranks.bind_axis("x", m):
        dev = lcx.Device(axis="x")
        x = torch.randn((m, total), generator=gen, device="cuda")
        peak = {}
        outs = {}
        for backend in ("ring", "native"):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            outs[backend], ms = _host_ms(lambda: lcx.all_reduce(
                x, device=dev, backend=backend))
            peak[backend] = torch.cuda.max_memory_allocated()
            log(f"full-gradient all_reduce {backend}: [{m}, {total}] f32 "
                f"({x.numel() * 4} bytes), host {ms:.3f} ms, "
                f"max_memory_allocated {peak[backend]} bytes "
                f"({peak[backend] - base} above the live tensors before)")
        require(all(torch.equal(outs["ring"][0], outs["ring"][r])
                    for r in range(m)), "ring all_reduce rows differ")
        _check_sum("full-gradient all_reduce f32", outs["ring"],
                   outs["native"], x, m)
        del x, outs
    return counts["ring_allgather"]


def _quickstart(lcx, x):
    """``examples/quickstart.py``'s per-rank body on rank-stacked ``x``."""
    lcx.init()
    dev = lcx.Device(axis="x")
    sync = lcx.Synchronizer(threshold=1)
    op = lcx.put_x(x).perm(lcx.Perm.shift(1)).remote_comp(sync).device(dev)
    op()
    lcx.progress()
    (ev,) = sync.wait()
    neighbour = ev.payload
    cq = lcx.CompletionQueue()
    fh = lcx.FunctionHandler(lambda e: e.payload * 2)
    lcx.am_x(x).perm(lcx.Perm.shift(2)).remote_comp(cq).device(dev)()
    lcx.am_x(x).perm(lcx.Perm.shift(1)).remote_comp(fh).device(dev)()
    lcx.progress()
    from_two_away = cq.pop().payload
    doubled = fh.results[0]
    eng = lcx.MatchingEngine(kind="map", policy="rank_tag")
    s2 = lcx.Synchronizer(threshold=2)
    lcx.send_x(x * 10).perm(lcx.Perm.shift(1)).tag(7).comp(s2) \
        .matching_engine(eng).device(dev)()
    lcx.recv_x(x).perm(lcx.Perm.shift(1)).tag(7).comp(s2) \
        .matching_engine(eng).device(dev)()
    lcx.progress()
    matched = [e.payload for e in s2.wait() if e.payload is not None][0]
    total = lcx.all_reduce(x, device=dev, backend="ring")
    return neighbour, from_two_away, doubled, matched, total


def phase_quickstart():
    import torch
    import repro_torch.core as lcx
    xs = torch.arange(4.0, device="cuda")
    with lcx.ranks.bind_axis("x", 4):
        (nb, two, dbl, matched, total), ms = _host_ms(
            lambda: _quickstart(lcx, xs))
    want = (xs.roll(1), xs.roll(2), 2 * xs.roll(1), 10 * xs.roll(1),
            torch.full_like(xs, float(xs.sum())))
    for name, g, w in zip(("neighbour", "two away", "am handler",
                           "matched", "ring all-reduce"),
                          (nb, two, dbl, matched, total), want):
        require(g.device.type == "cuda" and torch.equal(g, w),
                f"quickstart {name}: {g} != {w}")
    log(f"quickstart on 4 CUDA ranks: left neighbour {nb.tolist()}, two "
        f"away {two.tolist()}, am handler {dbl.tolist()}, matched "
        f"{matched.tolist()}, ring all-reduce {total.tolist()}; host "
        f"{ms:.3f} ms")


def phase_remote():
    import torch
    import repro_torch.amt as amt
    import repro_torch.core as lcx
    n = 8
    x = torch.randn((n, 4096), generator=torch.Generator(
        device="cuda").manual_seed(4), device="cuda")
    amt.clear_task_handlers()
    amt.register_task_handler("affine", lambda v: v * 2.0 + 1.0)
    lcx.init()
    with lcx.ranks.bind_axis("x", n):
        ex = amt.Executor(device=lcx.Device(axis="x"))
        sp = amt.RemoteSpawner(ex)
        promise = sp.spawn("affine", x, lcx.Perm.shift(1))
        stats, ms = _host_ms(ex.run)
        require(torch.equal(promise.result, x * 2.0 + 1.0),
                "remote spawn reply differs from the handler's result")
        amt.register_task_handler("ghost", lambda v: v)
        ghost = sp.spawn("ghost", x, lcx.Perm.shift(1))
        amt.clear_task_handlers()
        ex.run()
        res = ghost.result
    require(isinstance(res, amt.RemoteFailure)
            and res.status == "unknown_handler" and not res.ok,
            f"unknown handler resolved to {res!r}")
    log(f"remote spawn on {n} ranks, payload [{n}, 4096] on "
        f"{x.device}: reply equals the handler's result; host {ms:.3f} ms;"
        f" executor {stats}; unknown handler -> RemoteFailure("
        f"{res.status!r}); spawner stats {sp.stats}")


def phase_failover(prompts, want_tokens):
    """Serve phase 4's requests with ``failover=True``; freeze the serving
    device after the first 8 admissions, with 8 hand-off puts (each
    admitted prompt, on the card) posted before the freeze and 8 after,
    all in flight when the heartbeat must notice."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import model_kernels
    from repro_torch.models import init_model
    from repro_torch.runtime import HeartbeatMonitor
    from repro_torch.serving import Request, ServeConfig, ServingEngine

    cfg = get_config("qwen2-0.5b")
    params = init_model(torch.Generator(device="cuda").manual_seed(0), cfg,
                        device="cuda")
    hb = HeartbeatMonitor(threshold=2.0, patience=2, grace=3,
                          on_dead="failover")
    eng = ServingEngine(cfg, params, ServeConfig(
        n_slots=SERVE_SLOTS, max_seq=SERVE_MAX_SEQ,
        max_new_tokens=SERVE_NEW), kernels=model_kernels(cfg),
        failover=True, heartbeat=hb)
    ex, rt = eng._executor, eng.lcx_runtime
    primary = ex.device
    sent = [torch.as_tensor(p, device="cuda") for p in prompts]
    got, mark = {}, {}

    def handoff(i):
        def run(ctx):
            ctx.put(sent[i], None, tag=i, max_retries=16)
            return ctx.suspend(lambda ev: got.setdefault(
                i, (ev.payload, time.perf_counter(), ev.migrated)))
        return run

    def killer(ctx):
        mark["tick"], mark["t"] = rt.tick, time.perf_counter()
        primary.freeze()

    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p))
    eng.tick()
    require(eng.stats["prefills"] == SERVE_SLOTS,
            f"first tick admitted {eng.stats['prefills']}")
    for i in range(8):
        ex.spawn(handoff(i), priority=4, name=f"handoff:{i}")
    ex.spawn(killer, priority=2, name="killer")
    for i in range(8, len(prompts)):
        ex.spawn(handoff(i), priority=0, name=f"handoff:{i}")
    done = eng.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()

    require(len(done) == len(prompts) and not eng.failed,
            f"{len(done)} of {len(prompts)} finished, failed: "
            f"{[r.error for r in eng.failed]}")
    require(all(len(r.output) == SERVE_NEW and r.error is None
                for r in done), f"outputs {[len(r.output) for r in done]}")
    require(len(hb.events) == 1 and hb.events[0]["device"] is primary,
            f"heartbeat events {hb.events}")
    ev = hb.events[0]
    target = ev["target"]
    require(ev["policy"] == "failover" and target is not primary
            and target.alive and not primary.alive
            and ex.device is primary.resolve_migrated(),
            f"declaration {ev}, executor on {ex.device}")
    require(rt.failover_stats["failovers"] == 1, f"{rt.failover_stats}")
    require(sorted(got) == list(range(len(prompts))) and all(
        torch.equal(got[i][0], sent[i]) for i in got),
        f"hand-offs delivered: {sorted(got)}")
    migrated = sum(m for _, _, m in got.values())
    require(migrated >= len(prompts) - 8, f"only {migrated} hand-offs "
            f"were delivered by the survivor")
    want = expected_launches(cfg, len(prompts), eng.stats["ticks"])
    require(counts == want, f"launches {counts}, expected {want}")
    tokens = {r.rid: list(r.output) for r in done}
    require(tokens == want_tokens, "failover serve tokens differ from the "
            "serve phase's for the same prompts")
    recovery_ms = (max(t for _, t, _ in got.values()) - mark["t"]) * 1e3
    log(f"failover serve: {cfg.name} full width, {len(done)} requests x "
        f"{SERVE_NEW} tokens in {wall:.3f} s; serving device frozen at "
        f"LCX tick {mark['tick']} after {SERVE_SLOTS} admissions, declared "
        f"dead at tick {ev['tick']} ({ev['tick'] - mark['tick']} ticks), "
        f"migrated to {target!r}; all {len(got)} hand-offs delivered "
        f"({migrated} by the survivor), the last {recovery_ms:.3f} ms "
        f"after the freeze; report "
        f"{ev['report']}; failover stats {rt.failover_stats}; executor "
        f"{ex.stats}; launches {counts}; tokens equal the serve phase's; "
        f"card {smi()}")


def _train(label, cfg, tcfg, steps, injector=None):
    """``Trainer.run(steps)`` on the card; prints each logged step and the
    run's peak memory.  Returns the trainer and the run's result."""
    import torch
    from repro_torch.runtime import Trainer
    torch.cuda.reset_peak_memory_stats()
    tr = Trainer(cfg, tcfg, device="cuda", failure_injector=injector)
    t0 = time.perf_counter()
    res = tr.run(steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    card = smi()
    for m in tr.metrics_log:
        share = 100 * m["model_flops_per_s"] / PEAK_FLOPS["bfloat16"]
        mtp = f" mtp {m['mtp']:.6f}" if "mtp" in m else ""
        log(f"train {label}: step {m['step']} loss {m['loss']:.6f} xent "
            f"{m['xent']:.6f} aux {m['aux']:.6f}{mtp} grad_norm "
            f"{m['grad_norm']:.6f} lr {m['lr']:.3e}; host "
            f"{m['dt'] * 1e3:.3f} ms, {m['tokens_per_s']:.1f} tokens/s, "
            f"model {m['model_flops_per_s']:.4e} flop/s = {share:.2f}% of "
            f"the bf16 dense peak; card {card}")
    log(f"train {label}: final step {res['final_step']}, "
        f"{res['failures']} failures, {len(res['straggler_events'])} "
        f"straggler events, wall {wall:.3f} s (init excluded), "
        f"max_memory_allocated {torch.cuda.max_memory_allocated()} bytes; "
        f"card {card}")
    require(all(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])
                for m in tr.metrics_log), f"{label}: a loss is not finite")
    return tr, res


def _train_cfg(arch, steps, **overrides):
    from repro_torch.configs.base import get_config
    from repro_torch.runtime import TrainConfig
    full = get_config(arch)
    cfg = dataclasses.replace(full, **overrides)
    depth = (f"{cfg.n_layers} layers" if cfg.n_layers == full.n_layers
             else f"cut to {cfg.n_layers} of {full.n_layers} layers")
    if cfg.n_experts != full.n_experts:
        depth += (f", routed experts cut to {cfg.n_experts} of "
                  f"{full.n_experts} (top-{cfg.n_experts_per_tok})")
    tcfg = TrainConfig(lr=TRAIN_LR, warmup=2, total_steps=steps,
                       seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                       log_every=1)
    log(f"train: {cfg.name} full width, {depth}; params "
        f"{str(cfg.param_dtype)[6:]}, activations {str(cfg.dtype)[6:]}, "
        f"moments {str(cfg.opt_dtype)[6:]}, remat {cfg.remat!r}; seq "
        f"{TRAIN_SEQ} x batch {TRAIN_BATCH}, lr {tcfg.lr} (warmup "
        f"{tcfg.warmup}, cosine to step {steps})")
    return cfg, tcfg


def phase_train_qwen():
    """qwen2-0.5b: run A uninterrupted, run B with checkpoints and a node
    failure, the checkpoint's write and restore times, the accumulators.
    Returns run A's median step ms over its steps after the first; fails
    on any check."""
    import shutil
    import tempfile
    import torch
    from repro_torch.models import init_model
    from repro_torch.optim import adamw_init, cosine_schedule
    from repro_torch.runtime import FailureInjector, make_train_step

    cfg, tcfg = _train_cfg("qwen2-0.5b", TRAIN_STEPS)
    tr, res = _train("qwen2-0.5b run A", cfg, tcfg, TRAIN_STEPS)
    loss_a = {m["step"]: m["loss"] for m in tr.metrics_log}
    require(res["final_step"] == TRAIN_STEPS and not res["failures"],
            f"run A: {res}")
    require(loss_a[TRAIN_STEPS] < loss_a[1],
            f"the loss did not fall: {loss_a}")
    gnorm1 = tr.metrics_log[0]["grad_norm"]
    steady = sorted(m["dt"] * 1e3 for m in tr.metrics_log[1:])
    step_ms = steady[len(steady) // 2]
    batch0 = tr._host_batch(0)
    nxt = tr._host_batch(tr.step_count)
    _profiled(f"{cfg.name} train step (seq {TRAIN_SEQ} x batch "
              f"{TRAIN_BATCH})", lambda: tr._step_fn(tr.params, tr.opt, nxt))
    del tr, nxt
    release()

    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        log(f"train: checkpoints in a temporary directory with "
            f"{shutil.disk_usage(ckpt_dir).free} bytes free")
        tr, res = _train(
            "qwen2-0.5b run B", cfg,
            dataclasses.replace(tcfg, ckpt_dir=ckpt_dir,
                                ckpt_every=TRAIN_CKPT_EVERY, keep_ckpts=2),
            TRAIN_STEPS, FailureInjector(fail_at=[TRAIN_FAIL_AT]))
        require(res["failures"] == 1 and res["final_step"] == TRAIN_STEPS,
                f"run B: {res}")
        steps = [m["step"] for m in tr.metrics_log]
        redo = list(range(TRAIN_FAIL_AT, TRAIN_STEPS + 1))
        require(steps == list(range(1, TRAIN_FAIL_AT + 1)) + redo,
                f"run B logged steps {steps}")
        diffs = [abs(m["loss"] - loss_a[m["step"]]) / loss_a[m["step"]]
                 for m in tr.metrics_log]
        bitwise = all(m["loss"] == loss_a[m["step"]] for m in tr.metrics_log)
        log(f"train: run B failed at step {TRAIN_FAIL_AT}, restored the "
            f"step-{TRAIN_FAIL_AT - 1} checkpoint, redid steps {redo}; its "
            f"losses against run A's, step for step: largest relative "
            f"difference {max(diffs):.3e} (bound {TRAIN_LOSS_RTOL}); "
            f"bitwise equal: {bitwise}")
        require(max(diffs) <= TRAIN_LOSS_RTOL,
                f"run B's losses differ from run A's: {diffs}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.save(blocking=True)
        write_ms = (time.perf_counter() - t0) * 1e3
        step_dir = Path(ckpt_dir) / f"step_{tr.step_count:09d}"
        nbytes = sum(f.stat().st_size for f in step_dir.iterdir())
        t0 = time.perf_counter()
        require(tr.restore(), "no checkpoint to restore")
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3
        log(f"train: checkpoint of step {tr.step_count} (params + AdamW "
            f"state, {len(list(step_dir.iterdir())) - 2} leaves, {nbytes} "
            f"bytes): write {write_ms:.3f} ms (device to host and files), "
            f"restore {restore_ms:.3f} ms (files to device)")
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    del tr
    release()

    for compressed in (False, True):
        params = init_model(torch.Generator(device="cuda").manual_seed(
            tcfg.seed), cfg, device="cuda")
        opt = adamw_init(params, cfg.opt_dtype)
        step = make_train_step(cfg, dataclasses.replace(
            tcfg, grad_accum=2, compressed_accum=compressed),
            cosine_schedule(tcfg.lr, tcfg.warmup, tcfg.total_steps))
        _, _, m = step(params, opt, batch0)
        gnorm = float(m["grad_norm"])
        log(f"train: {cfg.name} grad_accum=2 with the "
            f"{'int8 + error-feedback' if compressed else 'f32'} "
            f"accumulator, step 1: grad_norm {gnorm:.6f}, loss "
            f"{float(m['loss']):.6f}; grad_accum=1 on the same batch "
            f"{gnorm1:.6f} (relative difference "
            f"{abs(gnorm - gnorm1) / gnorm1:.3e}, bound {ACCUM_NORM_RTOL})")
        require(abs(gnorm - gnorm1) <= ACCUM_NORM_RTOL * gnorm1,
                "accumulated gradient norm differs")
        del params, opt, step, m
        release()
    return step_ms


def train_state_bytes(cfg) -> tuple:
    """(params, bytes of the params, their grads and AdamW's two moments in
    ``cfg.opt_dtype``) of ``cfg``, counted on ``meta``: nothing allocated."""
    from repro_torch.models import abstract_init
    from repro_torch.models.common import tree_leaves
    leaves = list(tree_leaves(abstract_init(cfg)[0]))
    n = sum(t.numel() for t in leaves)
    nbytes = sum(t.numel() * t.element_size() for t in leaves)
    return n, 2 * nbytes + 2 * n * cfg.opt_dtype.itemsize


def depth_from_probes(peaks, cap) -> tuple:
    """(bytes a layer, the depth that fits, the depth taken) from the peak
    memory of runs at two depths (``{layers: bytes}``): the slope between
    them, the largest depth whose peak, extrapolated along it, leaves
    ``TRAIN_FREE_BYTES`` of ``TRAIN_CARD_BYTES`` free, and that depth at
    most ``cap``."""
    (lo, p_lo), (hi, p_hi) = sorted(peaks.items())
    slope = (p_hi - p_lo) / (hi - lo)
    fit = lo + int((TRAIN_CARD_BYTES - TRAIN_FREE_BYTES - p_lo) // slope)
    return slope, fit, min(fit, cap)


def _one_card_bound(cfg, step_ms):
    """The train step of ``cfg`` at the train phase's shape on one card (no
    mesh), counted on ``meta`` as the dry run counts a cell: its compute
    and memory terms on the H100's constants.  The larger must lie below
    ``step_ms``, the step measured on the card, or the counting is
    wrong."""
    from repro_torch.analysis.roofline import analyze_compiled, count_step
    from repro_torch.launch.steps import build_train_bundle
    from repro_torch.models import abstract_init
    from repro_torch.runtime import TrainConfig
    tcfg = TrainConfig(lr=TRAIN_LR, warmup=2, total_steps=TRAIN_STEPS,
                       seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH)
    t0 = time.perf_counter()
    bundle = build_train_bundle(cfg, None, TRAIN_SEQ, TRAIN_BATCH,
                                tcfg=tcfg)
    counted = count_step(bundle, t_build_s=time.perf_counter() - t0)
    report = analyze_compiled(
        counted, arch=cfg.name, shape=f"{TRAIN_SEQ}x{TRAIN_BATCH}",
        mesh_name="1 card", chips=1, cfg=cfg,
        params_proto=abstract_init(cfg)[0], kind="train",
        seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH)
    bound_ms = max(report.compute_s, report.memory_s) * 1e3
    log(f"{report.summary()}; card {smi()}")
    log(f"dryrun one-card {cfg.name} train step ({cfg.n_layers} layers, "
        f"seq {TRAIN_SEQ} x batch {TRAIN_BATCH}): counted "
        f"{report.hlo_flops:.6e} flop (compute "
        f"{report.compute_s * 1e3:.3f} ms), {report.hlo_bytes:.6e} B "
        f"(memory {report.memory_s * 1e3:.3f} ms), {counted.totals.n_ops} "
        f"ops in {time.perf_counter() - t0:.1f} s; bound {bound_ms:.3f} ms "
        f"against the measured step {step_ms:.3f} ms "
        f"({100 * bound_ms / step_ms:.1f}%); useful_ratio "
        f"{report.useful_ratio:.4f} (6 N_active D / counted flops); card "
        f"{smi()}")
    require(bound_ms < step_ms,
            f"the counted bound {bound_ms:.3f} ms is above the measured "
            f"step {step_ms:.3f} ms: the counting is wrong")


def phase_train_short(arch, cut=None, **overrides):
    """``TRAIN_SHORT_STEPS`` steps of ``arch`` at full width (``overrides``
    cut it, ``cut`` says why), one of them profiled; the time the host takes
    to draw a batch's frontend embeddings; the step's one-card bound
    counted on ``meta``.  Fails on a loss or grad norm that is not finite,
    an MoE without an aux loss, an MTP loss that is not finite and
    positive, or a bound above the median step."""
    import torch
    from repro_torch.data import to_device
    cfg, tcfg = _train_cfg(arch, TRAIN_SHORT_STEPS, **overrides)
    n, state = train_state_bytes(cfg)
    log(f"train: {cfg.name} " + (f"cut: {cut}; " if cut else "")
        + f"{n} params; params + grads + two moments {state} bytes "
        f"(counted on meta); card {smi()}")
    tr, res = _train(cfg.name, cfg, tcfg, TRAIN_SHORT_STEPS)
    require(res["final_step"] == TRAIN_SHORT_STEPS, f"{res}")
    if cfg.n_experts:
        require(all(m["aux"] > 0 for m in tr.metrics_log),
                "the MoE aux loss is not in the metrics")
    if cfg.mtp_depth:
        require(all(math.isfinite(m["mtp"]) and m["mtp"] > 0
                    for m in tr.metrics_log),
                "the MTP loss is not finite and positive")
    steady = sorted(m["dt"] * 1e3 for m in tr.metrics_log[1:])
    step_ms = steady[len(steady) // 2]
    # Trainer.run draws each batch on the host before its step's timer
    t0 = time.perf_counter()
    host = tr.dataset.batch(tr.step_count)
    draw_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    nxt = to_device(host, tr.device)
    torch.cuda.synchronize()
    move_ms = (time.perf_counter() - t0) * 1e3
    if "frontend" in host:
        log(f"train {cfg.name}: the host draws a batch, "
            f"{host['frontend'].nbytes} bytes of f32 frontend embeddings "
            f"{list(host['frontend'].shape)} with numpy row by row, in "
            f"{draw_ms:.3f} ms, and moves it to the card in {move_ms:.3f} "
            f"ms, outside the step's timer; card {smi()}")
    _profiled(f"{cfg.name} train step (seq {TRAIN_SEQ} x batch "
              f"{TRAIN_BATCH})", lambda: tr._step_fn(tr.params, tr.opt, nxt))
    del tr, nxt
    release()
    _one_card_bound(cfg, step_ms)


def phase_train_llava():
    """llava-next-mistral-7b at the depth its probes pick: one step each at
    ``LLAVA_PROBE_LAYERS`` layers, the slope of the peak memory between
    them, and the largest depth that leaves ``TRAIN_FREE_BYTES`` free (at
    most the depth in ``TRAIN_CUTS``); then its run."""
    import torch
    from repro_torch.configs.base import get_config
    arch = "llava-next-mistral-7b"
    full = get_config(arch)
    cap = TRAIN_CUTS[arch][0]["n_layers"]
    peaks = {}
    for layers in LLAVA_PROBE_LAYERS:
        cfg, tcfg = _train_cfg(arch, 1, n_layers=layers)
        tr, _ = _train(f"{arch} probe at {layers} layers", cfg, tcfg, 1)
        peaks[layers] = torch.cuda.max_memory_allocated()
        del tr
        release()
    slope, fit, depth = depth_from_probes(peaks, cap)
    log(f"train: {arch} probes: max_memory_allocated {peaks} bytes by "
        f"layers, slope {slope:.0f} bytes a layer; the largest depth that "
        f"leaves {TRAIN_FREE_BYTES:.0f} of {TRAIN_CARD_BYTES:.0f} bytes "
        f"free is {fit}, at most {cap}: {depth} layers; card {smi()}")
    require(depth >= max(LLAVA_PROBE_LAYERS),
            f"{arch}: the probes leave no depth above theirs")
    phase_train_short(
        arch, cut=f"{depth} of {full.n_layers} layers, the depth its probes "
        f"picked: the whole model's training state, "
        f"{train_state_bytes(full)[1]} bytes, does not fit one card",
        n_layers=depth)
    log(f"train {arch}: each row is {full.frontend_len} patch rows and "
        f"{TRAIN_SEQ} tokens; the model flops above count the tokens "
        f"(6 N_active x seq x batch, as the reference's model_flops), so "
        f"their share undercounts the step's work by "
        f"{full.frontend_len + TRAIN_SEQ}/{TRAIN_SEQ}")


def phase_train_deepseek():
    """DeepSeek-V3 with its MTP loss, at the first cut of ``TRAIN_CUTS``
    that does not run out of memory."""
    import torch
    from repro_torch.configs.base import get_config
    arch = "deepseek-v3-671b"
    full = get_config(arch)
    cuts = TRAIN_CUTS[arch]
    for i, over in enumerate(cuts):
        wide = {e: train_state_bytes(dataclasses.replace(
                    full, **dict(over, n_experts=e)))[1]
                for e in (full.n_experts, 64)}
        why = (f"its {over['first_k_dense']} dense layers and "
               f"{over['n_layers'] - over['first_k_dense']} MoE layer (one "
               f"whole period) and the MTP layer; the router is "
               f"{over['n_experts']} wide, not {full.n_experts}: at "
               f"{full.n_experts} experts this cut's training state is "
               f"{wide[full.n_experts]} bytes and at 64 {wide[64]} bytes "
               f"before activations, and neither package has an expert "
               f"layer that holds a share of the experts and routes over "
               f"all of them, so the expert count itself is cut; top-"
               f"{full.n_experts_per_tok}, moe_d_ff {full.moe_d_ff}, "
               f"{full.n_shared_experts} shared expert, the "
               f"{full.router_type} router with norm-top-k, capacity "
               f"factor {full.capacity_factor}, MLA's widths, MTP depth "
               f"{full.mtp_depth} (coefficient {full.mtp_loss_coef}) and "
               f"{str(full.opt_dtype)[6:]} moments as published")
        try:
            return phase_train_short(arch, cut=why, **over)
        except torch.cuda.OutOfMemoryError as e:
            if i + 1 == len(cuts):
                raise
            err = str(e).splitlines()[0]
        release()
        log(f"train: {arch} at {over['n_experts']} experts ran out of "
            f"memory ({err}); taking {cuts[i + 1]['n_experts']}")


def phase_train_f32_cuts():
    """Each path of ``TRAIN_SMOKE_CUTS`` in f32: one train step on the card
    against the port's own step on the CPU, the same params and batch;
    the loss, its parts and the grad norm within ``TRAIN_F32_RTOL``."""
    import torch
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.data import make_batch, to_device
    from repro_torch.models import init_model
    from repro_torch.models.common import tree_map
    from repro_torch.optim import adamw_init, cosine_schedule
    from repro_torch.runtime import TrainConfig, make_train_step
    for arch, over in TRAIN_SMOKE_CUTS.items():
        cfg = dataclasses.replace(get_smoke_config(arch), **over)
        tcfg = TrainConfig(lr=TRAIN_LR, warmup=2,
                           total_steps=TRAIN_SHORT_STEPS,
                           seq_len=TRAIN_F32_SEQ,
                           global_batch=TRAIN_F32_BATCH)
        batch = make_batch(cfg, TRAIN_F32_SEQ, TRAIN_F32_BATCH, seed=0)
        params = init_model(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
        got = {}
        for dev in ("cpu", "cuda"):
            p = tree_map(lambda t: t.detach().to(dev, copy=True), params)
            step = make_train_step(cfg, tcfg, cosine_schedule(
                tcfg.lr, tcfg.warmup, tcfg.total_steps))
            _, _, m = step(p, adamw_init(p, cfg.opt_dtype),
                           to_device(batch, torch.device(dev)))
            got[dev] = {k: float(v) for k, v in m.items() if k != "lr"}
        errs = {k: abs(got["cuda"][k] - v) / abs(v) if v else
                abs(got["cuda"][k]) for k, v in got["cpu"].items()}
        log(f"train f32 check: {cfg.name} {over}, seq {TRAIN_F32_SEQ} x "
            f"batch {TRAIN_F32_BATCH}, one step on the card against the "
            f"CPU: card {got['cuda']}, relative differences {errs} (bound "
            f"{TRAIN_F32_RTOL})")
        require(all(e <= TRAIN_F32_RTOL for e in errs.values()),
                f"{cfg.name}: the card's f32 step differs from the CPU's")


def phase_flash_backward():
    """The chunked attention's custom backward (``_Flash``) against
    autograd through ``attention_full``, f32, qwen2-0.5b's heads (14 query,
    2 KV, D 64), S 1024 (4 blocks of 256), causal."""
    import torch
    from repro_torch.models.attention import attention_chunked, attention_full
    gen = torch.Generator(device="cuda").manual_seed(9)
    b, s = 2, TRAIN_SEQ
    q, k, v, do = (torch.randn(shape, device="cuda", generator=gen)
                   for shape in ((b, s, 14, 64), (b, s, 2, 64),
                                 (b, s, 2, 64), (b, s, 14, 64)))
    pos = torch.arange(s, device="cuda")
    res = []
    for fn in (lambda q, k, v: attention_chunked(
                   q, k, v, scale=0.125, causal=True, window=None,
                   q_block=256, k_block=256),
               lambda q, k, v: attention_full(
                   q, k, v, scale=0.125, causal=True, window=None,
                   q_pos=pos, k_pos=pos)):
        xs = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = fn(*xs)
        out.backward(do)
        res.append([out.detach()] + [x.grad for x in xs])
    errs = {}
    for name, got, ref in zip(("out", "dq", "dk", "dv"), *res):
        errs[name] = float((got - ref).abs().max())
        bound = FLASH_BWD_RTOL * float(ref.abs().max())
        require(errs[name] <= bound,
                f"flash backward {name}: error {errs[name]} > {bound}")
    log(f"flash backward check: f32, [{b}, {s}] x 14/2 heads x 64, causal, "
        f"chunked (blocks of 256) vs autograd through attention_full: max "
        f"abs errors {errs} (each within {FLASH_BWD_RTOL} x its reference's "
        f"largest magnitude)")


def phase_train():
    """Phase 15: every training path, with the four kernels' launch counts
    set to 0 before and read after (the reference trains with
    ``kernels=None``).  Returns the qwen2-0.5b step's median ms."""
    reset_counts()
    step_ms = phase_train_qwen()
    phase_train_short("mamba2-130m")
    phase_train_short("qwen3-moe-30b-a3b",
                      cut="4 of 48 layers: the whole model's training state "
                      "does not fit one card", n_layers=MOE_TRAIN_LAYERS)
    phase_train_short("hubert-xlarge", **TRAIN_CUTS["hubert-xlarge"][0])
    phase_train_llava()
    phase_train_deepseek()
    phase_train_f32_cuts()
    phase_flash_backward()
    counts = read_counts()
    log(f"train: kernel launches across every training phase {counts}")
    require(not any(counts.values()),
            f"a TPU-kernel port launched during training: {counts}")
    return step_ms


# ---------------------------------------------------------------------------
# the causal-skip schedule, the example scripts, the dry run
# ---------------------------------------------------------------------------
def _loss_and_grads(cfg, params, batch, impl):
    """``loss_fn(..., impl=impl)`` and the gradient of every params leaf."""
    import torch
    from repro_torch.models import loss_fn
    from repro_torch.models.common import tree_leaves
    loss, _ = loss_fn(cfg, params, batch, impl=impl)
    grads = torch.autograd.grad(loss, list(tree_leaves(params)),
                                allow_unused=True, materialize_grads=True)
    return loss.detach(), grads


def phase_causal_skip():
    """The causal-skip schedule (``impl="chunked_causal_skip"``) against
    the default ``"chunked"``: qwen2-0.5b's loss and gradients at the
    train phase's seq 1024 x batch 8 in bf16 (4 blocks of 256: 10 of the
    16 score blocks), forward + backward timed alternately after a
    warm-up round, with its peak memory; the losses within one bf16 step; no
    kernel launches; then in f32 at 2 layers, loss and every gradient
    within ``SKIP_F32_TOL``."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.data import make_batch, to_device
    from repro_torch.models import init_model
    from repro_torch.models.common import tree_leaves
    impls = ("chunked", "chunked_causal_skip")
    cfg = get_config("qwen2-0.5b")
    batch = to_device(make_batch(cfg, TRAIN_SEQ, TRAIN_BATCH, seed=0),
                      torch.device("cuda"))
    reset_counts()
    params = init_model(torch.Generator(device="cuda").manual_seed(0), cfg,
                        device="cuda")
    for t in tree_leaves(params):
        t.requires_grad_(True)
    ms, peak, loss, gnorm = {i: [] for i in impls}, {}, {}, {}
    for rep in range(SKIP_REPS + 1):          # round 0 warms up
        for impl in impls:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            l, g = _loss_and_grads(cfg, params, batch, impl)
            torch.cuda.synchronize()
            if rep:
                ms[impl].append((time.perf_counter() - t0) * 1e3)
            peak[impl] = torch.cuda.max_memory_allocated()
            loss[impl] = float(l)
            gnorm[impl] = float(torch.sqrt(sum(
                (x.float() ** 2).sum() for x in g)))
            del g
    counts = read_counts()
    for impl in impls:
        log(f"causal skip {impl}: qwen2-0.5b bf16 loss + grads, seq "
            f"{TRAIN_SEQ} x batch {TRAIN_BATCH}: host ms "
            f"{[round(x, 3) for x in ms[impl]]} (alternating), loss "
            f"{loss[impl]:.6f}, grad norm {gnorm[impl]:.6f}, "
            f"max_memory_allocated {peak[impl]} bytes; card {smi()}")
    diff = abs(loss[impls[0]] - loss[impls[1]])
    bound = SKIP_LOSS_RTOL * abs(loss[impls[0]])
    log(f"causal skip: bf16 loss difference {diff:.3e} (bound {bound:.3e}),"
        f" grad-norm difference {abs(gnorm[impls[0]] - gnorm[impls[1]]):.3e};"
        f" kernel launches {counts}")
    require(not any(counts.values()),
            f"a TPU-kernel port launched in the causal-skip phase: {counts}")
    require(diff <= bound, f"causal skip: bf16 losses {loss} differ")
    del params
    release()
    cfg32 = dataclasses.replace(cfg, n_layers=SKIP_F32_LAYERS,
                                dtype=torch.float32,
                                param_dtype=torch.float32)
    params = init_model(torch.Generator(device="cuda").manual_seed(0),
                        cfg32, device="cuda")
    for t in tree_leaves(params):
        t.requires_grad_(True)
    (la, ga), (lb, gb) = [_loss_and_grads(cfg32, params, batch, i)
                          for i in impls]
    dl = abs(float(la) - float(lb))
    dg = max(float((x - y).abs().max()) for x, y in zip(ga, gb))
    log(f"causal skip f32 check ({SKIP_F32_LAYERS} layers, seq {TRAIN_SEQ}"
        f" x batch {TRAIN_BATCH}): loss {float(la):.7f} vs {float(lb):.7f},"
        f" difference {dl:.3e}; largest gradient difference {dg:.3e} "
        f"(bound {SKIP_F32_TOL})")
    require(dl <= SKIP_F32_TOL and dg <= SKIP_F32_TOL,
            "causal skip: the f32 loss or gradients differ from chunked")
    del params, ga, gb
    release()


def phase_examples():
    """The port's three example scripts on the card, in child processes
    started together; each must exit 0 and print its ``... OK`` line
    (``torch_train_lm.py`` at its default 300 steps)."""
    procs = []
    t0 = time.perf_counter()
    for script, _ in EXAMPLES:
        procs.append(subprocess.Popen(
            [sys.executable, str(ROOT / "examples" / script)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(timeout=EXAMPLE_TIMEOUT_S))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    wall = time.perf_counter() - t0
    for (script, ok), proc, (out, err) in zip(EXAMPLES, procs, outs):
        lines = out.splitlines()
        tail = [ln for ln in lines if "OK" in ln or "served" in ln
                or "loss:" in ln or "recovered" in ln or "ring" in ln]
        log(f"example {script}: exit {proc.returncode}; " + " | ".join(
            ln.strip() for ln in tail))
        require(proc.returncode == 0 and ok in lines,
                f"example {script} failed: {out[-2000:]} {err[-2000:]}")
    log(f"examples: {len(EXAMPLES)} scripts in child processes, "
        f"{wall:.1f} s wall together")


def phase_dryrun(train_step_ms):
    """The dry run: one production cell (``DRYRUN_CELL`` on the 16 x 16
    mesh, 256 ranks stacked on ``meta``) through ``run_cell``, and the
    train phase's own qwen2-0.5b step (seq 1024 x batch 8, one card, no
    mesh) counted the same way: its compute and memory terms on the
    H100's constants must lie below the step time the train phase
    measured, or the counting is wrong."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch.dryrun import run_cell
    arch, shape = DRYRUN_CELL
    t0 = time.perf_counter()
    rec = run_cell(arch, shape)
    cell_s = time.perf_counter() - t0
    require(rec["ok"] and rec["compute_s"] > 0 and rec["memory_s"] > 0,
            f"dry run {arch} {shape}: {rec}")
    log(f"dryrun {arch} {shape} 16x16: {cell_s:.1f} s (build "
        f"{rec['t_build_s']:.1f} s, counted meta run {rec['t_count_s']:.1f}"
        f" s, {rec['n_ops']} ops); per device {rec['hlo_flops']:.6e} flop, "
        f"{rec['hlo_bytes']:.6e} B, useful {rec['useful_ratio']:.4f}")
    _one_card_bound(get_config("qwen2-0.5b"), train_step_ms)


# ---------------------------------------------------------------------------
# parallel execution on rank-stacked meshes (every rank on this card)
# ---------------------------------------------------------------------------
class _CountCalls:
    """Count the calls of module-level functions made inside the block;
    the mesh branches look them up on their module at call time, so a
    silent fall-through to the meshless path shows as no call."""

    def __init__(self, *targets):
        self.targets, self.calls = targets, {}

    def __enter__(self):
        self._orig = []
        for mod, name in self.targets:
            fn = getattr(mod, name)
            self._orig.append((mod, name, fn))
            self.calls[name] = 0

            def counted(*a, _fn=fn, _name=name, **kw):
                self.calls[_name] += 1
                return _fn(*a, **kw)

            setattr(mod, name, counted)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self._orig:
            setattr(mod, name, fn)


def _mesh(spec):
    from repro_torch.parallel import Mesh
    return Mesh(*spec)


def _tokens(seed, vocab, b, s):
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.integers(0, vocab, (b, s)), device="cuda")


def _grads(fn, params):
    """(fn(params) detached, d fn / d every param leaf)."""
    import torch
    from repro_torch.models.common import tree_leaves
    leaves = list(tree_leaves(params))
    for t in leaves:
        t.requires_grad_(True)
    try:
        out = fn(params)
        grads = torch.autograd.grad(out, leaves, allow_unused=True,
                                    materialize_grads=True)
    finally:
        for t in leaves:
            t.requires_grad_(False)
    return out.detach(), grads


def phase_pp():
    """Pipeline parallelism: qwen2-0.5b at full width and depth over the
    (pipe=4, data=2) mesh, 6 periods a stage, batch 8 x 1024 in 8
    micro-batches: ``pp_loss`` forward and backward through the GPipe
    schedule over LCX puts, timed; its puts, busy share and peak memory;
    the bf16 loss against ``loss_fn``'s; then in f32 cut to 4 layers the
    logits and every gradient against ``apply_model`` and ``loss_fn``."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.data import make_batch, to_device
    from repro_torch.models import apply_model, init_model, loss_fn
    from repro_torch.parallel import use_mesh
    from repro_torch.parallel.pp import pp_apply_model, pp_loss

    mesh = _mesh(PP_MESH)
    cfg = get_config("qwen2-0.5b")
    params = init_model(torch.Generator(device="cuda").manual_seed(0), cfg,
                        device="cuda")
    batch = to_device(make_batch(cfg, PP_SEQ, PP_BATCH), torch.device("cuda"))
    n = mesh.shape["pipe"]
    log(f"pp: {cfg.name} full width, {cfg.n_layers} layers over mesh "
        f"{mesh.shape} ({cfg.n_layers // n} periods a stage), batch "
        f"{PP_BATCH} x {PP_SEQ} in {PP_MICRO} micro-batches, "
        f"{str(cfg.dtype)[6:]}")

    def step():
        with use_mesh(mesh):
            return _grads(lambda p: pp_loss(cfg, p, batch, mesh=mesh,
                                            n_micro=PP_MICRO), params)

    _, warm_ms = _host_ms(step)                     # warm-up
    torch.cuda.reset_peak_memory_stats()
    with _RecordRuntimes() as rec:
        (loss, grads), ms = _host_ms(step)
    puts = [d.stats["transfers"] for rt in rec.made if rt.name == "gpipe"
            for d in rt.devices()]
    peak = torch.cuda.max_memory_allocated()
    require(len(rec.made) == 1 and sum(puts) == PP_MICRO + n - 1,
            f"pp: runtimes {[rt.name for rt in rec.made]}, puts {puts}")
    del grads
    _profiled(f"{cfg.name} pp_loss forward + backward", step, cpu=False)
    with torch.no_grad():
        ref = loss_fn(cfg, params, batch)[0]
    rel = abs(float(loss) - float(ref)) / abs(float(ref))
    log(f"pp: pp_loss forward + backward host {ms:.3f} ms (the first, "
        f"warm-up run {warm_ms:.3f} ms) "
        f"({PP_BATCH * PP_SEQ / ms * 1e3:.1f} tokens/s); LCX puts {sum(puts)}"
        f" (M + n - 1 = {PP_MICRO + n - 1} ticks, one put each); "
        f"max_memory_allocated {peak} bytes; loss {float(loss):.6f}, "
        f"loss_fn {float(ref):.6f} (relative difference {rel:.3e}, bound "
        f"{PP_LOSS_RTOL}); card {smi()}")
    require(rel <= PP_LOSS_RTOL, "pp_loss differs from loss_fn")
    del params, batch
    release()
    t0 = time.perf_counter()

    cfg = dataclasses.replace(cfg, n_layers=PP_CHECK_LAYERS,
                              dtype=torch.float32, param_dtype=torch.float32)
    params = init_model(torch.Generator(device="cuda").manual_seed(0), cfg,
                        device="cuda")
    batch = to_device(make_batch(cfg, PP_SEQ, PP_BATCH), torch.device("cuda"))
    with use_mesh(mesh), torch.no_grad():
        got = pp_apply_model(cfg, params, batch["tokens"], mesh=mesh,
                             n_micro=PP_MICRO)
    with torch.no_grad():
        want = apply_model(cfg, params, batch["tokens"])[0]
    logit_err = float((got - want).abs().max())
    del got, want
    with use_mesh(mesh):
        pl, pg = _grads(lambda p: pp_loss(cfg, p, batch, mesh=mesh,
                                          n_micro=PP_MICRO), params)
    rl, rg = _grads(lambda p: loss_fn(cfg, p, batch)[0], params)
    grad_err = max(float((a - b).abs().max()) for a, b in zip(pg, rg))
    log(f"pp check: f32, {PP_CHECK_LAYERS} layers, 1 period a stage: "
        f"logits max_abs_err {logit_err:.3e}, every gradient max_abs_err "
        f"{grad_err:.3e} (bound {PP_CHECK_TOL}); loss {float(pl):.6f} vs "
        f"{float(rl):.6f}; {time.perf_counter() - t0:.1f} s")
    require(logit_err <= PP_CHECK_TOL and grad_err <= PP_CHECK_TOL,
            "pipeline-parallel logits or gradients differ")


def phase_gpipe_failover():
    """GPipe over 4 stages in f32 with the stage device frozen before
    tick 0 (tests/test_failover.py's case) at qwen2-0.5b's width: the
    heartbeat migrates its transfers to the warm standby, the outputs
    equal the sequential stack, one failover."""
    import torch
    import repro_torch.core as lcx
    from repro_torch.parallel.pipeline import gpipe

    from repro_torch.configs.base import get_config
    gen = torch.Generator(device="cuda").manual_seed(7)
    n, d = 4, get_config("qwen2-0.5b").d_model
    ws = torch.randn((n, d, d), generator=gen, device="cuda") * d ** -0.5
    micro = torch.randn((6, 8, d), generator=gen, device="cuda")
    rt = lcx.Runtime(name="gp-fo")
    dev = rt.device(axis="pipe")
    dev.freeze()
    out, ms = _host_ms(lambda: gpipe(lambda w, x: torch.tanh(x @ w), ws,
                                     micro, axis="pipe", runtime=rt,
                                     device=dev, failover=True))
    ref = micro
    for i in range(n):
        ref = torch.tanh(ref @ ws[i])
    err = float((out - ref[None]).abs().max())
    log(f"gpipe failover: {n} stages x [{d}, {d}] f32, 6 micro-batches of "
        f"8; device frozen before tick 0: host {ms:.3f} ms, failovers "
        f"{rt.failover_stats['failovers']}, migrated "
        f"{dev.migrated_to is not None}; outputs vs the sequential stack "
        f"max_abs_err {err:.3e} (bound {GPIPE_TOL})")
    require(err <= GPIPE_TOL and rt.failover_stats["failovers"] == 1
            and not dev.alive and dev.migrated_to is not None,
            "gpipe failover")


def _decode_ticks(cfg, params, nxt, caches, start, ticks, kernels, mesh,
                  rules):
    """``ticks`` greedy decode steps from ``nxt`` (under the mesh when
    given) -> (tokens [B, ticks], host ms of each tick)."""
    import contextlib
    import torch
    from repro_torch.models import decode_step
    from repro_torch.parallel import use_mesh
    toks, times = [], []
    for i in range(ticks):
        ctx = use_mesh(mesh, rules) if mesh else contextlib.nullcontext()
        with ctx:
            (lg, caches), ms = _host_ms(lambda: decode_step(
                cfg, params, nxt, caches, start + i, kernels=kernels))
        nxt = lg[:, -1].argmax(-1)[:, None]
        toks.append(nxt)
        times.append(ms)
    return torch.cat(toks, 1), times


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


def _decode_check(label, cfg, prompt_len, ticks, targets):
    """f32: prefill, then ``ticks`` decode ticks under the (data=2,
    model=4) mesh with ``decode_rules`` and without; every tick's logits
    within MESH_DECODE_TOL, the greedy tokens equal, each mesh branch of
    ``targets`` taken."""
    import torch
    from repro_torch.kernels import model_kernels
    from repro_torch.launch.steps import decode_rules
    from repro_torch.models import decode_step, init_cache, init_model, prefill
    from repro_torch.parallel import use_mesh

    mesh = _mesh(CP_MESH)
    rules = decode_rules(cfg, mesh)
    kernels = model_kernels(cfg)
    params = init_model(torch.Generator(device="cuda").manual_seed(0), cfg,
                        device="cuda")
    toks = _tokens(3, cfg.vocab, CP_BATCH, prompt_len)
    caches = init_cache(cfg, CP_BATCH, CP_CHECK_SMAX, device="cuda")
    lg, caches = prefill(cfg, params, toks, caches, kernels=kernels)
    nxt = lg[:, -1].argmax(-1)[:, None]
    plain = _clone(caches)
    errs, same = [], True
    with _CountCalls(*targets) as cc:
        for i in range(ticks):
            with use_mesh(mesh, rules):
                got = decode_step(cfg, params, nxt, caches, prompt_len + i,
                                  kernels=kernels)[0]
            want = decode_step(cfg, params, nxt, plain, prompt_len + i,
                               kernels=kernels)[0]
            errs.append(float((got - want).abs().max()))
            nxt_mesh = got[:, -1].argmax(-1)
            nxt = want[:, -1].argmax(-1)
            same = same and bool(torch.equal(nxt_mesh, nxt))
            nxt = nxt[:, None]
    log(f"{label} check: f32 {cfg.name} ({cfg.n_layers} layers), prefill "
        f"{prompt_len} tokens then {ticks} ticks of {CP_BATCH} under mesh "
        f"{mesh.shape} vs no mesh: logits max_abs_err {max(errs):.3e} "
        f"(bound {MESH_DECODE_TOL}), greedy tokens equal {same}; mesh "
        f"branch calls {cc.calls}")
    require(max(errs) <= MESH_DECODE_TOL and same,
            f"{label}: the mesh decode differs from the meshless one")
    require(all(cc.calls.values()), f"{label}: a mesh branch was not taken")


def phase_cp_decode():
    """Context-parallel decode: qwen2-0.5b at full width and depth under
    the (data=2, model=4) mesh with ``decode_rules``: its 2 KV heads do
    not split 4 ways, so the cache is sequence-sharded.  Prefill 8 x 512
    with the flash kernel (24 launches), then 32 greedy ticks with and
    without the mesh; the f32 check at 2 layers.  Returns the flash
    launches."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import model_kernels
    from repro_torch.launch.steps import decode_rules
    from repro_torch.models import attention, init_cache, init_model, prefill

    mesh = _mesh(CP_MESH)
    cfg = get_config("qwen2-0.5b")
    rules = decode_rules(cfg, mesh)
    require(rules.get("cache_seq") == ("model",), f"rules {rules}")
    params = init_model(torch.Generator(device="cuda").manual_seed(0), cfg,
                        device="cuda")
    kernels = model_kernels(cfg)
    toks = _tokens(4, cfg.vocab, CP_BATCH, CP_PROMPT)
    caches = init_cache(cfg, CP_BATCH, CP_SMAX, device="cuda")
    reset_counts()
    (lg, caches), pre_ms = _host_ms(lambda: prefill(cfg, params, toks, caches,
                                                    kernels=kernels))
    counts = read_counts()
    want = expected_launches(cfg, 1)
    require(counts == want, f"cp prefill launches {counts}, want {want}")
    nxt = lg[:, -1].argmax(-1)[:, None]
    plain = _clone(caches)
    _decode_ticks(cfg, params, nxt, _clone(caches), CP_PROMPT, 2, kernels,
                  mesh, rules)                      # warm-up
    with _CountCalls((attention, "attn_decode_sharded")) as cc:
        mt, m_ms = _decode_ticks(cfg, params, nxt, caches, CP_PROMPT,
                                    CP_TICKS, kernels, mesh, rules)
    calls = cc.calls["attn_decode_sharded"]
    pt, p_ms = _decode_ticks(cfg, params, nxt, plain, CP_PROMPT, CP_TICKS,
                                kernels, None, None)
    agree = float((mt == pt).float().mean())
    mean = lambda t: sum(t[1:]) / (len(t) - 1)
    log(f"cp decode: {cfg.name} full width, {cfg.n_layers} layers, mesh "
        f"{mesh.shape}, rules {rules}; prefill {CP_BATCH} x {CP_PROMPT} "
        f"{pre_ms:.3f} ms with launches {counts}; {CP_TICKS} ticks of "
        f"{CP_BATCH}: mean tick (after the first) {mean(m_ms):.3f} ms with "
        f"the mesh, {mean(p_ms):.3f} ms without; attn_decode_sharded calls "
        f"{calls} ({cfg.n_layers} a tick); greedy tokens equal to the "
        f"meshless run's: {100 * agree:.1f}% (bf16); card {smi()}")
    require(calls == cfg.n_layers * CP_TICKS, "cp decode: the mesh branch "
            "was not taken on every layer and tick")
    del params, caches, plain
    release()
    _decode_check("cp decode", dataclasses.replace(
        cfg, n_layers=CP_CHECK_LAYERS, dtype=torch.float32,
        param_dtype=torch.float32), CP_CHECK_PROMPT, CP_CHECK_TICKS,
        [(attention, "attn_decode_sharded")])
    return counts["flash_attention"]


def phase_resident_decode(cfg, params):
    """Resident-expert decode with the context-parallel MLA decode:
    deepseek-v3-671b at full width cut to its 5 layers (2 MoE; ``cfg``
    and ``params`` of the serve phase) under the (data=2, model=4) mesh
    with ``decode_rules``: the experts resident on (model, data), 32 a
    rank; the latent cache sequence-sharded.  8 sequences, 16 greedy
    ticks with and without the mesh; the MoE layer against the meshless
    decode at a batch where their capacities agree; the f32 check at the
    smoke config.  Returns the grouped matmul's launches in the ticks."""
    import torch
    from repro_torch.configs.base import get_config, get_smoke_config
    from repro_torch.kernels import model_kernels
    from repro_torch.launch.steps import decode_rules
    from repro_torch.models import init_cache, mla, moe, prefill
    from repro_torch.parallel import use_mesh

    mesh = _mesh(CP_MESH)
    full = get_config("deepseek-v3-671b")
    rules = decode_rules(cfg, mesh)
    axes, n_owner = moe.resident_axes(mesh, cfg.n_experts)
    n_moe = sum(l.ffn == "moe" for l in cfg.layer_plan())
    slab = (cfg.n_experts // n_owner) * 3 * cfg.d_model * cfg.moe_d_ff \
        * torch.empty((), dtype=cfg.param_dtype).element_size() * n_moe
    log(f"resident decode: {cfg.name} cut to {cfg.n_layers} of "
        f"{full.n_layers} layers ({n_moe} MoE), mesh {mesh.shape}: "
        f"resident_plan {moe.resident_plan(cfg, mesh)}, "
        f"{cfg.n_experts // n_owner} experts a rank of {n_owner}, slab "
        f"{slab} bytes (budget {moe.RESIDENT_BUDGET_BYTES}); rules {rules}")
    require(rules.get("experts") == axes == ("model", "data")
            and rules.get("cache_seq") == ("model",)
            and slab <= moe.RESIDENT_BUDGET_BYTES, "resident plan")
    kernels = model_kernels(cfg)
    toks = _tokens(5, cfg.vocab, RES_BATCH, RES_PROMPT)
    caches = init_cache(cfg, RES_BATCH, SERVE_MAX_SEQ, device="cuda")
    lg, caches = prefill(cfg, params, toks, caches, kernels=kernels)
    nxt = lg[:, -1].argmax(-1)[:, None]
    plain = _clone(caches)

    # the MoE layer alone: at B = 8, capacity(cfg, B) (the mesh's
    # resident decode) equals decode_capacity (the meshless decode), so
    # the two branches give one result
    p = params["stack"][0]["l0"]["ffn"]
    x = torch.randn((RES_BATCH, 1, cfg.d_model), device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(8)
                    ).to(cfg.dtype)
    cap = moe.capacity(cfg, RES_BATCH)
    require(cap == moe.decode_capacity(cfg, RES_BATCH),
            f"capacity {cap} differs from the decode capacity")
    with use_mesh(mesh, rules), _CountCalls(
            (moe, "_moe_resident_decode")) as cc, torch.no_grad():
        y = moe.moe_apply(cfg, p, x, kernel_fn=kernels["moe_gmm"],
                          decode=True)[0]
    with torch.no_grad():
        ref = moe.moe_apply(cfg, p, x, kernel_fn=kernels["moe_gmm"],
                            decode=True)[0]
    require(cc.calls["_moe_resident_decode"] == 1 and torch.equal(y, ref),
            "the resident decode differs from the meshless decode")
    log(f"resident decode: one MoE layer at B = {RES_BATCH} (capacity "
        f"{cap}) equals the meshless decode bit for bit")

    _decode_ticks(cfg, params, nxt, _clone(caches), RES_PROMPT, 2, kernels,
                  mesh, rules)                      # warm-up
    reset_counts()
    with _CountCalls((moe, "_moe_resident_decode"),
                     (mla, "_mla_decode_sharded")) as cc:
        mt, m_ms = _decode_ticks(cfg, params, nxt, caches, RES_PROMPT,
                                    RES_TICKS, kernels, mesh, rules)
    gmm = read_counts()["moe_gmm"]
    pt, p_ms = _decode_ticks(cfg, params, nxt, plain, RES_PROMPT,
                                RES_TICKS, kernels, None, None)
    agree = float((mt == pt).float().mean())
    mean = lambda t: sum(t[1:]) / (len(t) - 1)
    log(f"resident decode: {RES_TICKS} ticks of {RES_BATCH} after a "
        f"{RES_PROMPT}-token prefill: mean tick (after the first) "
        f"{mean(m_ms):.3f} ms with the mesh, {mean(p_ms):.3f} ms without; "
        f"gmm launches {gmm} ({3 * n_moe} a tick); mesh branch calls "
        f"{cc.calls}; greedy tokens equal to the meshless run's: "
        f"{100 * agree:.1f}% (bf16); card {smi()}")
    require(gmm == 3 * n_moe * RES_TICKS
            and cc.calls["_moe_resident_decode"] == n_moe * RES_TICKS
            and cc.calls["_mla_decode_sharded"] == cfg.n_layers * RES_TICKS,
            "resident decode: a mesh branch was not taken")
    del caches, plain, p
    release()
    _decode_check("resident decode", dataclasses.replace(
        get_smoke_config("deepseek-v3-671b"), moe_backend="lcx"),
        CP_CHECK_PROMPT, CP_CHECK_TICKS,
        [(moe, "_moe_resident_decode"), (mla, "_mla_decode_sharded")])
    return gmm


def phase_ep_mesh():
    """Expert parallelism through ``moe_apply``: qwen3-moe-30b-a3b at full
    width and depth, prefill of 8 x 512 under the (data=2, model=4) mesh:
    each MoE layer's ``_moe_ep`` splits the batch over data and the
    sequence over model, 512 tokens a rank (C = 40), the grouped matmul
    over [128, 2 x 4 x 40, d] (3 launches a layer).  Prefill ms with and
    without the mesh, tokens dropped (the gmm is timed at this shape with
    the other kernel checks); the f32 check at the smoke config with
    capacity factor 16.  Returns the flash and gmm launches and the MoE
    layers."""
    import torch
    from repro_torch.configs.base import get_config, get_smoke_config
    from repro_torch.kernels import model_kernels
    from repro_torch.models import (apply_model, init_cache, init_model, moe,
                                    prefill)
    from repro_torch.parallel import use_mesh

    mesh = _mesh(CP_MESH)
    cfg = get_config("qwen3-moe-30b-a3b")
    params = init_model(torch.Generator(device="cuda").manual_seed(0), cfg,
                        device="cuda")
    ep, dp = mesh.shape["model"], mesh.shape["data"]
    t_loc = EP_MESH_BATCH // dp * (EP_MESH_SEQ // ep)
    C = moe.capacity(cfg, t_loc)
    kernels = model_kernels(cfg)
    toks = _tokens(6, cfg.vocab, EP_MESH_BATCH, EP_MESH_SEQ)
    caches = init_cache(cfg, EP_MESH_BATCH, EP_MESH_SEQ, device="cuda")
    run = lambda: prefill(cfg, params, toks, caches, kernels=kernels)
    with use_mesh(mesh):
        run()                                       # warm-up
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with use_mesh(mesh), _CountCalls((moe, "_moe_ep")) as cc, \
            _RecordRoutes(t_loc) as routes:
        (lg, _), ms = _host_ms(run)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    n_moe = sum(l.ffn == "moe" for l in cfg.layer_plan())
    want = expected_launches(cfg, 1)
    require(cc.calls["_moe_ep"] == n_moe and counts == want,
            f"ep mesh: _moe_ep calls {cc.calls}, launches {counts}, want "
            f"{want}")
    dropped = sum(int((torch.bincount(i.reshape(-1), minlength=cfg.n_experts)
                       - C).clamp_min(0).sum()) for i in routes.ids)
    assigned = sum(i.numel() for i in routes.ids)
    require(len(routes.ids) == n_moe * dp * ep, f"{len(routes.ids)} routes")
    _, plain_ms = _host_ms(run)
    log(f"ep mesh: {cfg.name} full width, {cfg.n_layers} layers, prefill "
        f"{EP_MESH_BATCH} x {EP_MESH_SEQ} under mesh {mesh.shape}: "
        f"{t_loc} tokens a rank, capacity {C}, the gmm on [{cfg.n_experts}, "
        f"{dp * ep * C}, d] ({dp} data groups of [{cfg.n_experts}, "
        f"{ep * C}, d]); prefill {ms:.3f} ms with the mesh, {plain_ms:.3f} "
        f"ms without (the sort path over all {EP_MESH_BATCH * EP_MESH_SEQ} "
        f"tokens); _moe_ep calls {cc.calls['_moe_ep']}; launches {counts}; "
        f"tokens dropped {dropped} of {assigned} assignments; "
        f"max_memory_allocated {peak} bytes; card {smi()}")
    del params, caches, lg
    release()

    small = dataclasses.replace(get_smoke_config("qwen3-moe-30b-a3b"),
                                moe_backend="lcx", capacity_factor=16.0)
    sp = init_model(torch.Generator(device="cuda").manual_seed(0), small,
                    device="cuda")
    st = _tokens(7, small.vocab, EP_MESH_BATCH, 16)
    sk = model_kernels(small)
    with torch.no_grad():
        with use_mesh(mesh), _CountCalls((moe, "_moe_ep")) as cc:
            got = apply_model(small, sp, st, kernels=sk)[0]
        want = apply_model(dataclasses.replace(small, moe_backend="sort"),
                           sp, st, kernels=sk)[0]
    err = float((got - want).abs().max())
    log(f"ep mesh check: f32 {small.name} ({small.n_layers} layers, "
        f"capacity factor 16), apply_model on {EP_MESH_BATCH} x 16 under the "
        f"mesh vs the sort path: max_abs_err {err:.3e} (bound {EP_MESH_TOL});"
        f" _moe_ep calls {cc.calls['_moe_ep']}")
    require(err <= EP_MESH_TOL and cc.calls["_moe_ep"] == small.n_layers,
            "the expert-parallel MoE differs from the sort path")
    return counts["flash_attention"], counts["moe_gmm"], n_moe


def phase_compressed_psum():
    """``compressed_psum`` of qwen2-0.5b's full gradient (every parameter
    tensor, random f32 gradients) over 4 stacked ranks: host ms, and each
    element's mean within half the shared int8 step of the exact one."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.core import ranks
    from repro_torch.models import abstract_init
    from repro_torch.models.common import tree_leaves
    from repro_torch.optim import compressed_psum

    cfg = get_config("qwen2-0.5b")
    gen = torch.Generator(device="cuda").manual_seed(9)
    shapes = [t.shape for t in tree_leaves(abstract_init(cfg)[0])]
    xs = [torch.randn((PSUM_RANKS,) + tuple(s), generator=gen,
                      device="cuda") * 1e-3 for s in shapes]
    n_params = sum(x[0].numel() for x in xs)
    with ranks.bind_axis("dp", PSUM_RANKS):
        compressed_psum(xs[0], "dp")                # warm-up
        outs, ms = _host_ms(lambda: [compressed_psum(x, "dp")[0]
                                     for x in xs])
    worst = 0.0
    for x, out in zip(xs, outs):
        scale = float(x.abs().max()) / 127.0
        exact = x.double().mean(0)
        err = (out.double() - exact).abs().max(dim=-1).values
        bound = scale / 2 + 2.0 ** -24 * float(x.abs().max())
        require(bool((err <= bound).all()) and bool((out == out[:1]).all()),
                "compressed_psum's mean is off by more than half a step")
        worst = max(worst, float(err.max()) / scale)
    log(f"compressed psum: {cfg.name}'s full gradient ({len(xs)} tensors, "
        f"{n_params} f32 parameters) over {PSUM_RANKS} stacked ranks: host "
        f"{ms:.3f} ms; largest error against the exact mean {worst:.4f} of "
        f"the tensor's int8 step (bound 0.5); card {smi()}")
    require(n_params == QWEN_PARAMS, f"{n_params} parameters")


def phase_trainer_mesh():
    """``Trainer(mesh=(data=4, model=2))``, qwen2-0.5b at full width and
    depth: 2 steps, ``remesh`` to ``shrink_mesh_shape(..., lost=4)``, 2
    more; the losses bitwise equal to an unmeshed run's."""
    from repro_torch.runtime import Trainer, shrink_mesh_shape

    mesh = _mesh(TRAIN_MESH)
    cfg, tcfg = _train_cfg("qwen2-0.5b", 2 * TRAIN_MESH_STEPS)
    tr = Trainer(cfg, tcfg, mesh=mesh, device="cuda")
    try:
        tr._run_until(TRAIN_MESH_STEPS)
        shape = shrink_mesh_shape(dict(mesh.shape), lost=TRAIN_MESH_LOST)
        _, remesh_ms = _host_ms(lambda: tr.remesh(
            _mesh((tuple(shape.values()), tuple(shape)))))
        tr._run_until(2 * TRAIN_MESH_STEPS)
        specs = {k: tuple(v.spec) for k, v in tr.batch_sharding().items()}
        meshed = [(m["loss"], m["dt"]) for m in tr.metrics_log]
    finally:
        tr.remesh(None)               # stops its loader, clears the mesh
    del tr
    release()
    ref = Trainer(cfg, tcfg, device="cuda")
    ref._run_until(2 * TRAIN_MESH_STEPS)
    plain = [m["loss"] for m in ref.metrics_log]
    log(f"trainer mesh: {cfg.name} on mesh {mesh.shape} for "
        f"{TRAIN_MESH_STEPS} steps, remesh to {shape} ({remesh_ms:.3f} ms; "
        f"batch specs {specs}), {TRAIN_MESH_STEPS} more: losses "
        f"{[l for l, _ in meshed]}, step ms "
        f"{[round(dt * 1e3, 3) for _, dt in meshed]}; unmeshed run "
        f"{plain}")
    require([l for l, _ in meshed] == plain,
            "the meshed trainer's losses differ from the unmeshed run's")
    del ref
    release()
    _trainer_mesh_moe(mesh)


def _trainer_mesh_moe(mesh):
    """A MoE model trains through ``_moe_ep`` under the mesh: autograd
    through the LCX all-to-alls, and remat recomputing each period under
    its forward's mesh.  f32 at qwen3-moe-30b-a3b's smoke config with
    the ``lcx`` backend, capacity factor 16 (no token drops) and aux
    coefficient 0, so that the meshed and the unmeshed run compute one
    function: 2 steps of each, losses within 5e-5 and params within
    2e-4 (the reference's tolerance for a sharded step)."""
    import torch
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.models import moe
    from repro_torch.models.common import tree_leaves
    from repro_torch.runtime import TrainConfig, Trainer

    cfg = dataclasses.replace(get_smoke_config("qwen3-moe-30b-a3b"),
                              moe_backend="lcx", capacity_factor=16.0,
                              aux_loss_coef=0.0)
    tcfg = TrainConfig(lr=1e-3, warmup=0, total_steps=TRAIN_MESH_STEPS,
                       seq_len=64, global_batch=8, log_every=1)
    n_moe = sum(l.ffn == "moe" for l in cfg.layer_plan())
    with _CountCalls((moe, "_moe_ep")) as cc:
        tr = Trainer(cfg, tcfg, mesh=mesh, device="cuda")
        try:
            tr._run_until(TRAIN_MESH_STEPS)
        finally:
            tr.remesh(None)
    ref = Trainer(cfg, tcfg, device="cuda")
    ref._run_until(TRAIN_MESH_STEPS)
    got = [m["loss"] for m in tr.metrics_log]
    want = [m["loss"] for m in ref.metrics_log]
    loss_err = max(abs(a - b) for a, b in zip(got, want))
    with torch.no_grad():
        param_err = max(float((a - b).abs().max()) for a, b in
                        zip(tree_leaves(tr.params), tree_leaves(ref.params)))
    # remat "full" runs each MoE layer again in the backward
    calls = n_moe * TRAIN_MESH_STEPS * (2 if cfg.remat == "full" else 1)
    log(f"trainer mesh moe: f32 {cfg.name} (lcx, capacity factor 16, aux "
        f"coefficient 0) on mesh {mesh.shape}, {TRAIN_MESH_STEPS} steps: "
        f"losses {got} vs unmeshed {want} (largest difference "
        f"{loss_err:.3e}, bound {EP_MESH_TOL}); params after: max_abs_err "
        f"{param_err:.3e} (bound {TRAIN_MESH_PARAM_TOL}); _moe_ep calls "
        f"{cc.calls['_moe_ep']} (want {calls})")
    require(cc.calls["_moe_ep"] == calls and len(got) == TRAIN_MESH_STEPS
            and loss_err <= EP_MESH_TOL
            and param_err <= TRAIN_MESH_PARAM_TOL,
            "the meshed MoE trainer differs from the unmeshed run")


def phase_mesh():
    """Phase 16's paths on models of their own (the resident decode runs
    on the DeepSeek-V3 serve phase's params).  pp's profile and the EP
    prefill come last (see ``main``).  Returns the flash launches of the
    context-parallel prefill, and the flash and grouped-matmul launches
    in the EP prefill and the MoE layers there."""
    flash = phase_cp_decode()
    release()
    phase_compressed_psum()
    release()
    phase_trainer_mesh()
    release()
    phase_gpipe_failover()
    release()
    phase_pp()
    release()
    ep_flash, ep_gmm, n_moe = phase_ep_mesh()
    return flash, ep_flash, ep_gmm, n_moe


def release() -> None:
    """Free the last phase's model before the next: an engine and its
    executor's task closures refer to each other, so only the garbage
    collector frees them (else the next phase's peak memory counts them)."""
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def serve_only(archs) -> int:
    """``--serve ARCH ...``: the device and build phases, then the serve
    phase of each named architecture (with the full run's depth cuts),
    one after another; no kernels line and no last line.  Copied into the
    root of another checkout, it drives that checkout's package: an A/B
    of the serving path runs it in alternating processes."""
    from repro_torch.configs.base import get_config
    if not archs:
        print("usage: chip_smoke.py [--serve ARCH ...]", file=sys.stderr)
        return 2
    phase_device()
    phase_build()
    phase_trace_cost()
    for arch in archs:
        phase_serve(arch, _prompts(get_config(arch).vocab),
                    **SERVE_CUTS.get(arch, {}))
        release()
    log(f"serve of {archs} passed")
    return 0


def main() -> int:
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found: run from a "
              f"checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    _load_peaks()
    if sys.argv[1:2] == ["--serve"]:
        return serve_only(sys.argv[2:])
    t0 = time.perf_counter()
    phase_device()
    phase_build()
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.models.moe import capacity
    mark = lambda what: log(f"time: {what} done at "
                            f"{time.perf_counter() - t0:.1f} s")
    prompts = _prompts(get_config("qwen2-0.5b").vocab)
    m_prompts = _prompts(get_config("mamba2-130m").vocab)
    moe_cfg = get_config("qwen3-moe-30b-a3b")
    moe_prompts = _prompts(moe_cfg.vocab)
    moe_caps = [capacity(moe_cfg, len(p)) for p in moe_prompts]
    # the rows an expert gets in the mesh's expert parallelism: ep ranks'
    # capacity rows a data group, the groups' in one launch
    dp, ep = CP_MESH[0]
    ep_cap = capacity(moe_cfg, EP_MESH_BATCH // dp * EP_MESH_SEQ // ep)
    ep_mesh_rows = [ep * ep_cap, dp * ep * ep_cap]
    ds_cfg = get_config("deepseek-v3-671b")
    ds_prompts = _prompts(ds_cfg.vocab)
    flash_err, flash_times = phase_kernel_check(
        [len(p) for p in prompts], [len(p) for p in moe_prompts])
    ssd = phase_ssd_check([len(p) for p in m_prompts])
    ring = phase_ring_check()
    phase_backend_xla()
    gmm_times, gmm_err, ds_times = phase_gmm_check(
        moe_caps, capacity(moe_cfg, EP_TOKENS),
        [capacity(ds_cfg, len(p)) for p in ds_prompts]
        + [capacity(ds_cfg, RES_BATCH)], ep_mesh_rows)
    decode = phase_decode_check()
    mark("kernel checks")
    phase_trace_cost()
    counts, qwen_tokens, _, _ = phase_serve("qwen2-0.5b", prompts)
    decode_launches = counts["decode_attention"]
    qwen_layers = get_config("qwen2-0.5b").n_layers
    flash_entries = [(flash_times[len(p)], qwen_layers) for p in prompts]
    flash_launches = counts["flash_attention"]
    release()
    ssd["launches"] = phase_serve("mamba2-130m", m_prompts)[0]["ssd_scan"]
    release()
    counts, _, stats, _ = phase_serve("qwen3-moe-30b-a3b", moe_prompts)
    decode_launches += counts["decode_attention"]
    moe_layers = sum(l.ffn == "moe" for l in moe_cfg.layer_plan())
    gmm_entries = [(gmm_times[c], moe_layers) for c in moe_caps]
    gmm_entries.append((gmm_times[8], moe_layers * stats["ticks"]))
    gmm_launches = counts["moe_gmm"]
    release()
    phase_greedy("qwen2-0.5b", prompts)
    release()
    phase_greedy("mamba2-130m", m_prompts)
    release()
    # capacity factor E/k: C then covers every token, so decode (T = the
    # slots) and the full-sequence apply_model (T = the length) drop none;
    # at 1.25 they drop different tokens and legitimately differ
    phase_greedy("qwen3-moe-30b-a3b", moe_prompts,
                 n_layers=MOE_GREEDY_LAYERS,
                 capacity_factor=moe_cfg.n_experts
                 / moe_cfg.n_experts_per_tok)
    release()
    phase_hybrid(m_prompts)
    release()
    phase_hybrid_moe(m_prompts)
    release()
    phase_ep()
    release()
    ring["launches"] = phase_collectives()
    release()
    phase_quickstart()
    phase_remote()
    phase_failover(prompts, qwen_tokens)
    release()
    mark("earlier slices' phases")
    # this slice: every other reference architecture, one at a time
    # and, on its params, the resident-expert decode (phase 16)
    res_gmm = phase_serve("deepseek-v3-671b", ds_prompts,
                          then=phase_resident_decode,
                          **SERVE_CUTS["deepseek-v3-671b"])[3]
    release()
    for arch in ("internlm2-20b", "starcoder2-7b", "command-r-plus-104b"):
        decode_launches += phase_serve(arch, _prompts(get_config(arch).vocab),
                                       **SERVE_CUTS.get(arch, {}))[0][
                                           "decode_attention"]
        release()
    mark("serve of the dense and MLA paths")
    for arch, cut in GREEDY_CUTS.items():
        c = get_config(arch)
        extra = ({"capacity_factor": c.n_experts / c.n_experts_per_tok}
                 if c.n_experts else {})
        phase_greedy(arch, _prompts(c.vocab), **cut, **extra)
        release()
    mark("greedy checks of the dense and MLA paths")
    phase_llava(_prompts(get_config("llava-next-mistral-7b").vocab)[0])
    release()
    phase_hubert()
    release()
    mark("frontends")
    train_step_ms = phase_train()
    mark("training")
    # this slice: the causal-skip schedule, before the mesh phases (it is
    # profiled)
    phase_causal_skip()
    mark("causal skip")
    # this slice: the mesh paths, last: the EP prefill's ~10^5 launches in
    # a second and the pp step's profile of ~8 x 10^4 kernels each leave
    # torch.profiler recording no kernel in later windows (measured on
    # this card)
    cp_flash, ep_flash, ep_gmm, ep_layers = phase_mesh()
    release()
    flash_entries += [(flash_times["cp"], cp_flash),
                      (flash_times["ep"], ep_flash)]
    flash = flash_row(flash_entries, flash_err,
                      flash_launches + cp_flash + ep_flash)
    ds_moe = sum(l.ffn == "moe" for l in dataclasses.replace(
        ds_cfg, n_layers=DSV3_SERVE_LAYERS).layer_plan())
    res_times = ds_times[capacity(ds_cfg, RES_BATCH)]
    gmm_entries += [(gmm_times[ep_mesh_rows[-1]], ep_layers),
                    (res_times, ds_moe * RES_TICKS)]
    gmm = gmm_row(gmm_entries, gmm_err, gmm_launches + ep_gmm + res_gmm)
    mark("mesh paths")
    # this slice: the example scripts in child processes and the dry run
    # (neither profiled: they may follow the mesh phases)
    phase_examples()
    mark("examples")
    phase_dryrun(train_step_ms)
    mark("dryrun")
    require("jax" not in sys.modules and "repro" not in sys.modules,
            "the reference package or JAX was imported")
    log(f"total {time.perf_counter() - t0:.1f} s")
    decode["launches"] = decode_launches      # the serve phases'
    print(json.dumps({"kernels": [flash, ssd, ring, gmm, decode]}))
    print(smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
