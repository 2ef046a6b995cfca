"""The yardstick: the H100's peaks, and the work that a model step or a
kernel launch needs, counted from the published shapes.

Everything here reads a configuration file of ``lcxbench/configs/`` (its
Hugging Face key names) and plain numbers, never the program.  A model's
operations are 2 x the matrix parameters a token passes through, plus
the work of its mixers over what each token really sees (attention: the
keys, itself included, never the ``max_seq`` padding of a cache), as the
configuration's family counts them (``families/``).  A prefill passes one
position through the head (the program keeps only the last position's
logits), a decode token one.  A kernel's work (``*_work``) is counted as
its data needs it, for ``lcxbench/kernels/``.
"""
from __future__ import annotations

from typing import Dict, Iterable, Tuple

from . import families

# NVIDIA H100 SXM5 80 GB datasheet, dense, at its 700 W limit
PEAK_FLOPS_BF16 = 989e12
PEAK_BYTES_PER_S = 3.35e12
HBM_BYTES = 80e9


def head_flops(cfg: Dict) -> int:
    return 2 * cfg["hidden_size"] * cfg["vocab_size"]


def prefill_flops(cfg: Dict, n: int) -> int:
    """One prompt of ``n`` tokens, as the configuration's family counts
    it."""
    return families.of(cfg).prefill_flops(cfg, n)


def decode_flops(cfg: Dict, lengths: Iterable[int]) -> int:
    """One decode step of the sequences whose caches hold ``lengths``
    tokens, as the configuration's family counts it."""
    return families.of(cfg).decode_flops(cfg, lengths)


def bound_s(flops: float, nbytes: float) -> float:
    """The least time: the larger of operations over the bf16 peak and
    bytes over the memory rate."""
    return max(flops / PEAK_FLOPS_BF16, nbytes / PEAK_BYTES_PER_S)


def flash_work(hq: int, hkv: int, sq: int, sk: int, d: int, causal: bool,
               esize: int = 2) -> Tuple[int, int]:
    """(operations, bytes) of one flash-attention forward: the two
    products over the (query, key) pairs the mask keeps (top-left
    aligned: row i keeps keys 0..min(i, sk - 1)); q, k, v read once and
    o written once."""
    if causal:
        m = min(sq, sk)
        pairs = m * (m + 1) // 2 + (sq - m) * sk
    else:
        pairs = sq * sk
    return 4 * hq * d * pairs, (2 * hq * sq * d + 2 * hkv * sk * d) * esize


def gmm_work(rows: int, experts: int, d_in: int, d_out: int,
             esize: int = 2) -> Tuple[int, int]:
    """(operations, bytes) of one grouped matmul as its data needs it: the
    ``rows`` routed rows (capacity padding left out) through their
    experts; the weights of the ``experts`` that at least one row chose,
    each row in and out, read or written once."""
    return (2 * rows * d_in * d_out,
            (experts * d_in * d_out + rows * d_in + rows * d_out) * esize)


def decode_attention_work(b: int, hq: int, hkv: int, hd: int, rows: int,
                          esize: int = 2) -> Tuple[int, int]:
    """(operations, bytes) of one GQA decode-attention step of ``b``
    slots whose valid cache rows number ``rows`` in all (the row written
    this step included): q.k and p.v over those rows for every query
    head; those rows of K and V read once, q, the new key and value rows,
    the RoPE cos and sin (float32, ``hd / 2`` each a slot) and the int32
    lengths read once, the output and the two cache rows written once."""
    nbytes = (2 * hkv * hd * rows * esize + 2 * b * hq * hd * esize
              + 2 * 2 * b * hkv * hd * esize + b * hd * 4 + b * 4)
    return 4 * hq * hd * rows, nbytes


def ssd_work(b: int, s: int, h: int, p: int, n: int, groups: int,
             chunk: int, esize: int = 2) -> Tuple[int, int]:
    """(operations, bytes) of one SSD chunked scan: x [b, s, h, p], dt
    (float32), A, and B and C [b, s, groups, n] (the heads of a group share
    them) read once, y and the float32 final state written once; the
    products the data needs: C.B and w.x over the pairs j <= i within each
    chunk of ``chunk`` rows, C.h and the state update B (x) x for every row
    and head."""
    nbytes = ((2 * b * s * h * p + 2 * b * s * groups * n) * esize
              + b * s * h * 4 + h * 4 + b * h * n * p * 4)
    pairs = sum(r * (r + 1) // 2 for r in
                [chunk] * (s // chunk) + ([s % chunk] if s % chunk else []))
    return b * h * (2 * (n + p) * pairs + 4 * n * p * s), nbytes
