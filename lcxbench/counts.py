"""The yardstick: the H100's peaks, and the work that a model step or a
kernel launch needs, counted from the published shapes.

Everything here reads a configuration file of ``lcxbench/configs/`` (its
Hugging Face key names) and plain numbers, never the program.  A model's
operations are 2 x the matrix parameters a token passes through, plus
attention over the keys the token really sees (``ctx``, itself included;
a prefill of ``n`` tokens sees ``n (n + 1) / 2`` pairs), never the
``max_seq`` padding of a cache.  Multi-head latent attention is counted
in its published form (keys and values up-projected from the latent),
whatever form the program computes.  A prefill passes one position
through the head (the program keeps only the last position's logits), a
decode token one.
"""
from __future__ import annotations

from typing import Dict, Iterable, Tuple

# NVIDIA H100 SXM5 80 GB datasheet, dense, at its 700 W limit
PEAK_FLOPS_BF16 = 989e12
PEAK_BYTES_PER_S = 3.35e12
HBM_BYTES = 80e9


def mixer_params(cfg: Dict) -> int:
    """Matrix parameters of one attention layer that a token passes
    through."""
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    if cfg.get("kv_lora_rank"):
        ql, kl = cfg["q_lora_rank"], cfg["kv_lora_rank"]
        nope, rope = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
        v = cfg["v_head_dim"]
        return (d * ql + ql * h * (nope + rope) + d * (kl + rope)
                + kl * h * nope + kl * h * v + h * v * d)
    hd = cfg.get("head_dim") or d // h
    hkv = cfg["num_key_value_heads"]
    return d * h * hd + 2 * d * hkv * hd + h * hd * d


def attn_flops_per_key(cfg: Dict) -> int:
    """Operations of one token against one key: q.k and p.v over every
    head."""
    h = cfg["num_attention_heads"]
    if cfg.get("kv_lora_rank"):
        qk = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
        return 2 * h * (qk + cfg["v_head_dim"])
    hd = cfg.get("head_dim") or cfg["hidden_size"] // h
    return 4 * h * hd


def ffn_params(cfg: Dict, moe: bool) -> int:
    """Matrix parameters of one FFN that a token passes through: the
    router, its ``num_experts_per_tok`` experts and the shared ones in an
    expert layer."""
    d = cfg["hidden_size"]
    if not moe:
        return 3 * d * cfg["intermediate_size"]
    f = cfg["moe_intermediate_size"]
    return (d * cfg["n_routed_experts"]
            + (cfg["num_experts_per_tok"] + cfg.get("n_shared_experts", 0))
            * 3 * d * f)


def body_params(cfg: Dict) -> int:
    """Matrix parameters a token passes through below the head."""
    n = cfg["num_hidden_layers"]
    dense = cfg.get("first_k_dense_replace", 0) if cfg.get(
        "n_routed_experts") else n
    moe = n - dense
    return (n * mixer_params(cfg) + dense * ffn_params(cfg, False)
            + (moe * ffn_params(cfg, True) if moe else 0))


def head_flops(cfg: Dict) -> int:
    return 2 * cfg["hidden_size"] * cfg["vocab_size"]


def prefill_flops(cfg: Dict, n: int) -> int:
    """One prompt of ``n`` tokens: every token through the body, causal
    attention over ``n (n + 1) / 2`` pairs a layer, one position through
    the head."""
    return (2 * body_params(cfg) * n
            + attn_flops_per_key(cfg) * cfg["num_hidden_layers"]
            * n * (n + 1) // 2
            + head_flops(cfg))


def decode_flops(cfg: Dict, lengths: Iterable[int]) -> int:
    """One decode step of the sequences whose caches hold ``lengths``
    tokens: each new token attends to ``length + 1`` keys and passes
    through the head."""
    lengths = list(lengths)
    return (len(lengths) * (2 * body_params(cfg) + head_flops(cfg))
            + attn_flops_per_key(cfg) * cfg["num_hidden_layers"]
            * sum(n + 1 for n in lengths))


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
