"""The decoder family: every layer a GQA or latent-attention (MLA) mixer
and a dense SiLU-gated MLP or an expert layer (DeepSeek's keys:
``n_routed_experts``, ``moe_intermediate_size``, ``n_shared_experts``,
``first_k_dense_replace``).  DeepSeek-V3 and InternLM2 are of it.

The layout: ``embed.emb [V, d]``; ``prefix_<i>`` for the leading dense
layers of an expert model; ``stack``, a list with one ``{"l0": layer}``
per layer after them; ``final_norm.g``; ``head.w [d, V]``.  A layer is
``norm1``, ``mixer`` (GQA: ``wq wk wv wo``; MLA: ``w_dq qnorm w_uq w_dkv
kvnorm w_uk w_uv wo``), ``norm2`` and ``ffn`` (dense: ``gate up down``;
experts: ``router`` in float32, ``w_gate w_up w_down`` stacked ``[E,
...]``, ``shared_gate shared_up shared_down``).

The counts: 2 x the matrix parameters a token passes through, plus
attention over the keys it sees (``ctx``, itself included; a prefill of
``n`` tokens sees ``n (n + 1) / 2`` pairs); MLA in its published form
(keys and values up-projected from the latent), whatever form the
program computes.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, List, Tuple

from ..counts import head_flops
from ..weights import Leaf, dense, norm

fields: Dict[str, str] = {}
program: Dict = {}


def routed_experts(cfg: Dict) -> int:
    return cfg.get("n_routed_experts") or 0


def _n_dense(cfg: Dict) -> int:
    """Layers before the first expert layer (all of them without
    experts)."""
    if not routed_experts(cfg):
        return cfg["num_hidden_layers"]
    return cfg.get("first_k_dense_replace", 0)


def layer_kinds(cfg: Dict) -> List[Tuple[str, str]]:
    mixer = "mla" if cfg.get("kv_lora_rank") else "attn"
    k = _n_dense(cfg)
    return [(mixer, "dense" if i < k else "moe")
            for i in range(cfg["num_hidden_layers"])]


# -- the weights -----------------------------------------------------------
def _mixer(cfg: Dict, p) -> List[Leaf]:
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    if cfg.get("kv_lora_rank"):
        ql, kl = cfg["q_lora_rank"], cfg["kv_lora_rank"]
        nope, rope = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
        v = cfg["v_head_dim"]
        return [dense(p + ("w_dq",), d, ql), norm(p + ("qnorm",), ql),
                dense(p + ("w_uq",), ql, h * (nope + rope)),
                dense(p + ("w_dkv",), d, kl + rope),
                norm(p + ("kvnorm",), kl),
                dense(p + ("w_uk",), kl, h * nope),
                dense(p + ("w_uv",), kl, h * v),
                dense(p + ("wo",), h * v, d)]
    hd = cfg.get("head_dim") or d // h
    hkv = cfg["num_key_value_heads"]
    return [dense(p + ("wq",), d, h * hd), dense(p + ("wk",), d, hkv * hd),
            dense(p + ("wv",), d, hkv * hd), dense(p + ("wo",), h * hd, d)]


def _ffn(cfg: Dict, p, moe: bool) -> List[Leaf]:
    d = cfg["hidden_size"]
    if not moe:
        f = cfg["intermediate_size"]
        return [dense(p + ("gate",), d, f), dense(p + ("up",), d, f),
                dense(p + ("down",), f, d)]
    e, f = cfg["n_routed_experts"], cfg["moe_intermediate_size"]
    fs = cfg.get("n_shared_experts", 0) * f
    out = [(p + ("router", "w"), (d, e), "float32", 1.0 / math.sqrt(d)),
           (p + ("w_gate", "w"), (e, d, f), "normal", 1.0 / math.sqrt(d)),
           (p + ("w_up", "w"), (e, d, f), "normal", 1.0 / math.sqrt(d)),
           (p + ("w_down", "w"), (e, f, d), "normal", 1.0 / math.sqrt(f))]
    if fs:
        out += [dense(p + ("shared_gate",), d, fs),
                dense(p + ("shared_up",), d, fs),
                dense(p + ("shared_down",), fs, d)]
    return out


def leaves(cfg: Dict) -> List[Leaf]:
    d, v = cfg["hidden_size"], cfg["vocab_size"]
    out: List[Leaf] = [(("embed", "emb"), (v, d), "normal", 0.02)]
    k = _n_dense(cfg) if routed_experts(cfg) else 0
    for i, (_, ffn) in enumerate(layer_kinds(cfg)):
        p = (f"prefix_{i}",) if i < k else ("stack", i - k, "l0")
        out += [norm(p + ("norm1",), d)] + _mixer(cfg, p + ("mixer",))
        out += [norm(p + ("norm2",), d)] + _ffn(cfg, p + ("ffn",),
                                                ffn == "moe")
    out += [norm(("final_norm",), d), dense(("head",), d, v)]
    return out


# -- the counts ------------------------------------------------------------
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
    dense_n = _n_dense(cfg)
    moe = n - dense_n
    return (n * mixer_params(cfg) + dense_n * ffn_params(cfg, False)
            + (moe * ffn_params(cfg, True) if moe else 0))


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
