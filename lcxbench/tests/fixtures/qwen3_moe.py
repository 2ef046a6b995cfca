"""A family with other key names and other leaves than ``decoder``:
Qwen3-MoE, every layer GQA attention with an RMSNorm over each head's
query and key (``qnorm``, ``knorm`` of the head dim, before the rotary
embedding) and an expert layer of ``num_experts`` experts, top
``num_experts_per_tok`` from a softmax, no shared expert.

The layout is ``decoder``'s with no prefix: ``stack`` holds one ``{"l0":
layer}`` a layer.  The counts are ``decoder``'s: 2 x the matrix parameters
a token passes through, attention over the keys it sees.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, List, Tuple

from lcxbench.counts import head_flops
from lcxbench.weights import Leaf, dense, norm

fields = {"num_experts": "n_experts", "moe_intermediate_size": "moe_d_ff"}
program = {"decoder_sparse_step": 1, "mlp_only_layers": [],
           "use_sliding_window": False}


def routed_experts(cfg: Dict) -> int:
    return cfg["num_experts"]


def layer_kinds(cfg: Dict) -> List[Tuple[str, str]]:
    return [("attn", "moe")] * cfg["num_hidden_layers"]


def leaves(cfg: Dict) -> List[Leaf]:
    d, v, h = cfg["hidden_size"], cfg["vocab_size"], \
        cfg["num_attention_heads"]
    hd, hkv = cfg["head_dim"], cfg["num_key_value_heads"]
    e, f = cfg["num_experts"], cfg["moe_intermediate_size"]
    out: List[Leaf] = [(("embed", "emb"), (v, d), "normal", 0.02)]
    for i in range(cfg["num_hidden_layers"]):
        p = ("stack", i, "l0")
        m, x = p + ("mixer",), p + ("ffn",)
        out += [norm(p + ("norm1",), d),
                dense(m + ("wq",), d, h * hd), dense(m + ("wk",), d, hkv * hd),
                dense(m + ("wv",), d, hkv * hd), dense(m + ("wo",), h * hd, d),
                norm(m + ("qnorm",), hd), norm(m + ("knorm",), hd),
                norm(p + ("norm2",), d),
                (x + ("router", "w"), (d, e), "float32", 1.0 / math.sqrt(d)),
                (x + ("w_gate", "w"), (e, d, f), "normal", 1.0 / math.sqrt(d)),
                (x + ("w_up", "w"), (e, d, f), "normal", 1.0 / math.sqrt(d)),
                (x + ("w_down", "w"), (e, f, d), "normal",
                 1.0 / math.sqrt(f))]
    out += [norm(("final_norm",), d), dense(("head",), d, v)]
    return out


def body_params(cfg: Dict) -> int:
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    hd, hkv = cfg["head_dim"], cfg["num_key_value_heads"]
    attn = 2 * d * h * hd + 2 * d * hkv * hd
    ffn = d * cfg["num_experts"] + cfg["num_experts_per_tok"] * 3 * d \
        * cfg["moe_intermediate_size"]
    return cfg["num_hidden_layers"] * (attn + ffn)


def attn_flops_per_key(cfg: Dict) -> int:
    return 4 * cfg["num_attention_heads"] * cfg["head_dim"]


def prefill_flops(cfg: Dict, n: int) -> int:
    return (2 * body_params(cfg) * n
            + attn_flops_per_key(cfg) * cfg["num_hidden_layers"]
            * n * (n + 1) // 2 + head_flops(cfg))


def decode_flops(cfg: Dict, lengths: Iterable[int]) -> int:
    lengths = list(lengths)
    return (len(lengths) * (2 * body_params(cfg) + head_flops(cfg))
            + attn_flops_per_key(cfg) * cfg["num_hidden_layers"]
            * sum(n + 1 for n in lengths))
