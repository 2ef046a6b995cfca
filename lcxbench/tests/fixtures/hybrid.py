"""A hybrid family, as Jamba, Nemotron-H or Granite-4.0-H lay out their
layers: Mamba-2 (SSD) mixers with GQA attention every
``attn_layer_period`` layers from ``attn_layer_offset``, and expert layers
(``num_experts``, top ``num_experts_per_tok``) every
``expert_layer_period`` layers from ``expert_layer_offset``, the others
dense.  The Mamba-2 keys are Bamba's and Granite-4.0-H's
(``mamba_d_state``, ``mamba_d_head``, ``mamba_n_groups``, ...).

The layout is the program's stacked one: ``stack`` holds one entry a
period of layers (the shortest run of layer kinds that repeats), each
``{"l<j>": layer}``.  A Mamba-2 mixer is ``in_proj [d, 2 di + 2 G N + H]``,
``out_proj [di, d]``, the depthwise ``conv_w [K, di + 2 G N]`` and
``conv_b``, ``A_log``, ``D`` and ``dt_bias`` (float32, one a head) and
``norm_g [di]``, with ``di = mamba_expand x d`` and ``H = di /
mamba_d_head``.

The counts: 2 x the matrix parameters a token passes through; attention
over the keys it sees; a Mamba-2 layer's recurrence, ``4 H N P`` a token
(the state's update and its read, ``P = mamba_d_head``), its depthwise
convolution ``2 K (di + 2 G N)`` a token.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, List, Tuple

from lcxbench.counts import head_flops
from lcxbench.weights import Leaf, dense, norm

fields = {"num_experts": "n_experts", "moe_intermediate_size": "moe_d_ff",
          "attn_layer_period": "attn_layer_period",
          "attn_layer_offset": "attn_layer_offset",
          "expert_layer_period": "expert_layer_period",
          "expert_layer_offset": "expert_layer_offset",
          "mamba_d_state": "ssm_state", "mamba_d_conv": "ssm_conv",
          "mamba_expand": "ssm_expand", "mamba_d_head": "ssm_head_dim",
          "mamba_n_groups": "ssm_groups", "mamba_chunk_size": "ssm_chunk"}
program = {"mamba_conv_bias": True, "mamba_proj_bias": False}


def routed_experts(cfg: Dict) -> int:
    return cfg.get("num_experts") or 0


def layer_kinds(cfg: Dict) -> List[Tuple[str, str]]:
    out = []
    for i in range(cfg["num_hidden_layers"]):
        attn = i % cfg["attn_layer_period"] == cfg["attn_layer_offset"]
        moe = routed_experts(cfg) and \
            i % cfg["expert_layer_period"] == cfg["expert_layer_offset"]
        out.append(("attn" if attn else "mamba", "moe" if moe else "dense"))
    return out


def period(kinds: List) -> int:
    """The shortest run of kinds that repeats to the whole."""
    n = len(kinds)
    return next(p for p in range(1, n + 1) if n % p == 0
                and all(kinds[i] == kinds[i % p] for i in range(n)))


def _ssm_sizes(cfg: Dict):
    d = cfg["hidden_size"]
    di = cfg["mamba_expand"] * d
    g, n = cfg["mamba_n_groups"], cfg["mamba_d_state"]
    return d, di, g, n, di // cfg["mamba_d_head"], cfg["mamba_d_conv"]


def _mamba(cfg: Dict, p) -> List[Leaf]:
    d, di, g, n, h, k = _ssm_sizes(cfg)
    ch = di + 2 * g * n
    return [dense(p + ("in_proj",), d, 2 * di + 2 * g * n + h),
            dense(p + ("out_proj",), di, d),
            (p + ("conv_w",), (k, ch), "normal", 1.0 / math.sqrt(k)),
            (p + ("conv_b",), (ch,), "normal", 0.02),
            (p + ("A_log",), (h,), "float32", 1.0),
            (p + ("D",), (h,), "float32", 1.0),
            (p + ("dt_bias",), (h,), "float32", 1.0),
            (p + ("norm_g",), (di,), "ones", 1.0)]


def _attn(cfg: Dict, p) -> List[Leaf]:
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    hd, hkv = d // h, cfg["num_key_value_heads"]
    return [dense(p + ("wq",), d, h * hd), dense(p + ("wk",), d, hkv * hd),
            dense(p + ("wv",), d, hkv * hd), dense(p + ("wo",), h * hd, d)]


def _ffn(cfg: Dict, p, kind: str) -> List[Leaf]:
    d = cfg["hidden_size"]
    if kind == "dense":
        f = cfg["intermediate_size"]
        return [dense(p + ("gate",), d, f), dense(p + ("up",), d, f),
                dense(p + ("down",), f, d)]
    e, f = cfg["num_experts"], cfg["moe_intermediate_size"]
    return [(p + ("router", "w"), (d, e), "float32", 1.0 / math.sqrt(d)),
            (p + ("w_gate", "w"), (e, d, f), "normal", 1.0 / math.sqrt(d)),
            (p + ("w_up", "w"), (e, d, f), "normal", 1.0 / math.sqrt(d)),
            (p + ("w_down", "w"), (e, f, d), "normal", 1.0 / math.sqrt(f))]


def leaves(cfg: Dict) -> List[Leaf]:
    d, v = cfg["hidden_size"], cfg["vocab_size"]
    kinds = layer_kinds(cfg)
    per = period(kinds)
    out: List[Leaf] = [(("embed", "emb"), (v, d), "normal", 0.02)]
    for i, (mixer, ffn) in enumerate(kinds):
        p = ("stack", i // per, f"l{i % per}")
        out += [norm(p + ("norm1",), d)]
        out += (_attn if mixer == "attn" else _mamba)(cfg, p + ("mixer",))
        out += [norm(p + ("norm2",), d)] + _ffn(cfg, p + ("ffn",), ffn)
    out += [norm(("final_norm",), d), dense(("head",), d, v)]
    return out


# -- the counts, by kind ---------------------------------------------------
def mixer_params(cfg: Dict, kind: str) -> int:
    if kind == "attn":
        d, h = cfg["hidden_size"], cfg["num_attention_heads"]
        hd, hkv = d // h, cfg["num_key_value_heads"]
        return 2 * d * h * hd + 2 * d * hkv * hd
    d, di, g, n, h, _ = _ssm_sizes(cfg)
    return d * (2 * di + 2 * g * n + h) + di * d


def mixer_token_flops(cfg: Dict, kind: str) -> int:
    """A Mamba-2 layer's work a token beside its matrices (the recurrence
    and the convolution); attention's is by keys (``attn_flops_per_key``)."""
    if kind == "attn":
        return 0
    _, di, g, n, h, k = _ssm_sizes(cfg)
    return 4 * h * n * cfg["mamba_d_head"] + 2 * k * (di + 2 * g * n)


def attn_flops_per_key(cfg: Dict) -> int:
    return 4 * cfg["hidden_size"]


def ffn_params(cfg: Dict, kind: str) -> int:
    d = cfg["hidden_size"]
    if kind == "dense":
        return 3 * d * cfg["intermediate_size"]
    return (d * cfg["num_experts"] + cfg["num_experts_per_tok"] * 3 * d
            * cfg["moe_intermediate_size"])


def token_flops(cfg: Dict) -> int:
    """A token's work through every layer, attention's keys left out."""
    return sum(2 * (mixer_params(cfg, m) + ffn_params(cfg, f))
               + mixer_token_flops(cfg, m) for m, f in layer_kinds(cfg))


def _attn_layers(cfg: Dict) -> int:
    return sum(m == "attn" for m, _ in layer_kinds(cfg))


def prefill_flops(cfg: Dict, n: int) -> int:
    return (token_flops(cfg) * n
            + attn_flops_per_key(cfg) * _attn_layers(cfg) * n * (n + 1) // 2
            + head_flops(cfg))


def decode_flops(cfg: Dict, lengths: Iterable[int]) -> int:
    lengths = list(lengths)
    return (len(lengths) * (token_flops(cfg) + head_flops(cfg))
            + attn_flops_per_key(cfg) * _attn_layers(cfg)
            * sum(n + 1 for n in lengths))
