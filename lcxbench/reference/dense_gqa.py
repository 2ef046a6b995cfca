"""Plain reference of a dense decoder with grouped-query attention
(InternLM2): pre-norm RMSNorm layers, rotary embeddings on every head
dim, causal attention in which ``num_attention_heads /
num_key_value_heads`` query heads share a key head, a SiLU-gated MLP, no
biases, an untied head."""
from __future__ import annotations

from typing import Dict

import torch

from .ops import causal_attention, head, layer_params, linear, rmsnorm, rope
from .ops import silu_mlp


def attention(cfg: Dict, p: Dict, x: torch.Tensor, pos: torch.Tensor,
              precision: str) -> torch.Tensor:
    n = x.shape[0]
    h, hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = cfg.get("head_dim") or cfg["hidden_size"] // h
    q = linear(x, p["wq"]["w"], precision).view(n, h, hd)
    k = linear(x, p["wk"]["w"], precision).view(n, hkv, hd)
    v = linear(x, p["wv"]["w"], precision).view(n, hkv, hd)
    q, k = rope(q, pos, cfg["rope_theta"]), rope(k, pos, cfg["rope_theta"])
    out = causal_attention(q, k, v)
    return linear(out.reshape(n, h * hd), p["wo"]["w"], precision)


@torch.no_grad()
def logits(cfg: Dict, params: Dict, tokens: torch.Tensor, prompt_len: int,
           first: int, precision: str = "f32") -> torch.Tensor:
    """Logits [len(tokens) - first, V] of positions ``first`` and after.
    ``prompt_len`` changes nothing here (no layer depends on how the
    sequence was batched)."""
    eps = cfg["rms_norm_eps"]
    x = params["embed"]["emb"][tokens].float()
    pos = torch.arange(x.shape[0], device=x.device)
    for i in range(cfg["num_hidden_layers"]):
        p = layer_params(params, i, 0)
        x = x + attention(cfg, p["mixer"],
                          rmsnorm(x, p["norm1"]["g"], eps), pos, precision)
        f = p["ffn"]
        x = x + silu_mlp(rmsnorm(x, p["norm2"]["g"], eps), f["gate"]["w"],
                         f["up"]["w"], f["down"]["w"], precision)
    return head(cfg, params, x[first:], precision)
