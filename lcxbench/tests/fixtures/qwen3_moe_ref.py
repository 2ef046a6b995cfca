"""Plain reference of Qwen3-MoE as ``qwen3_moe.json`` states it: pre-norm
RMSNorm layers; GQA attention whose queries and keys are RMS-normed over
each head (``qnorm``, ``knorm``) before the rotary embedding; an expert
layer: float32 router logits, a softmax over every expert, the
``num_experts_per_tok`` highest (ties to the lower id), weights
normalised to sum 1, each expert a SiLU-gated MLP, no shared expert.  A
prompt's rows per expert are bounded as the program bounds them
(``capacity``); tokens after the prompt are never dropped.  Plain torch,
nothing of the program."""
from __future__ import annotations

import math
from typing import Dict

import torch

from lcxbench.reference.ops import (causal_attention, head, layer_params,
                                    linear, rmsnorm, rope, silu_mlp)


def attention(cfg: Dict, p: Dict, x: torch.Tensor, pos: torch.Tensor,
              precision: str) -> torch.Tensor:
    n, eps = x.shape[0], cfg["rms_norm_eps"]
    h, hkv, hd = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                  cfg["head_dim"])
    q = rmsnorm(linear(x, p["wq"]["w"], precision).view(n, h, hd),
                p["qnorm"]["g"], eps)
    k = rmsnorm(linear(x, p["wk"]["w"], precision).view(n, hkv, hd),
                p["knorm"]["g"], eps)
    v = linear(x, p["wv"]["w"], precision).view(n, hkv, hd)
    q, k = rope(q, pos, cfg["rope_theta"]), rope(k, pos, cfg["rope_theta"])
    return linear(causal_attention(q, k, v).reshape(n, h * hd),
                  p["wo"]["w"], precision)


def capacity(cfg: Dict, n_tokens: int) -> int:
    c = math.ceil(n_tokens * cfg["num_experts_per_tok"] / cfg["num_experts"]
                  * cfg["capacity_factor"])
    return max(8, -(-c // 8) * 8)


def experts(cfg: Dict, p: Dict, x: torch.Tensor, prompt_len: int,
            precision: str, routes=None) -> torch.Tensor:
    e, k = cfg["num_experts"], cfg["num_experts_per_tok"]
    scores = torch.softmax(x @ p["router"]["w"].float(), -1)
    w, ids = torch.sort(scores, dim=-1, descending=True, stable=True)
    if routes is not None:
        routes.append((ids[:, :k], w[:, k - 1] - w[:, k]))
    w, ids = w[:, :k], ids[:, :k]
    if cfg["norm_topk_prob"]:
        w = w / w.sum(-1, keepdim=True).clamp_min(1e-9)
    keep = torch.ones_like(ids, dtype=torch.bool)
    if prompt_len:
        pr = ids[:prompt_len]
        onehot = torch.nn.functional.one_hot(pr, e).sum(1)
        rank = torch.cumsum(onehot, 0) - onehot
        keep[:prompt_len] = torch.gather(rank, 1, pr) < capacity(
            cfg, prompt_len)
    y = torch.zeros_like(x)
    for ex in torch.unique(ids[keep]).tolist():
        rows, slots = torch.nonzero((ids == ex) & keep, as_tuple=True)
        ye = silu_mlp(x[rows], p["w_gate"]["w"][ex], p["w_up"]["w"][ex],
                      p["w_down"]["w"][ex], precision)
        y.index_add_(0, rows, ye * w[rows, slots, None])
    return y


@torch.no_grad()
def logits(cfg: Dict, params: Dict, tokens: torch.Tensor, prompt_len: int,
           first: int, precision: str = "f32", routes=None) -> torch.Tensor:
    eps = cfg["rms_norm_eps"]
    x = params["embed"]["emb"][tokens].float()
    pos = torch.arange(x.shape[0], device=x.device)
    for i in range(cfg["num_hidden_layers"]):
        p = layer_params(params, i, 0)
        x = x + attention(cfg, p["mixer"], rmsnorm(x, p["norm1"]["g"], eps),
                          pos, precision)
        x = x + experts(cfg, p["ffn"], rmsnorm(x, p["norm2"]["g"], eps),
                        prompt_len, precision, routes)
    return head(cfg, params, x[first:], precision)
