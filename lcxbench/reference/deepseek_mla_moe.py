"""Plain reference of DeepSeek-V3's layers as the configuration file
states them: multi-head latent attention, ``first_k_dense_replace`` dense
SiLU-gated MLPs, then expert layers.

Attention: ``c_q = rmsnorm(x W_dq)``, ``q = c_q W_uq`` split into
``qk_nope_head_dim`` and ``qk_rope_head_dim`` parts; ``[c_kv, k_r] = x
W_dkv`` with ``c_kv`` normed and ``k_r`` one rotary key shared by every
head; ``k = [c_kv W_uk, k_r]``, ``v = c_kv W_uv``; causal softmax over
sqrt(nope + rope); rotary pairs are the halves of the rope part.

Experts: float32 router logits ``x W_r``, sigmoid scores, the
``num_experts_per_tok`` highest (ties to the lower expert id), weights
normalised to sum 1; each expert a SiLU-gated MLP; the shared expert
added.  The configuration's ``capacity_factor`` bounds a prompt's rows
per expert: a prompt of T tokens gives each expert ``C = max(8,
8 ceil(ceil(T k / E x capacity_factor) / 8))`` rows, filled in token
order, and a token's assignment past them adds nothing.  Tokens after
the prompt (one decoded at a time) are never dropped.

What the program computes in place of the published model, the
configuration file's ``departures``, this computes too: plain rotary
embeddings (no YaRN), routing over all experts at once (no groups), the
routed sum unscaled, no multi-token-prediction layer.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from .ops import (causal_attention, head, layer_params, linear, rmsnorm,
                  rope, silu_mlp)


def mla(cfg: Dict, p: Dict, x: torch.Tensor, pos: torch.Tensor,
        precision: str) -> torch.Tensor:
    n = x.shape[0]
    h, eps = cfg["num_attention_heads"], cfg["rms_norm_eps"]
    nope, rdim = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
    kl, vd = cfg["kv_lora_rank"], cfg["v_head_dim"]
    theta = cfg["rope_theta"]
    cq = rmsnorm(linear(x, p["w_dq"]["w"], precision), p["qnorm"]["g"], eps)
    q = linear(cq, p["w_uq"]["w"], precision).view(n, h, nope + rdim)
    q = torch.cat([q[..., :nope], rope(q[..., nope:], pos, theta)], -1)
    kv = linear(x, p["w_dkv"]["w"], precision)
    c = rmsnorm(kv[:, :kl], p["kvnorm"]["g"], eps)
    k_r = rope(kv[:, None, kl:], pos, theta).expand(n, h, rdim)
    k = torch.cat([linear(c, p["w_uk"]["w"], precision).view(n, h, nope),
                   k_r], -1)
    v = linear(c, p["w_uv"]["w"], precision).view(n, h, vd)
    out = causal_attention(q, k, v)
    return linear(out.reshape(n, h * vd), p["wo"]["w"], precision)


def capacity(cfg: Dict, n_tokens: int) -> int:
    c = math.ceil(n_tokens * cfg["num_experts_per_tok"]
                  / cfg["n_routed_experts"] * cfg["capacity_factor"])
    return max(8, -(-c // 8) * 8)


def experts(cfg: Dict, p: Dict, x: torch.Tensor, prompt_len: int,
            precision: str, routes=None) -> torch.Tensor:
    """The expert layer.  When ``routes`` is a list, appends to it each
    position's chosen ids [N, k] and its margin [N]: the k-th highest
    score less the (k + 1)-th, how far the choice is from a tie."""
    n, e, k = x.shape[0], cfg["n_routed_experts"], cfg["num_experts_per_tok"]
    r_logits = x @ p["router"]["w"].float()
    scores = (torch.sigmoid(r_logits) if cfg["scoring_func"] == "sigmoid"
              else torch.softmax(r_logits, -1))
    w, ids = torch.sort(scores, dim=-1, descending=True, stable=True)
    if routes is not None:
        routes.append((ids[:, :k], w[:, k - 1] - w[:, k]))
    w, ids = w[:, :k], ids[:, :k]
    if cfg["norm_topk_prob"]:
        w = w / w.sum(-1, keepdim=True).clamp_min(1e-9)
    keep = torch.ones_like(ids, dtype=torch.bool)
    if prompt_len:
        cap = capacity(cfg, prompt_len)
        pr = ids[:prompt_len]
        onehot = torch.nn.functional.one_hot(pr, e).sum(1)      # [T, E]
        rank = torch.cumsum(onehot, 0) - onehot                 # earlier rows
        keep[:prompt_len] = torch.gather(rank, 1, pr) < cap
    y = torch.zeros_like(x)
    for ex in torch.unique(ids[keep]).tolist():
        rows, slots = torch.nonzero((ids == ex) & keep, as_tuple=True)
        ye = silu_mlp(x[rows], p["w_gate"]["w"][ex], p["w_up"]["w"][ex],
                      p["w_down"]["w"][ex], precision)
        y.index_add_(0, rows, ye * w[rows, slots, None])
    if cfg.get("n_shared_experts"):
        y = y + silu_mlp(x, p["shared_gate"]["w"], p["shared_up"]["w"],
                         p["shared_down"]["w"], precision)
    return y


@torch.no_grad()
def logits(cfg: Dict, params: Dict, tokens: torch.Tensor, prompt_len: int,
           first: int, precision: str = "f32", routes=None) -> torch.Tensor:
    """Logits [len(tokens) - first, V] of positions ``first`` and after;
    the first ``prompt_len`` tokens were one prefill (their expert rows
    are bounded by the capacity).  With a list ``routes``, each expert
    layer's chosen ids and margins (``experts``) are appended to it."""
    eps = cfg["rms_norm_eps"]
    n_dense = cfg.get("first_k_dense_replace", 0)
    x = params["embed"]["emb"][tokens].float()
    pos = torch.arange(x.shape[0], device=x.device)
    for i in range(cfg["num_hidden_layers"]):
        p = layer_params(params, i, n_dense)
        x = x + mla(cfg, p["mixer"], rmsnorm(x, p["norm1"]["g"], eps), pos,
                    precision)
        h, f = rmsnorm(x, p["norm2"]["g"], eps), p["ffn"]
        if i < n_dense:
            x = x + silu_mlp(h, f["gate"]["w"], f["up"]["w"],
                             f["down"]["w"], precision)
        else:
            x = x + experts(cfg, f, h, prompt_len, precision, routes)
    return head(cfg, params, x[first:], precision)
