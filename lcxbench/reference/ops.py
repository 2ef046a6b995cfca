"""Building blocks of the plain references, in float32."""
from __future__ import annotations

import math

import torch

FP8_MAX = 448.0          # the largest float8 e4m3 value


def fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale per slice along ``dim``
    (its largest magnitude at 448), back in float32."""
    scale = t.abs().amax(dim, keepdim=True).clamp_min(1e-12) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def linear(x: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    """``x @ w`` in float32; under ``"fp8"`` x rounded per row and w per
    output column first."""
    w = w.float()
    if precision == "fp8":
        x, w = fp8(x, -1), fp8(w, 0)
    elif precision != "f32":
        raise ValueError(f"unknown precision {precision!r}")
    return x @ w


def rmsnorm(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * g.float()


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding of x [L, H, D] at positions pos [L]: the first and
    second halves of D are the pairs rotated."""
    d = x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                         device=x.device) / d)
    ang = pos.float()[:, None] * freqs[None, :]
    c, s = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)


def silu_mlp(x: torch.Tensor, gate: torch.Tensor, up: torch.Tensor,
             down: torch.Tensor, precision: str) -> torch.Tensor:
    """down(silu(x @ gate) * (x @ up))."""
    h = torch.nn.functional.silu(linear(x, gate, precision)) \
        * linear(x, up, precision)
    return linear(h, down, precision)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     block: int = 512) -> torch.Tensor:
    """Causal softmax attention: q [L, H, Dk], k [L, Hk, Dk], v [L, Hk, Dv]
    (head h reads key head h // (H / Hk)), scores over sqrt(Dk), in
    blocks of ``block`` query rows -> [L, H, Dv]."""
    n, h, dk = q.shape
    g = h // k.shape[1]
    k = k.repeat_interleave(g, dim=1)
    v = v.repeat_interleave(g, dim=1)
    out = torch.empty((n, h, v.shape[-1]), dtype=torch.float32,
                      device=q.device)
    scale = 1.0 / math.sqrt(dk)
    for i in range(0, n, block):
        j = min(n, i + block)
        s = torch.einsum("qhd,khd->hqk", q[i:j], k[:j]) * scale
        keep = (torch.arange(i, j, device=q.device)[:, None]
                >= torch.arange(j, device=q.device)[None, :])
        s = s.masked_fill(~keep, float("-inf"))
        out[i:j] = torch.einsum("hqk,khd->qhd", torch.softmax(s, -1),
                                v[:j])
    return out


def layer_params(params, i: int, n_prefix: int):
    """Layer ``i``'s weights in the benchmark's nest."""
    if i < n_prefix:
        return params[f"prefix_{i}"]
    return params["stack"][i - n_prefix]["l0"]


def head(cfg, params, x: torch.Tensor, precision: str) -> torch.Tensor:
    x = rmsnorm(x, params["final_norm"]["g"], cfg["rms_norm_eps"])
    return linear(x, params["head"]["w"], precision)
