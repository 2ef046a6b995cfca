"""qwen3-moe-30b-a3b  [moe]  48L d_model=2048 32H (GQA kv=4)
moe_d_ff=768 vocab=151936, MoE 128e top-8 — 128 experts top-8
[hf:Qwen/Qwen3-30B-A3B; hf].  head_dim=128 (decoupled from d_model);
QK-norm per qwen3."""
import torch

from .base import ModelConfig, register


@register("qwen3-moe-30b-a3b")
def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-30b-a3b", family="moe",
        n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4,
        head_dim=128, d_ff=6144, vocab=151936, norm="rms", act="swiglu",
        qk_norm=True, rope_theta=1e6,
        n_experts=128, n_experts_per_tok=8, moe_d_ff=768,
        expert_layer_period=1, router_type="softmax",
        router_norm_topk=True, moe_backend="lcx", capacity_factor=1.25,
        max_seq_len=32768,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-30b-a3b-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=160, vocab=128, qk_norm=True,
        n_experts=8, n_experts_per_tok=2, moe_d_ff=48,
        moe_backend="sort", capacity_factor=4.0,
        dtype=torch.float32, param_dtype=torch.float32, q_block=16,
    )
