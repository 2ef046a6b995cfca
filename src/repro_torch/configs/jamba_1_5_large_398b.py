"""jamba-1.5-large-398b  [hybrid]  72L d_model=8192 64H (GQA kv=8)
d_ff=24576 vocab=65536, MoE 16e top-2 — Mamba+attn 1:7 interleave, MoE
[arXiv:2403.19887; hf].

Jamba period: 8 layers with attention at offset 4 (1 attn : 7 mamba),
MoE every other layer (offset 1).  The Mamba layers are the Mamba-2/SSD
block, as in the reference.  The full width (398 B parameters) does not
fit one card; the smoke config feeds the hybrid-with-experts twins.
"""
import torch

from .base import ModelConfig, register


@register("jamba-1.5-large-398b")
def config() -> ModelConfig:
    return ModelConfig(
        name="jamba-1.5-large-398b", family="hybrid",
        n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=24576,
        vocab=65536, norm="rms", act="swiglu",
        attn_layer_period=8, attn_layer_offset=4,
        n_experts=16, n_experts_per_tok=2, moe_d_ff=24576,
        expert_layer_period=2, expert_layer_offset=1,
        moe_backend="lcx", capacity_factor=1.25,
        ssm_state=128, ssm_expand=2, ssm_head_dim=128, ssm_groups=8,
        ssm_conv=4, ssm_chunk=256,
        max_seq_len=1048576,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="jamba-1.5-large-398b-smoke", family="hybrid",
        n_layers=8, d_model=64, n_heads=4, n_kv_heads=2, d_ff=160,
        vocab=128, attn_layer_period=8, attn_layer_offset=4,
        n_experts=4, n_experts_per_tok=2, moe_d_ff=160,
        expert_layer_period=2, expert_layer_offset=1,
        moe_backend="sort", capacity_factor=4.0,
        ssm_state=16, ssm_head_dim=16, ssm_groups=2, ssm_chunk=16,
        dtype=torch.float32, param_dtype=torch.float32, q_block=16,
    )
