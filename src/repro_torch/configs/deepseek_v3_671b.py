"""deepseek-v3-671b  [moe]  61L d_model=7168 128H (MLA) moe_d_ff=2048
vocab=129280, MoE 256e top-8 — MLA, 1 shared + 256 routed top-8, MTP
[arXiv:2412.19437; hf].

First 3 layers dense (d_ff=18432); sigmoid router with top-k
normalization; MLA: q_lora 1536 / kv_lora 512 / nope 128 / rope 64 /
v_head 128.  Optimizer moments in bf16.  The whole model (~1.3 TB in
bf16) does not fit one card; it runs cut in depth there.
"""
import torch

from .base import ModelConfig, register


@register("deepseek-v3-671b")
def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v3-671b", family="moe",
        n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128,
        d_ff=18432, vocab=129280, norm="rms", act="swiglu",
        first_k_dense=3,
        n_experts=256, n_experts_per_tok=8, moe_d_ff=2048,
        n_shared_experts=1, router_type="sigmoid", router_norm_topk=True,
        moe_backend="lcx", capacity_factor=1.25,
        q_lora_rank=1536, kv_lora_rank=512,
        qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
        mtp_depth=1, mtp_loss_coef=0.3,
        opt_dtype=torch.bfloat16,
        max_seq_len=131072,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v3-671b-smoke", family="moe",
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_ff=160,
        vocab=128, first_k_dense=1,
        n_experts=8, n_experts_per_tok=2, moe_d_ff=64,
        n_shared_experts=1, router_type="sigmoid",
        moe_backend="sort", capacity_factor=4.0,
        q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=16,
        qk_rope_head_dim=8, v_head_dim=16, mtp_depth=1,
        dtype=torch.float32, param_dtype=torch.float32, q_block=16,
    )
