"""mamba2-130m  [ssm]  24L d_model=768 (attn-free) vocab=50280,
ssm_state=128 — SSD (state-space duality)  [arXiv:2405.21060;
unverified]"""
import torch

from .base import ModelConfig, register


@register("mamba2-130m")
def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-130m", family="ssm",
        n_layers=24, d_model=768, n_heads=1, n_kv_heads=1, d_ff=0,
        vocab=50280, ssm_state=128, ssm_expand=2, ssm_head_dim=64,
        ssm_groups=1, ssm_conv=4, ssm_chunk=256,
        tie_embeddings=True, norm="rms",
        max_seq_len=1048576,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="mamba2-130m-smoke", family="ssm",
        n_layers=2, d_model=64, n_heads=1, n_kv_heads=1, d_ff=0,
        vocab=128, ssm_state=16, ssm_head_dim=16, ssm_chunk=16,
        tie_embeddings=True,
        dtype=torch.float32, param_dtype=torch.float32, q_block=16,
    )
