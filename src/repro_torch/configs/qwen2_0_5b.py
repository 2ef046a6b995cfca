"""qwen2-0.5b  [dense]  24L d_model=896 14H (GQA kv=2) d_ff=4864
vocab=151936 — GQA, QKV bias  [arXiv:2407.10671; hf]"""
import torch

from .base import ModelConfig, register


@register("qwen2-0.5b")
def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-0.5b", family="dense",
        n_layers=24, d_model=896, n_heads=14, n_kv_heads=2, d_ff=4864,
        vocab=151936, qkv_bias=True, tie_embeddings=True,
        rope_theta=1e6, norm="rms", act="swiglu",
        max_seq_len=32768,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen2-0.5b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=160,
        vocab=128, qkv_bias=True, tie_embeddings=True,
        dtype=torch.float32, param_dtype=torch.float32, q_block=16,
    )
