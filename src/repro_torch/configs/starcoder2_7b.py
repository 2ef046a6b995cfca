"""starcoder2-7b  [dense]  32L d_model=4608 36H (GQA kv=4) d_ff=18432
vocab=49152 — GQA, RoPE  [arXiv:2402.19173; hf]

The sliding window gives it no flash hook (``kernels.ops.model_kernels``):
its prefill takes the plain windowed attention."""
import torch

from .base import ModelConfig, register


@register("starcoder2-7b")
def config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-7b", family="dense",
        n_layers=32, d_model=4608, n_heads=36, n_kv_heads=4, d_ff=18432,
        vocab=49152, qkv_bias=True, norm="layer", act="gelu",
        rope_theta=1e5, sliding_window=4096,
        max_seq_len=16384,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-7b-smoke", family="dense",
        n_layers=2, d_model=96, n_heads=6, n_kv_heads=2, d_ff=256,
        vocab=128, qkv_bias=True, norm="layer", act="gelu",
        sliding_window=16,
        dtype=torch.float32, param_dtype=torch.float32, q_block=16,
    )
