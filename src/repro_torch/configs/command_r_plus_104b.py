"""command-r-plus-104b  [dense]  64L d_model=12288 96H (GQA kv=8)
d_ff=33792 vocab=256000 — GQA, no-bias
[hf:CohereForAI/c4ai-command-r-v01; unverified]

The whole model (~208 GB in bf16) does not fit one card; it runs cut in
depth there."""
import torch

from .base import ModelConfig, register


@register("command-r-plus-104b")
def config() -> ModelConfig:
    return ModelConfig(
        name="command-r-plus-104b", family="dense",
        n_layers=64, d_model=12288, n_heads=96, n_kv_heads=8, d_ff=33792,
        vocab=256000, qkv_bias=False, norm="layer", act="swiglu",
        rope_theta=75e6, tie_embeddings=True,   # cohere ties embeddings
        max_seq_len=131072,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="command-r-plus-104b-smoke", family="dense",
        n_layers=2, d_model=96, n_heads=6, n_kv_heads=2, d_ff=256,
        vocab=128, norm="layer", tie_embeddings=True,
        dtype=torch.float32, param_dtype=torch.float32, q_block=16,
    )
