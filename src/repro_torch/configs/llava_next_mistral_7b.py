"""llava-next-mistral-7b  [vlm]  32L d_model=4096 32H (GQA kv=8)
d_ff=14336 vocab=32000 — anyres tiling
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified].

Backbone = Mistral-7B.  The vision frontend is a stub, as in the
reference: the caller passes precomputed patch embeddings
``[B, frontend_len, d_model]`` (anyres base grid 24x24 = 576 patches) as
``frontend_embeds``, prepended to the token sequence.
"""
import torch

from .base import ModelConfig, register


@register("llava-next-mistral-7b")
def config() -> ModelConfig:
    return ModelConfig(
        name="llava-next-mistral-7b", family="vlm",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
        vocab=32000, norm="rms", act="swiglu", rope_theta=1e6,
        frontend="vision", frontend_len=576,
        max_seq_len=32768,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="llava-next-mistral-7b-smoke", family="vlm",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=160,
        vocab=128, frontend="vision", frontend_len=16,
        dtype=torch.float32, param_dtype=torch.float32, q_block=16,
    )
