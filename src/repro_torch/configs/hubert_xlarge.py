"""hubert-xlarge  [audio]  48L d_model=1280 16H (kv=16) d_ff=5120
vocab=504 — encoder-only, same arch as w2v2  [arXiv:2106.07447;
unverified].  The modality frontend is a stub, as in the reference: the
caller passes precomputed frame embeddings ``[B, S, d_model]`` as
``frontend_embeds``.  Non-causal: its attention takes the flash hook with
``causal=False``; it has no decode path."""
import torch

from .base import ModelConfig, register


@register("hubert-xlarge")
def config() -> ModelConfig:
    return ModelConfig(
        name="hubert-xlarge", family="audio",
        n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16, d_ff=5120,
        vocab=504, causal=False, norm="layer", act="gelu",
        frontend="audio", max_seq_len=4096,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="hubert-xlarge-smoke", family="audio",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=160,
        vocab=31, causal=False, norm="layer", act="gelu",
        frontend="audio",
        dtype=torch.float32, param_dtype=torch.float32, q_block=16,
    )
