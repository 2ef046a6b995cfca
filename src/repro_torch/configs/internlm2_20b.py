"""internlm2-20b  [dense]  48L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=92544 — GQA  [arXiv:2403.17297; hf]"""
import torch

from .base import ModelConfig, register


@register("internlm2-20b")
def config() -> ModelConfig:
    return ModelConfig(
        name="internlm2-20b", family="dense",
        n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=16384,
        vocab=92544, norm="rms", act="swiglu", rope_theta=1e6,
        max_seq_len=32768,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="internlm2-20b-smoke", family="dense",
        n_layers=2, d_model=96, n_heads=6, n_kv_heads=2, d_ff=256,
        vocab=128, dtype=torch.float32, param_dtype=torch.float32,
        q_block=16,
    )
