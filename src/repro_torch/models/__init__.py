from .model import (apply_model, cache_batch_axes, decode_step, init_cache,
                    init_model, prefill)
from . import attention, common, mla, model, moe, ssm

__all__ = ["apply_model", "cache_batch_axes", "decode_step", "init_cache",
           "init_model", "prefill", "attention", "common", "mla", "model",
           "moe", "ssm"]
