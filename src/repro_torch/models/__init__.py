from .model import (abstract_init, apply_model, cache_batch_axes,
                    decode_step, init_cache, init_model, loss_fn, prefill)
from . import attention, common, mla, model, moe, ssm

__all__ = ["abstract_init", "apply_model", "cache_batch_axes",
           "decode_step", "init_cache", "init_model", "loss_fn", "prefill",
           "attention", "common", "mla", "model", "moe", "ssm"]
