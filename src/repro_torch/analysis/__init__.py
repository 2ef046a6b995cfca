from .roofline import active_params, model_flops

__all__ = ["active_params", "model_flops"]
