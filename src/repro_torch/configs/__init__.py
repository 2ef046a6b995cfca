from .base import (LayerSpec, ModelConfig, get_config, get_smoke_config,
                   register)

__all__ = ["LayerSpec", "ModelConfig", "get_config", "get_smoke_config",
           "register"]
