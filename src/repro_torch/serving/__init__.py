from .engine import ServeConfig, ServingEngine, Request, sample_token

__all__ = ["ServeConfig", "ServingEngine", "Request", "sample_token"]
