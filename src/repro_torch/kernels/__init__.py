"""Hand-written Hopper kernels of the port.

Each kernel: ``csrc/<name>.cu`` (CUDA C++ for sm_90a, built by
``build.py`` at first use), a wrapper beside its plain PyTorch version
in ``<name>.py``, and an oracle in ``ref.py``.  ``ops.model_kernels``
builds the model's kernel hooks.  The submodule ``flash_attention``
keeps its name here (the wrapper is ``ops.flash_attention``).
"""
from . import ops, ref
from .ops import model_kernels

__all__ = ["ops", "ref", "model_kernels"]
