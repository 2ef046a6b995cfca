"""Hand-written Hopper kernels of the port.

Each kernel: ``csrc/<name>.cu`` (CUDA C++ for sm_90a, built by
``build.py`` at first use), a wrapper beside its plain PyTorch version
in ``<name>.py``, and an oracle in ``ref.py``.  ``ops.model_kernels``
builds the model's kernel hooks.  The submodules ``flash_attention``,
``ssd_scan``, ``ring_allgather``, ``moe_gmm`` and ``decode_attention``
keep their names here (the wrappers are ``ops.flash_attention``,
``ops.ssd_scan``, ``ops.ring_all_gather``, ``ops.moe_gmm`` and
``ops.decode_attention``): ``chip_smoke.py`` reads their ``launches``
counters.
"""
from . import ops, ref
from .ops import model_kernels

__all__ = ["ops", "ref", "model_kernels"]
