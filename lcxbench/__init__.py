"""The benchmark of the PyTorch/CUDA port (``repro_torch``) on one NVIDIA
H100: open- and closed-loop serving cells, driven by ``BENCHMARK.json``
and the data files beside this module.  See ``README.md``."""
