"""The run's environment, set before anything imports torch: the
program's build and kernel caches at fixed paths inside the checkout
(``.bench_cache/``, so that only a cell's first run there builds), and
no JAX through a library that would load it."""
import os

CACHES = (("TRITON_CACHE_DIR", "triton"),
          ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
          ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
          ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels"),
          ("CUDA_CACHE_PATH", "nv_compute"))


def setup(root: str) -> None:
    for var, sub in CACHES:
        os.environ[var] = os.path.join(root, ".bench_cache", sub)
    os.environ["USE_FLAX"] = "0"
