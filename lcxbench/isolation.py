"""The check that the run loaded no JAX: top-level module names compared
whole (``repro_torch`` is the program; ``repro`` is the JAX package)."""
from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})


def forbidden(modules: Iterable[str]) -> List[str]:
    """The forbidden top-level names among ``modules``."""
    return sorted({m.split(".", 1)[0] for m in modules} & FORBIDDEN)


def loaded() -> List[str]:
    return forbidden(list(sys.modules))
