"""Where the port runs: the CUDA card, unless the caller asks for the CPU.

Entry points take a ``device`` argument that defaults to ``"cuda"``.  When
CUDA is absent they raise instead of moving to the CPU; the tests pass
``device="cpu"`` explicitly.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``"cuda"``.  Raises when a CUDA device is asked for
    and CUDA is not available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


def on_hopper(device: Optional[torch.device] = None) -> bool:
    """True when CUDA is available and the card's capability is (9, 0)."""
    return (torch.cuda.is_available()
            and torch.cuda.get_device_capability(device) == (9, 0))
