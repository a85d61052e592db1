"""The port's device rule, in one place.

Entry points take `device=`.  `None` means the card: a caller on a machine
without CUDA gets an error, never a quiet CPU run.  `device="cpu"` is the
explicit opt-in the CPU tests use.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on (see module docstring)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run the plain "
                "PyTorch versions on the CPU"
            )
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; expected 'cuda' or 'cpu'")
    return dev


def check_same_device(*tensors: Optional[torch.Tensor]) -> torch.device:
    """The common device of `tensors` (None entries skipped); raises when
    they disagree, so a wrapper never mixes a CPU and a CUDA operand."""
    dev = None
    for t in tensors:
        if t is None:
            continue
        if dev is None:
            dev = t.device
        elif t.device != dev:
            raise ValueError(f"tensors on different devices: {dev} and {t.device}")
    if dev is None:
        raise ValueError("no tensor given")
    return dev


__all__ = ["resolve_device", "check_same_device"]
