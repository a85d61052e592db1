"""Correctly rounded float32 arithmetic that PyTorch does not promise.

XLA's float32 `sqrt` is the IEEE one (correctly rounded), and so is the
CUDA kernels' `__fsqrt_rn`.  PyTorch's CPU `torch.sqrt` on float32 is not:
its vectorised path is off by one ulp on a sizeable share of inputs
(`tests/test_torch_optim.py` pins the difference), and `torch.pow(x, 0.5)`
takes the same path.  `sqrt_rn` computes in float64 and rounds once:
binary64 has 53 ≥ 2·24 + 2 significand bits, so a binary64 square root
rounded to binary32 is the correctly rounded binary32 square root, on
either device.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def sqrt_rn(x: Tensor) -> Tensor:
    """The correctly rounded float32 square root of float32 `x`."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


__all__ = ["sqrt_rn"]
