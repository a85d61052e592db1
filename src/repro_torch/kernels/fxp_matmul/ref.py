"""Plain PyTorch version of the dual-precision dense layer (port of
`repro.kernels.fxp_matmul.ref`).

  full precision  y = act( (x_hi @ w) + (x_lo @ w) + b )
  half precision  y = act( (x_hi @ w) + b )

where x_hi is the bf16 image of x (round to nearest even) and x_lo the exact
residual.  This is the oracle the CUDA kernel (`csrc/fxp_dense.cu`) is held
against, and what `ops.fxp_dense` computes for CPU tensors.  On the card it
needs `torch.backends.cuda.matmul.allow_tf32 = False` (PyTorch's default),
or the two dots run in TF32.
"""

from __future__ import annotations

from typing import Optional

import torch

Tensor = torch.Tensor

_ACTIVATIONS = {
    "none": lambda x: x,
    "relu": torch.relu,
    "tanh": torch.tanh,
}


def limb_split(x: Tensor, with_lo: bool = True) -> tuple[Tensor, Optional[Tensor]]:
    """Exact hi/lo split: hi = bf16 image of x, lo = residual (both f32).
    with_lo=False skips the residual (half precision only reads hi)."""
    hi = x.to(torch.bfloat16).to(torch.float32)
    if not with_lo:
        return hi, None
    return hi, x - hi


def ref_fxp_dense(
    x: Tensor,
    w: Tensor,
    b: Optional[Tensor] = None,
    *,
    full_precision: bool = True,
    activation: str = "none",
) -> Tensor:
    """Oracle for kernels/fxp_matmul. x: (M, K) f32, w: (K, N) f32."""
    act = _ACTIVATIONS[activation]
    hi, lo = limb_split(x, with_lo=full_precision)
    acc = hi @ w
    if full_precision:
        acc = acc + lo @ w
    if b is not None:
        acc = acc + b
    return act(acc)


def ref_flops(m: int, n: int, k: int, full_precision: bool) -> int:
    """MAC-pass FLOP model: two passes in full precision, one in half."""
    passes = 2 if full_precision else 1
    return 2 * m * n * k * passes


__all__ = ["limb_split", "ref_fxp_dense", "ref_flops"]
