"""Plain PyTorch version of the fused monitor + quantizer (port of
`repro.kernels.quantize.ref`, Algorithm 1's activation stage).

One pass over the activation tensor does both of the unit's jobs:

  * range monitoring — the running min/max, folded into the incoming
    range while the quantization phase is off and frozen once it is on;
  * the phase-selected projection — onto the Q15.16 lattice before the
    delay, and after it an affine n-bit quantization with the *incoming*
    captured range (Q_n: q = clip(round(x/delta) + z)), emitted dequantized
    so the next layer's MACs see lattice values.

Returns (y, new_min, new_max).  This is what `ops.monitor_quant` computes
for CPU tensors and the oracle kernel 6 (`csrc/fxp_monitor_quant.cu`) is
held against on the card.  The min/max propagate NaN, as `jnp.min` does.
"""

from __future__ import annotations

import torch

from repro_torch.core import fixedpoint as fxp

Tensor = torch.Tensor


def _scalar(v, device) -> Tensor:
    """A 0-d float32 tensor on `device` (a fill for a Python number: no
    host-to-device copy)."""
    if isinstance(v, Tensor):
        return v.to(device=device, dtype=torch.float32).reshape(())
    return torch.full((), float(v), dtype=torch.float32, device=device)


def ref_monitor_quant(x: Tensor, a_min, a_max, quant_phase, n_bits: int = 16) -> tuple[Tensor, Tensor, Tensor]:
    xf = x.to(torch.float32)
    dev = xf.device
    a_min, a_max = _scalar(a_min, dev), _scalar(a_max, dev)
    if isinstance(quant_phase, Tensor):
        quant = quant_phase.to(dev).reshape(()) != 0
    else:
        quant = torch.full((), bool(quant_phase), dtype=torch.bool, device=dev)
    # monitoring freezes once quantization starts (Algorithm 1)
    new_min = torch.where(quant, a_min, torch.minimum(a_min, torch.min(xf)))
    new_max = torch.where(quant, a_max, torch.maximum(a_max, torch.max(xf)))

    y_full = fxp.project(xf, fxp.FXP32)
    delta, z = fxp.affine_params(a_min, a_max, n_bits)
    zf = z.to(torch.float32)
    q_max = torch.full((), float((1 << n_bits) - 1), dtype=torch.float32, device=dev)
    q = torch.minimum(torch.maximum(torch.round(xf / delta) + zf, torch.zeros_like(q_max)), q_max)
    y_quant = (q - zf) * delta
    return torch.where(quant, y_quant, y_full), new_min, new_max


__all__ = ["ref_monitor_quant"]
