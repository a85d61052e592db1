"""Fixed-point (Qm.f) arithmetic in PyTorch — the fake-quant subset of
`repro.core.fixedpoint`.

FIXAR keeps weights and pre-delay activations on the Q15.16 lattice
(`FXP32`) and, after the quantization delay, fake-quantizes activations onto
an n-bit affine grid built from the monitored ranges (Algorithm 1's Q_n).
Values stay float32 carriers; `fake_quant` and `fake_quant_affine` round
with a straight-through estimator (STE), `project` is the same lattice
projection without it.

Every function here is elementwise float32 and is bit-identical to its JAX
counterpart: `torch.round` and `jnp.round` both round half to even, and the
clip bounds are the same float32 constants.  The raw fixed-point API
(`quantize`, `dequantize`, `fxp_add`, `fxp_mul`, the int64
`fxp_matmul_raw`) is not ported: no path of the port calls it
(`ROADMAP.md`).
"""

from __future__ import annotations

import dataclasses

import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class QFormat:
    """Two's-complement Qm.f fixed-point format.

    total_bits includes the sign bit: value = raw * 2**-frac_bits with
    raw ∈ [-2**(total_bits-1), 2**(total_bits-1) - 1].
    """

    total_bits: int
    frac_bits: int

    @property
    def int_bits(self) -> int:  # sign excluded
        return self.total_bits - 1 - self.frac_bits

    @property
    def scale(self) -> float:
        return float(2.0 ** (-self.frac_bits))

    @property
    def raw_min(self) -> int:
        return -(2 ** (self.total_bits - 1))

    @property
    def raw_max(self) -> int:
        return 2 ** (self.total_bits - 1) - 1

    @property
    def min_value(self) -> float:
        return self.raw_min * self.scale

    @property
    def max_value(self) -> float:
        return self.raw_max * self.scale

    def __repr__(self) -> str:  # Q15.16 style
        return f"Q{self.int_bits}.{self.frac_bits}"


FXP32 = QFormat(total_bits=32, frac_bits=16)  # Q15.16
FXP16 = QFormat(total_bits=16, frac_bits=8)  # Q7.8


def affine_params(a_min: Tensor, a_max: Tensor, n_bits: int) -> tuple[Tensor, Tensor]:
    """FIXAR's Q_n parameters: delta = (|A_min|+|A_max|)/(2^n - 1),
    z = round(-A_min/delta) (int32).  The range is widened to contain 0 so
    the affine grid holds 0 exactly (see the reference's docstring)."""
    a_min = torch.as_tensor(a_min, dtype=torch.float32)
    a_max = torch.as_tensor(a_max, dtype=torch.float32, device=a_min.device)
    a_min = torch.clamp(a_min, max=0.0)
    a_max = torch.clamp(a_max, min=0.0)
    span = torch.abs(a_min) + torch.abs(a_max)
    delta = torch.where(span > 0, span / (2.0**n_bits - 1.0), torch.ones_like(span))
    z = torch.round(-a_min / delta).to(torch.int32)
    return delta, z


class _STERound(torch.autograd.Function):
    """round-half-even forward, identity backward (straight-through)."""

    @staticmethod
    def forward(ctx, x):
        return torch.round(x)

    @staticmethod
    def backward(ctx, g):
        return g


def _clip_scaled(x: Tensor, fmt: QFormat) -> Tensor:
    """x·2^frac clipped to the raw range, as float32.  minimum/maximum (not
    clamp) so a value exactly on a bound gets half the gradient, as
    `jnp.clip` gives it."""
    # `full`, not `tensor`: a host-to-device copy of a constant would wait
    # for the device's queue on every call
    lo = torch.full((), float(fmt.raw_min), dtype=torch.float32, device=x.device)
    hi = torch.full((), float(fmt.raw_max), dtype=torch.float32, device=x.device)
    return torch.minimum(torch.maximum(x * float(2.0**fmt.frac_bits), lo), hi)


def fake_quant(x: Tensor, fmt: QFormat) -> Tensor:
    """Project x onto the Qm.f lattice with an STE gradient (identity inside
    the range, zero where the clip saturates)."""
    return _STERound.apply(_clip_scaled(x, fmt)) * fmt.scale


def project(x: Tensor, fmt: QFormat) -> Tensor:
    """`fake_quant` without the STE: same clip, same round-to-even, same
    values."""
    return torch.round(_clip_scaled(x, fmt)) * fmt.scale


def fake_quant_affine(x: Tensor, a_min: Tensor, a_max: Tensor, n_bits: int) -> Tensor:
    """Algorithm-1 activation quantization as a differentiable fake-quant:
    round(clip(x, lo, hi)/delta)*delta with the clip range of the n-bit
    grid; STE inside the range, zero gradient outside."""
    delta, z = affine_params(a_min, a_max, n_bits)
    delta = delta.to(x.device)
    zf = z.to(x.device, torch.float32)
    lo = -zf * delta
    hi = (((1 << n_bits) - 1) - z.to(x.device)).to(torch.float32) * delta
    xc = torch.minimum(torch.maximum(x, lo), hi)
    return _STERound.apply(xc / delta) * delta


__all__ = [
    "QFormat",
    "FXP32",
    "FXP16",
    "affine_params",
    "fake_quant",
    "fake_quant_affine",
    "project",
]
