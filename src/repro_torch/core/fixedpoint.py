"""Fixed-point (Qm.f) arithmetic in PyTorch — the fake-quant subset of
`repro.core.fixedpoint`.

FIXAR keeps weights and pre-delay activations on the Q15.16 lattice
(`FXP32`) and, after the quantization delay, fake-quantizes activations onto
an n-bit affine grid built from the monitored ranges (Algorithm 1's Q_n).
Values stay float32 carriers; `fake_quant` and `fake_quant_affine` round
with a straight-through estimator (STE), `project` is the same lattice
projection without it.

Every fake-quant function here is elementwise float32 and is bit-identical
to its JAX counterpart: `torch.round` and `jnp.round` both round half to
even, and the clip bounds are the same float32 constants.

The raw API (`quantize`, `dequantize`, `saturate`, `fxp_add`, `fxp_mul`,
`fxp_matmul_raw`, `affine_quantize`, `affine_dequantize`) carries
fixed-point values in int32 tensors and computes in exact int64 — the
reference's x64 semantics (it falls back to float32 value-space math when
JAX's x64 mode is off; the two agree inside FIXAR's envelope, partial sums
below 2^24).  Products round half up on the discarded bits,
`(acc + 2^(s-1)) >> s` with an arithmetic shift, and every result
saturates.  A float-to-int32 conversion saturates as XLA's does (NaN to 0,
±inf and out-of-range values to the int32 limits); PyTorch's own `.to(int32)`
does not, and gives -2^31 for 2^31 on the CPU.
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


# ---------------------------------------------------------------------------
# Raw (int carrier) API
# ---------------------------------------------------------------------------

_INT32_MIN, _INT32_MAX = -(2**31), 2**31 - 1


def _to_int32(x: Tensor) -> Tensor:
    """float -> int32 as XLA converts: truncate toward zero, saturate at the
    int32 limits, NaN to 0."""
    xd = torch.clamp(x.to(torch.float64), _INT32_MIN, _INT32_MAX)
    return torch.where(torch.isnan(xd), torch.zeros_like(xd), xd).to(torch.int32)


def quantize(x: Tensor, fmt: QFormat) -> Tensor:
    """float -> raw fixed-point (int32 carrier), round-to-nearest-even, saturating."""
    scaled = torch.as_tensor(x, dtype=torch.float32) * float(2.0**fmt.frac_bits)
    # the reference clips in float32, where raw_max rounds up to 2^31, and
    # its conversion saturates that to raw_max: clipping in float64 agrees
    return saturate(torch.round(scaled), fmt)


def dequantize(raw: Tensor, fmt: QFormat) -> Tensor:
    """raw fixed-point -> float32 view."""
    return raw.to(torch.float32) * fmt.scale


def saturate(raw: Tensor, fmt: QFormat) -> Tensor:
    """Clip raw values to the format's range, as int32 (a float input is
    truncated toward zero, as the reference's conversion does)."""
    if raw.is_floating_point():
        return _to_int32(torch.clamp(raw.to(torch.float64), fmt.raw_min, fmt.raw_max))
    return torch.clamp(raw.to(torch.int64), fmt.raw_min, fmt.raw_max).to(torch.int32)


def _rescale(acc: Tensor, shift: int, out: QFormat) -> Tensor:
    """int64 accumulator -> `out`: round half up on the `shift` discarded
    bits (arithmetic shift), or shift left when `shift` < 0; saturate."""
    if shift > 0:
        acc = (acc + (1 << (shift - 1))) >> shift
    elif shift < 0:
        acc = acc << (-shift)
    return torch.clamp(acc, out.raw_min, out.raw_max).to(torch.int32)


def fxp_add(a: Tensor, b: Tensor, fmt: QFormat) -> Tensor:
    """Saturating fixed-point add (same format)."""
    return torch.clamp(a.to(torch.int64) + b.to(torch.int64), fmt.raw_min, fmt.raw_max).to(torch.int32)


def fxp_mul(a: Tensor, b: Tensor, fmt_a: QFormat, fmt_b: QFormat, out: QFormat) -> Tensor:
    """Saturating fixed-point multiply with re-scaling to `out` format:
    (a·2^-fa)(b·2^-fb) = ab·2^-(fa+fb), exact in int64, shifted to
    out.frac_bits with round-half-up (the FPGA's truncate + round)."""
    shift = fmt_a.frac_bits + fmt_b.frac_bits - out.frac_bits
    return _rescale(a.to(torch.int64) * b.to(torch.int64), shift, out)


# int64 products summed per chunk of K: bounds the (M, chunk, N) temporary
_MATMUL_CHUNK_ELEMS = 1 << 24


def _int64_matmul(a: Tensor, w: Tensor) -> Tensor:
    """Exact (M, K) @ (K, N) in int64 (wrapping, as int64 arithmetic does),
    as a K-chunked broadcast multiply and sum: CUDA has no int64 matmul.
    Integer sums are exact, so the chunking and the order never show."""
    m, k = a.shape
    n = w.shape[1]
    acc = torch.zeros((m, n), dtype=torch.int64, device=a.device)
    chunk = max(1, min(k, _MATMUL_CHUNK_ELEMS // max(1, m * n)))
    for k0 in range(0, k, chunk):
        acc += (a[:, k0 : k0 + chunk, None] * w[None, k0 : k0 + chunk, :]).sum(dim=1)
    return acc


def fxp_matmul_raw(a_raw: Tensor, w_raw: Tensor, fmt_a: QFormat, fmt_w: QFormat, out: QFormat) -> Tensor:
    """Fixed-point matmul on raw carriers: (..., K) @ (K, N).

    Accumulates exactly in int64 (K < 2^15 asserted, as the reference
    does), then rescales once at the end, like the AAP core's accumulator
    and single output-stage shifter."""
    k = a_raw.shape[-1]
    assert k < (1 << 15), f"int64 accumulation exactness bound exceeded: K={k}"
    shift = fmt_a.frac_bits + fmt_w.frac_bits - out.frac_bits
    lead = a_raw.shape[:-1]
    acc = _int64_matmul(a_raw.reshape(-1, k).to(torch.int64), w_raw.to(torch.int64))
    return _rescale(acc, shift, out).reshape(*lead, w_raw.shape[-1])


def affine_params(a_min: Tensor, a_max: Tensor, n_bits: int) -> tuple[Tensor, Tensor]:
    """FIXAR's Q_n parameters: delta = (|A_min|+|A_max|)/(2^n - 1),
    z = round(-A_min/delta) (int32).  The range is widened to contain 0 so
    the affine grid holds 0 exactly (see the reference's docstring)."""
    a_min = torch.as_tensor(a_min, dtype=torch.float32)
    a_max = torch.as_tensor(a_max, dtype=torch.float32, device=a_min.device)
    a_min = torch.clamp(a_min, max=0.0)
    a_max = torch.clamp(a_max, min=0.0)
    span = torch.abs(a_min) + torch.abs(a_max)
    # a tensor divisor, not a Python number: PyTorch's CUDA division by a
    # host scalar multiplies by its rounded reciprocal, one ulp off IEEE
    intervals = torch.full((), 2.0**n_bits - 1.0, dtype=torch.float32, device=span.device)
    delta = torch.where(span > 0, span / intervals, torch.ones_like(span))
    z = torch.round(-a_min / delta).to(torch.int32)
    return delta, z


def affine_quantize(x: Tensor, delta: Tensor, z: Tensor, n_bits: int) -> Tensor:
    """x -> unsigned n-bit code (int32 carrier): q = clip(round(x/delta) + z).
    As in the reference, round(x/delta) converts to int32 with saturation
    and the add of z is an int32 add."""
    r = torch.round(torch.as_tensor(x, dtype=torch.float32) / delta)
    q = _to_int32(r) + torch.as_tensor(z, dtype=torch.int32)
    return torch.clamp(q, 0, (1 << n_bits) - 1)


def affine_dequantize(q: Tensor, delta: Tensor, z: Tensor) -> Tensor:
    return (q - z).to(torch.float32) * delta


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


def quantization_error_bound(fmt: QFormat) -> float:
    """Half-ULP bound for round-to-nearest within range."""
    return 0.5 * fmt.scale


__all__ = [
    "QFormat", "FXP32", "FXP16",
    "quantize", "dequantize", "saturate",
    "fxp_add", "fxp_mul", "fxp_matmul_raw",
    "affine_params", "affine_quantize", "affine_dequantize",
    "fake_quant", "fake_quant_affine", "project",
    "quantization_error_bound",
]
