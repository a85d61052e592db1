"""Port parity: the raw fixed-point API of `repro_torch.core.fixedpoint`
(int32 carriers, exact int64 arithmetic) against the JAX reference with
x64 on, and against the numpy int64 oracle of
`tests/test_fixedpoint.py::test_fxp_matmul_raw_exact_vs_int64` — bitwise.

The reference computes in int64 only under JAX's x64 mode; without it, it
falls back to float32 value-space math, exact inside FIXAR's envelope
(partial sums below 2^24), where the port must agree with it too.  Float to
int32 conversions saturate as XLA's do (NaN to 0): `quantize(40000.0,
FXP32)` is 2^31 - 1, where PyTorch's own CPU cast would give -2^31.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.core import fixedpoint as rfxp

from repro_torch.core import fixedpoint as pfxp

FORMATS = {"fxp32": (32, 16), "fxp16": (16, 8), "q3_4": (8, 4), "q13_2": (16, 2)}
_enable_x64 = jax.enable_x64 if hasattr(jax, "enable_x64") else jax.experimental.enable_x64


def _fmts(name):
    bits = FORMATS[name]
    return rfxp.QFormat(*bits), pfxp.QFormat(*bits)


def _eq(got, want, what=""):
    g, w = got.numpy(), np.asarray(want)
    assert g.dtype == w.dtype, f"{what}: dtype {g.dtype} != {w.dtype}"
    if g.dtype.kind == "f":
        same = (g.view(np.int32) == w.view(np.int32)) | (np.isnan(g) & np.isnan(w))
        assert same.all(), f"{what}: {g} != {w}"
    else:
        np.testing.assert_array_equal(g, w, err_msg=what)


def _raw(seed, shape, lo=-(2**31), hi=2**31 - 1):
    return np.random.default_rng(seed).integers(lo, hi, size=shape, endpoint=True).astype(np.int32)


EDGES = np.array([40000.0, -40000.0, 32768.0, -32768.0, 32767.99999, np.inf, -np.inf, np.nan, 0.0, -0.0,
                  0.5 / 65536, 1.5 / 65536, 2.5 / 65536, -2.5 / 65536, 3.5 / 256, 1e-30], np.float32)


@pytest.mark.parametrize("fmt", list(FORMATS))
def test_quantize_and_dequantize_match_reference(fmt):
    r, p = _fmts(fmt)
    x = np.concatenate([EDGES, (np.random.default_rng(0).standard_normal(500) * 300).astype(np.float32)])
    with _enable_x64(True):
        want = rfxp.quantize(jnp.asarray(x), r)
        back = rfxp.dequantize(want, r)
    got = pfxp.quantize(torch.from_numpy(x), p)
    _eq(got, want, "quantize")
    _eq(pfxp.dequantize(got, p), back, "dequantize")
    # the same without x64: the reference's quantize has one path
    _eq(got, rfxp.quantize(jnp.asarray(x), r), "quantize, no x64")


def test_quantize_saturates_and_rounds_half_to_even():
    got = pfxp.quantize(torch.tensor([40000.0, -40000.0, np.nan, 0.5 / 65536, 1.5 / 65536, 2.5 / 65536]), pfxp.FXP32)
    assert got.tolist() == [2147483647, -2147483648, 0, 0, 2, 2]


@pytest.mark.parametrize("fmt", list(FORMATS))
def test_saturate_matches_reference(fmt):
    r, p = _fmts(fmt)
    ints = np.array([2**40, -(2**40), 2**31 - 1, -(2**31), 7, -7, 0], np.int64)
    floats = np.array([1.7, -1.7, 1e10, -1e10, np.nan, np.inf, 2.5], np.float32)
    with _enable_x64(True):
        want_i = rfxp.saturate(jnp.asarray(ints), r)
    want_f = rfxp.saturate(jnp.asarray(floats), r)
    _eq(pfxp.saturate(torch.from_numpy(ints), p), want_i, "int64")
    _eq(pfxp.saturate(torch.from_numpy(floats), p), want_f, "float32")


@pytest.mark.parametrize("fmt", list(FORMATS))
def test_fxp_add_matches_reference_and_oracle(fmt):
    r, p = _fmts(fmt)
    a = np.concatenate([_raw(1, 300, r.raw_min, r.raw_max), [r.raw_max, r.raw_min, r.raw_max, -1]]).astype(np.int32)
    b = np.concatenate([_raw(2, 300, r.raw_min, r.raw_max), [r.raw_max, r.raw_min, 1, r.raw_min]]).astype(np.int32)
    oracle = np.clip(a.astype(np.int64) + b, r.raw_min, r.raw_max).astype(np.int32)
    with _enable_x64(True):
        want = rfxp.fxp_add(jnp.asarray(a), jnp.asarray(b), r)
    got = pfxp.fxp_add(torch.from_numpy(a), torch.from_numpy(b), p)
    _eq(got, want, "vs reference")
    _eq(got, oracle, "vs oracle")


@pytest.mark.parametrize(
    "fa,fb,out", [("fxp32", "fxp32", "fxp32"), ("fxp16", "fxp16", "fxp16"), ("fxp16", "fxp16", "fxp32"),
                  ("q13_2", "q3_4", "fxp32"), ("fxp32", "fxp16", "q3_4")],
)
def test_fxp_mul_matches_reference_and_oracle(fa, fb, out):
    """Shifts > 0 (round half up, arithmetic shift), == 0 and < 0, with
    saturation; ties on the discarded bits included."""
    (ra, pa), (rb, pb), (ro, po) = _fmts(fa), _fmts(fb), _fmts(out)
    a = np.concatenate([_raw(3, 400, ra.raw_min, ra.raw_max), [ra.raw_max, ra.raw_min, 1, -1, 3, -3]])
    b = np.concatenate([_raw(4, 400, rb.raw_min, rb.raw_max), [rb.raw_max, rb.raw_max, 1, 1, 1, 1]])
    a, b = a.astype(np.int32), b.astype(np.int32)
    shift = ra.frac_bits + rb.frac_bits - ro.frac_bits
    prod = a.astype(np.int64) * b.astype(np.int64)
    prod = (prod + (1 << (shift - 1))) >> shift if shift > 0 else prod << (-shift)
    oracle = np.clip(prod, ro.raw_min, ro.raw_max).astype(np.int32)
    with _enable_x64(True):
        want = rfxp.fxp_mul(jnp.asarray(a), jnp.asarray(b), ra, rb, ro)
    got = pfxp.fxp_mul(torch.from_numpy(a), torch.from_numpy(b), pa, pb, po)
    _eq(got, want, "vs reference")
    _eq(got, oracle, "vs oracle")


def _matmul_oracle(ar, wr, shift, fmt):
    acc = ar.astype(np.int64) @ wr.astype(np.int64)
    return np.clip((acc + (1 << (shift - 1))) >> shift, fmt.raw_min, fmt.raw_max).astype(np.int32)


@pytest.mark.parametrize("shape", [(8, 21, 5), (1, 17, 400), (33, 300, 6)])
def test_fxp_matmul_raw_matches_reference_and_oracle(shape):
    m, k, n = shape
    rng = np.random.default_rng(k)
    a = rng.uniform(-4, 4, (m, k)).astype(np.float32)
    w = rng.uniform(-2, 2, (k, n)).astype(np.float32)
    ar, wr = pfxp.quantize(torch.from_numpy(a), pfxp.FXP32), pfxp.quantize(torch.from_numpy(w), pfxp.FXP32)
    oracle = _matmul_oracle(ar.numpy(), wr.numpy(), 16, rfxp.FXP32)
    with _enable_x64(True):
        want = rfxp.fxp_matmul_raw(jnp.asarray(ar.numpy()), jnp.asarray(wr.numpy()), rfxp.FXP32, rfxp.FXP32, rfxp.FXP32)
    got = pfxp.fxp_matmul_raw(ar, wr, pfxp.FXP32, pfxp.FXP32, pfxp.FXP32)
    _eq(got, want, "vs reference")
    _eq(got, oracle, "vs oracle")


def test_fxp_matmul_raw_batched_saturating_and_chunked(monkeypatch):
    """Leading dims flatten and come back; full-range carriers saturate;
    a tiny K chunk gives the same exact sums."""
    a, w = _raw(5, (2, 3, 17)), _raw(6, (17, 4))
    oracle = np.stack([_matmul_oracle(a[i], w, 16, rfxp.FXP32) for i in range(2)])
    with _enable_x64(True):
        want = rfxp.fxp_matmul_raw(jnp.asarray(a), jnp.asarray(w), rfxp.FXP32, rfxp.FXP32, rfxp.FXP32)
    got = pfxp.fxp_matmul_raw(torch.from_numpy(a), torch.from_numpy(w), pfxp.FXP32, pfxp.FXP32, pfxp.FXP32)
    _eq(got, want, "vs reference")
    _eq(got, oracle, "vs oracle")
    assert (np.abs(oracle) == 2**31 - 1).any() or (oracle == -(2**31)).any()
    monkeypatch.setattr(pfxp, "_MATMUL_CHUNK_ELEMS", 1)
    _eq(pfxp.fxp_matmul_raw(torch.from_numpy(a), torch.from_numpy(w), pfxp.FXP32, pfxp.FXP32, pfxp.FXP32),
        oracle, "chunked")


def test_fxp_matmul_raw_asserts_k_bound():
    with pytest.raises(AssertionError):
        pfxp.fxp_matmul_raw(torch.zeros(1, 1 << 15, dtype=torch.int32), torch.zeros(1 << 15, 1, dtype=torch.int32),
                            pfxp.FXP32, pfxp.FXP32, pfxp.FXP32)


def test_raw_api_agrees_with_the_no_x64_path_inside_the_envelope():
    """Without x64 the reference computes on float32 values, exact while
    |partial sums| < 2^24: there both regimes and the port agree."""
    rng = np.random.default_rng(8)
    a = rng.integers(-64, 64, (16, 24)).astype(np.int32)
    w = rng.integers(-64, 64, (24, 9)).astype(np.int32)
    b = rng.integers(-2000, 2000, (16, 24)).astype(np.int32)
    f = rfxp.QFormat(32, 4)
    p = pfxp.QFormat(32, 4)
    _eq(pfxp.fxp_matmul_raw(torch.from_numpy(a), torch.from_numpy(w), p, p, p),
        rfxp.fxp_matmul_raw(jnp.asarray(a), jnp.asarray(w), f, f, f), "matmul")
    _eq(pfxp.fxp_add(torch.from_numpy(a), torch.from_numpy(b), p), rfxp.fxp_add(jnp.asarray(a), jnp.asarray(b), f),
        "add")
    _eq(pfxp.fxp_mul(torch.from_numpy(a), torch.from_numpy(b), p, p, p),
        rfxp.fxp_mul(jnp.asarray(a), jnp.asarray(b), f, f, f), "mul")


@pytest.mark.parametrize("ranges", [(-3.0, 3.5), (0.5, 2.0), (-2.0, -0.25), (0.0, 0.0)])
def test_affine_quantize_roundtrip_matches_reference(ranges):
    """Codes (with the saturating int32 conversion, the int32 add of z and
    the clip), their dequantized values and the parameters, bitwise; the
    ties land on even codes."""
    r_delta, r_z = rfxp.affine_params(jnp.float32(ranges[0]), jnp.float32(ranges[1]), 16)
    p_delta, p_z = pfxp.affine_params(torch.tensor(ranges[0]), torch.tensor(ranges[1]), 16)
    _eq(p_delta, r_delta, "delta")
    _eq(p_z, r_z, "z")
    d = np.float32(r_delta)
    x = np.concatenate([(np.random.default_rng(9).standard_normal(400) * 3).astype(np.float32),
                        np.array([1e12, -1e12, np.nan, np.inf, 2.5 * d, 3.5 * d, -2.5 * d], np.float32)])
    want = rfxp.affine_quantize(jnp.asarray(x), r_delta, r_z, 16)
    got = pfxp.affine_quantize(torch.from_numpy(x), p_delta, p_z, 16)
    _eq(got, want, "codes")
    _eq(pfxp.affine_dequantize(got, p_delta, p_z), rfxp.affine_dequantize(want, r_delta, r_z), "dequantize")


def test_quantization_error_bound_and_exports():
    assert pfxp.quantization_error_bound(pfxp.FXP32) == rfxp.quantization_error_bound(rfxp.FXP32)
    assert pfxp.quantization_error_bound(pfxp.FXP16) == rfxp.quantization_error_bound(rfxp.FXP16)
    assert set(pfxp.__all__) == set(rfxp.__all__)
    import repro.core as rcore

    import repro_torch.core as pcore

    import types

    names = {n for n, v in vars(rcore).items() if not n.startswith("_") and not isinstance(v, types.ModuleType)
             and getattr(v, "__module__", "") != "repro.core.parallelism"}
    assert {"quantize", "fxp_matmul_raw", "QATContext", "RangeStat"} <= names
    missing = {n for n in names if not hasattr(pcore, n)}
    assert not missing, missing
