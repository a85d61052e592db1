"""Port parity: repro_torch.core (fixed point, ranges, QAT snapshot) against
the JAX reference.

Every function compared here is elementwise float32, so the contract is
bitwise equality — including the exact half-way ties that pin the
round-half-to-even rule (x·2¹⁶ = k + 0.5, x/δ = k + 0.5, and bf16 limb
ties).  Inputs are made with numpy and handed to both sides.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401  (one intra-op thread a worker)

import jax
import jax.numpy as jnp

from repro.core import fixedpoint as rfxp
from repro.core import qat as rqat
from repro.core import ranges as rranges
from repro.kernels.fxp_matmul.ref import limb_split as r_limb_split

from repro_torch.convert import frozen_from_numpy
from repro_torch.core import fixedpoint as pfxp
from repro_torch.core import qat as pqat
from repro_torch.core import ranges as pranges
from repro_torch.kernels.fxp_matmul.ref import limb_split as p_limb_split


def _values(seed: int = 0) -> np.ndarray:
    """Random values, Q15.16 half-way ties of both parities and signs, and
    values beyond the Q15.16 range (saturation)."""
    rng = np.random.default_rng(seed)
    k = np.arange(-6, 7, dtype=np.float64)
    ties = ((k + 0.5) / 65536.0).astype(np.float32)
    big = np.array([32767.9, -32768.0, 40000.0, -40000.0, 1e10, -1e10, 0.0, -0.0], np.float32)
    rand = (rng.normal(size=200) * 10).astype(np.float32)
    return np.concatenate([ties, big, rand]).astype(np.float32)


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.mark.parametrize("fmt_name", ["FXP32", "FXP16"])
@pytest.mark.parametrize("fn", ["fake_quant", "project"])
def test_lattice_projection_bitwise(fn, fmt_name):
    x = _values()
    got = getattr(pfxp, fn)(torch.from_numpy(x), getattr(pfxp, fmt_name))
    want = getattr(rfxp, fn)(jnp.asarray(x), getattr(rfxp, fmt_name))
    np.testing.assert_array_equal(_np(got), np.asarray(want))


def test_half_way_ties_round_to_even():
    """x·2¹⁶ = k + 0.5 lands on the even neighbour (torch.round == jnp.round)."""
    k = np.array([0, 1, 2, 3, -1, -2, -3], np.float64)
    x = ((k + 0.5) / 65536.0).astype(np.float32)
    got = _np(pfxp.fake_quant(torch.from_numpy(x), pfxp.FXP32)) * 65536.0
    np.testing.assert_array_equal(got, np.array([0, 2, 2, 4, 0, -2, -2], np.float32))


def test_qformat_matches_reference():
    for name in ("FXP32", "FXP16"):
        p, r = getattr(pfxp, name), getattr(rfxp, name)
        assert (p.total_bits, p.frac_bits, p.int_bits, p.scale) == (r.total_bits, r.frac_bits, r.int_bits, r.scale)
        assert (p.raw_min, p.raw_max, p.min_value, p.max_value, repr(p)) == (
            r.raw_min, r.raw_max, r.min_value, r.max_value, repr(r))


RANGES = [(-1.0, 1.0), (-3.7, 2.1), (0.5, 3.0), (-2.0, -0.5), (0.0, 0.0), (-1e-3, 1e-3), (-8.27, 8.16)]


@pytest.mark.parametrize("n_bits", [8, 16])
@pytest.mark.parametrize("a_min,a_max", RANGES)
def test_affine_params_bitwise(a_min, a_max, n_bits):
    d, z = pfxp.affine_params(torch.tensor(a_min), torch.tensor(a_max), n_bits)
    rd, rz = rfxp.affine_params(jnp.float32(a_min), jnp.float32(a_max), n_bits)
    np.testing.assert_array_equal(_np(d), np.asarray(rd))
    assert int(z) == int(rz) and z.dtype == torch.int32


@pytest.mark.parametrize("n_bits", [8, 16])
@pytest.mark.parametrize("a_min,a_max", RANGES)
def test_fake_quant_affine_bitwise(a_min, a_max, n_bits):
    x = _values(1) / 8
    got = pfxp.fake_quant_affine(torch.from_numpy(x), torch.tensor(a_min), torch.tensor(a_max), n_bits)
    want = rfxp.fake_quant_affine(jnp.asarray(x), jnp.float32(a_min), jnp.float32(a_max), n_bits)
    np.testing.assert_array_equal(_np(got), np.asarray(want))


def test_fake_quant_affine_ties_round_to_even():
    """δ = 2⁻⁶ exactly (span 255·2⁻⁶ over 8 bits), so x/δ = k + 0.5 is an
    exact tie; both sides pick the even code."""
    a_min, a_max = -100 * 2.0**-6, 155 * 2.0**-6
    k = np.arange(-20, 21, dtype=np.float64)
    x = ((k + 0.5) * 2.0**-6).astype(np.float32)
    got = _np(pfxp.fake_quant_affine(torch.from_numpy(x), torch.tensor(a_min), torch.tensor(a_max), 8))
    want = np.asarray(rfxp.fake_quant_affine(jnp.asarray(x), jnp.float32(a_min), jnp.float32(a_max), 8))
    np.testing.assert_array_equal(got, want)
    codes = got / 2.0**-6
    np.testing.assert_array_equal(codes % 2, np.zeros_like(codes))


def test_limb_split_bitwise_including_bf16_ties():
    rng = np.random.default_rng(3)
    # random sign and mantissa, exponents within 2^±60: the lo limb stays a
    # normal float (the JAX CPU backend flushes subnormals, PyTorch does not)
    sign = rng.integers(0, 2, size=256).astype(np.uint32) << np.uint32(31)
    expo = rng.integers(127 - 60, 127 + 60, size=256).astype(np.uint32) << np.uint32(23)
    mant = rng.integers(0, 2**23, size=256).astype(np.uint32)
    bits = sign | expo | mant
    tie = (bits & np.uint32(0xFFFF0000)) | np.uint32(0x8000)  # exactly half a bf16 ulp
    x = np.concatenate([bits.view(np.float32), tie.view(np.float32), _values()])
    hi, lo = p_limb_split(torch.from_numpy(x))
    rhi, rlo = r_limb_split(jnp.asarray(x))
    np.testing.assert_array_equal(_np(hi), np.asarray(rhi))
    np.testing.assert_array_equal(_np(lo), np.asarray(rlo))
    np.testing.assert_array_equal(_np(hi + lo), x)
    hi_only, none = p_limb_split(torch.from_numpy(x), with_lo=False)
    assert none is None
    np.testing.assert_array_equal(_np(hi_only), np.asarray(rhi))


def _stats(a_min, a_max, count):
    p = pranges.RangeStat(
        a_min=torch.tensor(a_min, dtype=torch.float32),
        a_max=torch.tensor(a_max, dtype=torch.float32),
        count=torch.tensor(count, dtype=torch.int32),
    )
    r = rranges.RangeStat(a_min=jnp.float32(a_min), a_max=jnp.float32(a_max), count=jnp.int32(count))
    return p, r


@pytest.mark.parametrize(
    "a_min,a_max,count",
    [(np.inf, -np.inf, 0), (2.0, 2.0, 5), (-1.5, 3.25, 7), (0.0, 1e-7, 2), (-4.0, -3.9999995, 1)],
    ids=["never-updated", "constant", "normal", "tiny-span", "sub-guard-span"],
)
def test_finalized_guards_bitwise(a_min, a_max, count):
    p, r = _stats(a_min, a_max, count)
    for got, want in zip(pranges.finalized(p), rranges.finalized(r)):
        np.testing.assert_array_equal(_np(got), np.asarray(want))


def test_update_minmax_scalar_and_init():
    p = pranges.RangeStat.init(device="cpu")
    r = rranges.RangeStat.init()
    for mn, mx in [(-1.0, 2.0), (-0.5, 3.5), (-2.25, 0.0)]:
        p = pranges.update_minmax_scalar(p, torch.tensor(mn), torch.tensor(mx))
        r = rranges.update_minmax_scalar(r, jnp.float32(mn), jnp.float32(mx))
    assert (float(p.a_min), float(p.a_max), int(p.count)) == (float(r.a_min), float(r.a_max), int(r.count))
    assert set(pranges.init_ranges(["a", "b"], device="cpu")) == {"a", "b"}


def test_qat_state_phase_and_tick():
    p = pqat.QATState.init(delay=2, sites=["s"], device="cpu")
    r = rqat.QATState.init(delay=2, sites=["s"])
    for _ in range(4):
        assert bool(p.quantized_phase) == bool(r.quantized_phase)
        p, r = p.tick(), r.tick()
    assert int(p.step) == int(r.step) == 4


def _reference_frozen(n_bits: int, fxp32_phase1: bool, quantized: bool):
    """A reference FrozenQuant over three sites with captured ranges."""
    sites = ["s0", "s1", "s2"]
    state = rqat.QATState.init(delay=0 if quantized else 10**9, sites=sites, n_bits=n_bits,
                               fxp32_phase1=fxp32_phase1)
    for name, (mn, mx) in zip(sites, [(-3.0, 2.5), (0.0, 4.75), (-0.25, 1.0)]):
        state.ranges[name] = rranges.update_minmax_scalar(state.ranges[name], jnp.float32(mn), jnp.float32(mx))
    return rqat.freeze_quant(state, sites), state


def _port_frozen(ref) -> pqat.FrozenQuant:
    return frozen_from_numpy(
        np.asarray(ref.a_mins), np.asarray(ref.a_maxs), np.asarray(ref.deltas), np.asarray(ref.zs),
        quantized=ref.quantized, n_bits=ref.n_bits, fxp32_phase1=ref.fxp32_phase1, device="cpu",
    )


@pytest.mark.parametrize("quantized,fxp32_phase1,n_bits", [(True, True, 16), (True, True, 8),
                                                         (False, True, 16), (False, False, 16)])
def test_frozen_site_bitwise(quantized, fxp32_phase1, n_bits):
    ref, _ = _reference_frozen(n_bits, fxp32_phase1, quantized)
    port = _port_frozen(ref)
    x = _values(5) / 4
    for i in range(3):
        got = port.site(i, torch.from_numpy(x))
        want = ref.site(i, jnp.asarray(x))
        np.testing.assert_array_equal(_np(got), np.asarray(want), err_msg=f"site {i}")


@pytest.mark.parametrize("quantized", [True, False])
def test_freeze_quant_matches_reference(quantized):
    ref, ref_state = _reference_frozen(16, True, quantized)
    p = pqat.QATState.init(delay=0 if quantized else 10**9, sites=["s0", "s1", "s2"], device="cpu")
    for name, (mn, mx) in zip(["s0", "s1", "s2"], [(-3.0, 2.5), (0.0, 4.75), (-0.25, 1.0)]):
        p.ranges[name] = pranges.update_minmax_scalar(p.ranges[name], torch.tensor(mn), torch.tensor(mx))
    got = pqat.freeze_quant(p, ["s0", "s1", "s2"])
    assert got.quantized == ref.quantized and got.n_bits == ref.n_bits
    for field in ("a_mins", "a_maxs", "deltas", "zs"):
        np.testing.assert_array_equal(_np(getattr(got, field)), np.asarray(getattr(ref, field)), err_msg=field)
    with pytest.raises(KeyError, match="not registered"):
        pqat.freeze_quant(p, ["missing"])
    off = pqat.QATState.init(delay=0, sites=["s0"], enabled=False, device="cpu")
    assert pqat.freeze_quant(off, ["s0"]) is None


def test_fake_quant_ste_gradient_matches_reference():
    """STE: identity inside the Q15.16 range, zero where the clip saturates,
    and half on a value exactly at a bound (-32768 here), as jnp.clip."""
    x = _values(7)
    xt = torch.from_numpy(x).requires_grad_(True)
    pfxp.fake_quant(xt, pfxp.FXP32).sum().backward()
    want = jax.grad(lambda v: rfxp.fake_quant(v, rfxp.FXP32).sum())(jnp.asarray(x))
    np.testing.assert_array_equal(_np(xt.grad), np.asarray(want))
    assert set(np.unique(_np(xt.grad))) == {0.0, 0.5, 1.0}
    assert _np(xt.grad)[np.abs(x) > 40000].sum() == 0.0


def test_fake_quant_affine_ste_gradient_matches_reference():
    x = _values(8) / 4
    xt = torch.from_numpy(x).requires_grad_(True)
    pfxp.fake_quant_affine(xt, torch.tensor(-1.5), torch.tensor(2.0), 16).sum().backward()
    want = jax.grad(lambda v: rfxp.fake_quant_affine(v, jnp.float32(-1.5), jnp.float32(2.0), 16).sum())(
        jnp.asarray(x))
    np.testing.assert_array_equal(_np(xt.grad), np.asarray(want))
