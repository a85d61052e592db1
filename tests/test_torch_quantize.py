"""Port parity: `repro_torch.kernels.quantize` (the standalone Algorithm-1
monitor + quantizer, kernel 6) against the JAX reference, bitwise.

On the CPU the port's `monitor_quant` takes its plain version, which is held
bit for bit against the reference's `monitor_quant` (its Pallas kernel in
interpret mode, as the reference's own tests run it) and against
`ref_monitor_quant`: the projection and the extrema are elementwise float32
and order-free, so nothing may differ.  The per-layer walk of
`tests/kernels/test_fxp_mlp.py::test_range_monitor_matches_quantize_kernel`
is repeated on the port's CPU path at the reference's rtol of 1e-6.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.kernels.quantize import monitor_quant as r_monitor_quant
from repro.kernels.quantize import ref_monitor_quant as r_ref

from repro_torch.kernels.quantize import monitor_quant, ref_monitor_quant
from repro_torch.kernels.quantize.kernel import monitor_quant_cuda

SHAPES = [(64,), (7, 33), (256, 400), (3, 5, 17), (1, 1), (1024,)]
RANGES = {"captured": (-3.0, 3.5), "empty": (np.inf, -np.inf)}


def _x(shape, seed=None, scale=4.0):
    rng = np.random.default_rng(sum(shape) if seed is None else seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _assert_bitwise(got, want, what):
    g, w = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert g.shape == w.shape, f"{what}: shape {g.shape} != {w.shape}"
    same = (g.view(np.int32) == w.view(np.int32)) | (np.isnan(g) & np.isnan(w))
    assert same.all(), f"{what}: {int((~same).sum())} elements differ"


def _reference(x, a_min, a_max, phase):
    args = (jnp.asarray(x), jnp.float32(a_min), jnp.float32(a_max), jnp.array(phase))
    return r_monitor_quant(*args), r_ref(*args)


@pytest.mark.parametrize("ranges", list(RANGES), ids=list(RANGES))
@pytest.mark.parametrize("phase", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_monitor_quant_matches_reference(shape, phase, ranges):
    a_min, a_max = RANGES[ranges]
    x = _x(shape)
    kernel, oracle = _reference(x, a_min, a_max, phase)
    got = monitor_quant(torch.from_numpy(x), a_min, a_max, phase)
    for g, k, o, name in zip(got, kernel, oracle, ("y", "new_min", "new_max")):
        assert g.dtype == torch.float32
        _assert_bitwise(g.numpy(), k, f"{name} vs the reference kernel")
        _assert_bitwise(g.numpy(), o, f"{name} vs ref_monitor_quant")
    assert got[0].shape == shape and got[1].shape == () and got[2].shape == ()


@pytest.mark.parametrize("seed", range(6))
def test_monitor_is_exact_minmax(seed):
    """Monitor phase: the ranges are the exact extrema folded into the
    incoming ones; nothing past the last element reaches them."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-50, 50, size=int(rng.integers(1, 300))).astype(np.float32)
    _, nmin, nmax = monitor_quant(torch.from_numpy(x), 1e30, -1e30, False)
    assert float(nmin) == float(x.min()) and float(nmax) == float(x.max())
    _, nmin, nmax = monitor_quant(torch.from_numpy(x), -60.0, 60.0, False)
    assert float(nmin) == -60.0 and float(nmax) == 60.0


def test_monitoring_frozen_in_quant_phase():
    x = torch.tensor([100.0, -100.0])
    y, nmin, nmax = monitor_quant(x, -1.0, 1.0, True)
    assert float(nmin) == -1.0 and float(nmax) == 1.0
    # clipped onto the grid of the frozen range, whose ends are codes 0 and 2^16 - 1
    assert float(y[0]) <= 1.0 + 1e-4 and float(y[1]) >= -1.0 - 1e-4


@pytest.mark.parametrize("phase", [False, True])
def test_nan_propagates_as_in_the_reference(phase):
    """jnp.min/jnp.minimum propagate NaN: in the monitor phase both extrema
    become NaN; in the quant phase the frozen range stays; y keeps the NaN."""
    x = _x((5, 9), seed=3)
    x[2, 4] = np.nan
    kernel, oracle = _reference(x, -3.0, 3.5, phase)
    got = monitor_quant(torch.from_numpy(x), -3.0, 3.5, phase)
    for g, k, o, name in zip(got, kernel, oracle, ("y", "new_min", "new_max")):
        _assert_bitwise(g.numpy(), k, name)
        _assert_bitwise(g.numpy(), o, name)
    assert np.isnan(got[1].item()) != phase and np.isnan(got[2].item()) != phase
    assert np.isnan(got[0][2, 4].item())


@pytest.mark.parametrize("phase", [False, True])
@pytest.mark.parametrize("dtype", [torch.bool, torch.int32, torch.int64])
def test_phase_and_ranges_as_tensors(dtype, phase):
    x = torch.from_numpy(_x((17, 23)))
    want = monitor_quant(x, -3.0, 3.5, phase)
    got = monitor_quant(x, torch.tensor(-3.0), torch.tensor(3.5), torch.tensor(phase, dtype=dtype))
    for g, w, name in zip(got, want, ("y", "new_min", "new_max")):
        _assert_bitwise(g.numpy(), w.numpy(), name)


@pytest.mark.parametrize("batch", [1, 7, 64])
def test_fused_monitor_matches_layer_walk(batch):
    """The fused forward's in-pipeline monitor equals `monitor_quant` fed
    each layer's site input, walking the per-layer datapath (site
    projection + dense layer), monitor phase, at the paper's actor width."""
    from repro_torch.core import fixedpoint as fxp
    from repro_torch.kernels.fxp_matmul import fxp_dense
    from repro_torch.kernels.fxp_mlp.ops import fxp_mlp_forward

    dims, acts = (17, 400, 300, 6), ("relu", "relu", "tanh")
    rng = np.random.default_rng(5)
    ws = [torch.from_numpy(rng.uniform(-0.2, 0.2, (k, n)).astype(np.float32)) for k, n in zip(dims[:-1], dims[1:])]
    bs = [torch.from_numpy(rng.uniform(-0.2, 0.2, (n,)).astype(np.float32)) for n in dims[1:]]
    x = torch.from_numpy(_x((batch, dims[0]), seed=11))
    deltas, zs = fxp.affine_params(torch.full((3,), -2.0), torch.full((3,), 2.5), 16)
    _, mins, maxs = fxp_mlp_forward(x, ws, bs, deltas, zs.to(torch.float32), activations=acts, quant_phase=False)
    xi = x
    for i in range(len(ws)):
        yi, nmin, nmax = monitor_quant(xi, float("inf"), float("-inf"), False)
        _assert_bitwise(yi.numpy(), fxp.fake_quant(xi, fxp.FXP32).numpy(), f"site {i} projection")
        np.testing.assert_allclose(float(mins[i]), float(nmin), rtol=1e-6, err_msg=f"site {i} min")
        np.testing.assert_allclose(float(maxs[i]), float(nmax), rtol=1e-6, err_msg=f"site {i} max")
        xi = fxp_dense(yi, ws[i], bs[i], full_precision=True, activation=acts[i])


def test_cpu_tensors_never_launch_the_kernel():
    before = monitor_quant_cuda.launches
    monitor_quant(torch.from_numpy(_x((128, 400))), -3.0, 3.5, False)
    monitor_quant(torch.from_numpy(_x((128, 400))), -3.0, 3.5, torch.tensor(True))
    assert monitor_quant_cuda.launches == before


def test_kernel_wrapper_refuses_cpu_tensors():
    """The kernel's wrapper launches on CUDA tensors or raises: it has no
    CPU path of its own."""
    x = torch.from_numpy(_x((64,)))
    with pytest.raises(ValueError, match="CUDA"):
        monitor_quant_cuda(x, torch.tensor([-1.0]), torch.tensor([1.0]), torch.tensor([0], dtype=torch.int32))


def test_empty_input_raises():
    with pytest.raises(RuntimeError):
        monitor_quant(torch.zeros(0), -1.0, 1.0, False)
