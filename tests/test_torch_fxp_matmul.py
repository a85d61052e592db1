"""Port parity: repro_torch.kernels.fxp_matmul (the dual-precision dense
layer) against the JAX reference.

On the CPU the port's `fxp_dense` takes its plain version, which is held
against the reference's Pallas kernel (interpret mode) and its pure-jnp
oracle at the reference's contract, rtol = atol = 2e-5.  The CUDA kernel is
held against the same plain version on the card (chip_smoke.py and
tests/test_torch_kernels_cuda.py).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.core import qat as rqat
from repro.core import ranges as rranges
from repro.kernels.fxp_matmul import ops as rops
from repro.kernels.fxp_matmul import ref as rref

from repro_torch.convert import frozen_from_numpy
from repro_torch.kernels.fxp_matmul import kernel as pkernel
from repro_torch.kernels.fxp_matmul import ops as pops
from repro_torch.kernels.fxp_matmul import ref as pref

TOL = dict(rtol=2e-5, atol=2e-5)
# (M, K, N): the actor's layer shapes at small batch, and ragged ones
SHAPES = [(1, 17, 400), (7, 33, 5), (13, 300, 6), (3, 5, 129), (40, 400, 300)]


def _operands(m, k, n, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(m, k)) * 2).astype(np.float32)
    w = rng.uniform(-k**-0.5, k**-0.5, size=(k, n)).astype(np.float32)
    b = rng.uniform(-0.1, 0.1, size=(n,)).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("activation", ["relu", "tanh", "none"])
@pytest.mark.parametrize("full", [True, False])
@pytest.mark.parametrize("shape", SHAPES, ids=[f"{m}x{k}x{n}" for m, k, n in SHAPES])
def test_fxp_dense_matches_reference_oracle(shape, full, activation):
    x, w, b = _operands(*shape)
    got = pops.fxp_dense(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
                         full_precision=full, activation=activation)
    want = rref.ref_fxp_dense(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                              full_precision=full, activation=activation)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("activation", ["relu", "tanh", "none"])
@pytest.mark.parametrize("full", [True, False])
@pytest.mark.parametrize("shape", SHAPES[:3], ids=[f"{m}x{k}x{n}" for m, k, n in SHAPES[:3]])
def test_fxp_dense_matches_reference_pallas_kernel(shape, full, activation):
    x, w, b = _operands(*shape, seed=1)
    got = pops.fxp_dense(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
                         full_precision=full, activation=activation)
    want = rops.fxp_dense(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                          full_precision=full, activation=activation)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_fxp_dense_without_bias_and_leading_dims():
    x, w, _ = _operands(12, 33, 7, seed=2)
    x3 = x.reshape(3, 4, 33)
    got = pops.fxp_dense(torch.from_numpy(x3), torch.from_numpy(w), None, activation="tanh")
    want = rops.fxp_dense(jnp.asarray(x3), jnp.asarray(w), None, activation="tanh")
    assert got.shape == (3, 4, 7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_plain_version_uses_exact_limbs():
    """Full precision sums the hi and lo dots: equal to x @ w up to f32
    rounding, while half precision drops the lo limb."""
    x, w, b = _operands(16, 400, 300, seed=3)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    full = pref.ref_fxp_dense(xt, wt, full_precision=True)
    half = pref.ref_fxp_dense(xt, wt, full_precision=False)
    np.testing.assert_allclose(full.numpy(), (xt.double() @ wt.double()).numpy(), rtol=1e-5, atol=1e-5)
    hi, _ = pref.limb_split(xt)
    np.testing.assert_allclose(half.numpy(), (hi.double() @ wt.double()).numpy(), rtol=1e-5, atol=1e-5)
    assert pref.ref_flops(16, 300, 400, True) == rref.ref_flops(16, 300, 400, True)


def _frozen(quantized: bool, dims):
    """A reference FrozenQuant over len(dims)-1 sites and the port's copy."""
    sites = [f"s{i}" for i in range(len(dims) - 1)]
    state = rqat.QATState.init(delay=0 if quantized else 10**9, sites=sites)
    for i, name in enumerate(sites):
        state.ranges[name] = rranges.update_minmax_scalar(
            state.ranges[name], jnp.float32(-1.0 - i), jnp.float32(1.5 + i))
    ref = rqat.freeze_quant(state, sites)
    port = frozen_from_numpy(np.asarray(ref.a_mins), np.asarray(ref.a_maxs), np.asarray(ref.deltas),
                             np.asarray(ref.zs), quantized=ref.quantized, n_bits=ref.n_bits,
                             fxp32_phase1=ref.fxp32_phase1, device="cpu")
    return ref, port


@pytest.mark.parametrize("quantized", [True, False])
def test_fxp_dense_chain_with_frozen_sites(quantized):
    dims, acts = (5, 32, 24, 3), ("relu", "relu", "tanh")
    rng = np.random.default_rng(4)
    ws = [rng.uniform(-0.4, 0.4, size=(k, n)).astype(np.float32) for k, n in zip(dims[:-1], dims[1:])]
    bs = [rng.uniform(-0.1, 0.1, size=(n,)).astype(np.float32) for n in dims[1:]]
    x = (rng.normal(size=(9, dims[0])) * 2).astype(np.float32)
    ref_fq, port_fq = _frozen(quantized, dims)
    got = pops.fxp_dense_chain(torch.from_numpy(x), [torch.from_numpy(w) for w in ws],
                               [torch.from_numpy(b) for b in bs], activations=acts,
                               full_precision=not quantized, site_fn=port_fq.site)
    want = rops.fxp_dense_chain(jnp.asarray(x), tuple(map(jnp.asarray, ws)), tuple(map(jnp.asarray, bs)),
                                activations=acts, full_precision=not quantized, site_fn=ref_fq.site)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("phase", ["act", "train"])
def test_chain_cost_hint_matches_reference(phase):
    dims = [17, 400, 300, 6]
    assert pops.chain_cost_hint(dims, phase) == rops.chain_cost_hint(dims, phase)
    with pytest.raises(ValueError):
        pops.chain_cost_hint(dims, "serve")


def test_kernel_wrapper_never_runs_the_plain_version():
    """The kernel wrapper takes CUDA tensors only: given CPU tensors it
    raises instead of computing anything."""
    x, w, b = (torch.from_numpy(a) for a in _operands(2, 3, 4))
    before = pkernel.fxp_dense_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        pkernel.fxp_dense_cuda(x, w, b, full_precision=True, activation="relu")
    with pytest.raises(ValueError, match="unknown activation"):
        pkernel.fxp_dense_cuda(x, w, b, full_precision=True, activation="gelu")
    assert pkernel.fxp_dense_cuda.launches == before


def test_fxp_dense_rejects_mixed_devices():
    x, w, b = (torch.from_numpy(a) for a in _operands(2, 3, 4))
    with pytest.raises(ValueError, match="different devices"):
        pops.fxp_dense(x, w, b.to("meta"))
