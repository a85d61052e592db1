"""Port parity: repro_torch.kernels.fxp_mlp (the fused MLP forward) against
the JAX reference.

On the CPU the port's `fxp_mlp_forward` takes its plain version, which is
held against the reference's fused Pallas kernel (interpret mode) and its
per-layer oracle `ref_fxp_mlp`: y and the per-site mins/maxs at the
reference's contract, rtol = atol = 2e-5.  At the full 17-400-300-6 width
the quant phase is held against `ref_fxp_mlp` at 1e-3 (the reference's
quant-phase contract), not against the Pallas output, whose own
`test_fused_matches_oracle[True-actor_halfcheetah]` fails under jax 0.9.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401  (one intra-op thread a worker)

import jax.numpy as jnp

from repro.core import fixedpoint as rfxp
from repro.kernels.fxp_mlp import ops as rops
from repro.kernels.fxp_mlp import ref as rref

from repro_torch.kernels.fxp_mlp import kernel as pkernel
from repro_torch.kernels.fxp_mlp import ops as pops
from repro_torch.kernels.fxp_mlp import ref as pref

TOL = dict(rtol=2e-5, atol=2e-5)
NARROW = [
    ("narrow", (5, 32, 24, 3), ("relu", "relu", "tanh")),
    ("tiny_ragged", (5, 33, 7), ("relu", "tanh")),
]
ACTOR = ("actor_halfcheetah", (17, 400, 300, 6), ("relu", "relu", "tanh"))
CASES = ["off", "monitor", "quant"]


def _net(dims, seed=0):
    rng = np.random.default_rng(seed)
    ws = [rng.uniform(-0.2, 0.2, size=(k, n)).astype(np.float32) for k, n in zip(dims[:-1], dims[1:])]
    bs = [rng.uniform(-0.2, 0.2, size=(n,)).astype(np.float32) for n in dims[1:]]
    return ws, bs


def _site_params(n_layers, n_bits=16):
    """Captured ranges + the affine operands, made by the reference."""
    a_mins = np.linspace(-1.0, -3.0, n_layers).astype(np.float32)
    a_maxs = np.linspace(1.5, 3.5, n_layers).astype(np.float32)
    ds, zs = [], []
    for i in range(n_layers):
        d, z = rfxp.affine_params(jnp.float32(a_mins[i]), jnp.float32(a_maxs[i]), n_bits)
        ds.append(float(d))
        zs.append(float(z))
    return a_mins, a_maxs, np.array(ds, np.float32), np.array(zs, np.float32)


def _port(x, ws, bs, deltas, zs, case, acts):
    qat = case != "off"
    return pops.fxp_mlp_forward(
        torch.from_numpy(x), [torch.from_numpy(w) for w in ws], [torch.from_numpy(b) for b in bs],
        torch.from_numpy(deltas) if qat else None, torch.from_numpy(zs) if qat else None,
        activations=acts, quant_phase=case == "quant", qat=qat,
    )


def _check(got, want, tol, names=("y", "mins", "maxs")):
    for g, w, name in zip(got, want, names):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **tol, err_msg=name)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("batch", [1, 13])
@pytest.mark.parametrize("net", NARROW, ids=[n[0] for n in NARROW])
def test_forward_matches_reference_pallas(net, batch, case):
    _, dims, acts = net
    ws, bs = _net(dims)
    x = (np.random.default_rng(batch).normal(size=(batch, dims[0])) * 2).astype(np.float32)
    _, _, deltas, zs = _site_params(len(ws))
    got = _port(x, ws, bs, deltas, zs, case, acts)
    qat = case != "off"
    want = rops.fxp_mlp_forward(
        jnp.asarray(x), tuple(map(jnp.asarray, ws)), tuple(map(jnp.asarray, bs)),
        jnp.asarray(deltas) if qat else None, jnp.asarray(zs) if qat else None,
        activations=acts, quant_phase=jnp.array(case == "quant"), qat=qat)
    _check(got, want, TOL)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("net", NARROW + [ACTOR], ids=[n[0] for n in NARROW + [ACTOR]])
def test_forward_matches_reference_oracle(net, case):
    _, dims, acts = net
    ws, bs = _net(dims, seed=3)
    x = (np.random.default_rng(7).normal(size=(64, dims[0])) * 3).astype(np.float32)
    a_mins, a_maxs, deltas, zs = _site_params(len(ws))
    got = _port(x, ws, bs, deltas, zs, case, acts)
    want = rref.ref_fxp_mlp(
        jnp.asarray(x), tuple(map(jnp.asarray, ws)), tuple(map(jnp.asarray, bs)), activations=acts,
        quant_phase=jnp.array(case == "quant"), a_mins=jnp.asarray(a_mins), a_maxs=jnp.asarray(a_maxs),
        qat=case != "off")
    tol = dict(rtol=1e-3, atol=1e-3) if case == "quant" and dims == ACTOR[1] else TOL
    _check(got, want, tol)


@pytest.mark.parametrize("case", ["off", "monitor"])
@pytest.mark.parametrize("batch", [8, 64])
def test_actor_width_matches_reference_pallas(batch, case):
    _, dims, acts = ACTOR
    ws, bs = _net(dims, seed=5)
    x = (np.random.default_rng(batch).normal(size=(batch, dims[0])) * 2).astype(np.float32)
    _, _, deltas, zs = _site_params(len(ws))
    got = _port(x, ws, bs, deltas, zs, case, acts)
    qat = case != "off"
    want = rops.fxp_mlp_forward(
        jnp.asarray(x), tuple(map(jnp.asarray, ws)), tuple(map(jnp.asarray, bs)),
        jnp.asarray(deltas) if qat else None, jnp.asarray(zs) if qat else None,
        activations=acts, quant_phase=jnp.array(False), qat=qat)
    _check(got, want, TOL)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("net", NARROW + [ACTOR], ids=[n[0] for n in NARROW + [ACTOR]])
def test_ported_oracle_matches_reference_oracle(net, case):
    _, dims, acts = net
    ws, bs = _net(dims, seed=9)
    x = (np.random.default_rng(11).normal(size=(16, dims[0])) * 2).astype(np.float32)
    a_mins, a_maxs, _, _ = _site_params(len(ws))
    got = pref.ref_fxp_mlp(
        torch.from_numpy(x), [torch.from_numpy(w) for w in ws], [torch.from_numpy(b) for b in bs],
        activations=acts, quant_phase=case == "quant", a_mins=torch.from_numpy(a_mins),
        a_maxs=torch.from_numpy(a_maxs), qat=case != "off")
    want = rref.ref_fxp_mlp(
        jnp.asarray(x), tuple(map(jnp.asarray, ws)), tuple(map(jnp.asarray, bs)), activations=acts,
        quant_phase=jnp.array(case == "quant"), a_mins=jnp.asarray(a_mins), a_maxs=jnp.asarray(a_maxs),
        qat=case != "off")
    _check(got, want, TOL)


def test_ragged_batch_padding_never_reaches_the_ranges():
    """All-positive inputs keep a positive layer-0 minimum: no padded row or
    column (zeros) reaches the monitor, on either side."""
    dims, acts = (5, 33, 7), ("relu", "tanh")
    ws, bs = _net(dims, seed=9)
    x = (np.abs(np.random.default_rng(1).normal(size=(7, 5))) + 0.5).astype(np.float32)
    _, _, deltas, zs = _site_params(2)
    got = _port(x, ws, bs, deltas, zs, "monitor", acts)
    want = rops.fxp_mlp_forward(jnp.asarray(x), tuple(map(jnp.asarray, ws)), tuple(map(jnp.asarray, bs)),
                                jnp.asarray(deltas), jnp.asarray(zs), activations=acts,
                                quant_phase=jnp.array(False))
    assert float(got[1][0]) >= 0.5
    assert float(got[1][0]) == float(x.min()) and float(got[2][0]) == float(x.max())
    _check(got, want, TOL)


def test_infer_drops_the_monitors():
    dims, acts = (5, 32, 24, 3), ("relu", "relu", "tanh")
    ws, bs = _net(dims)
    x = torch.from_numpy((np.random.default_rng(2).normal(size=(6, 5))).astype(np.float32))
    _, _, deltas, zs = _site_params(3)
    tw = [torch.from_numpy(w).requires_grad_(True) for w in ws]
    tb = [torch.from_numpy(b) for b in bs]
    y = pops.fxp_mlp_infer(x, tw, tb, torch.from_numpy(deltas), torch.from_numpy(zs),
                           activations=acts, quant_phase=True)
    y_fwd, _, _ = pops.fxp_mlp_forward(x, tw, tb, torch.from_numpy(deltas), torch.from_numpy(zs),
                                       activations=acts, quant_phase=True)
    assert isinstance(y, torch.Tensor) and not y.requires_grad
    np.testing.assert_array_equal(y.numpy(), y_fwd.detach().numpy())
    y_off = pops.fxp_mlp_infer(x, tw, tb, activations=acts, quant_phase=False)
    y_off_fwd, _, _ = pops.fxp_mlp_forward(x, tw, tb, activations=acts, quant_phase=False, qat=False)
    np.testing.assert_array_equal(y_off.numpy(), y_off_fwd.detach().numpy())


def test_qat_without_site_operands_raises():
    ws, bs = _net((5, 33, 7))
    with pytest.raises(ValueError, match="requires both deltas and zs"):
        pops.fxp_mlp_forward(torch.zeros(2, 5), [torch.from_numpy(w) for w in ws],
                             [torch.from_numpy(b) for b in bs], activations=("relu", "tanh"),
                             quant_phase=False)


@pytest.mark.parametrize("phase", ["act", "train"])
def test_fused_cost_hint_matches_reference(phase):
    dims = [17, 400, 300, 6]
    assert pops.fused_cost_hint(dims, phase) == rops.fused_cost_hint(dims, phase)
    assert pref.ref_mlp_flops(8, dims, True) == rref.ref_mlp_flops(8, dims, True)


def test_kernel_wrapper_never_runs_the_plain_version():
    ws, bs = _net((5, 33, 7))
    before = pkernel.fxp_mlp_fwd_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        pkernel.fxp_mlp_fwd_cuda(torch.zeros(2, 5), [torch.from_numpy(w) for w in ws],
                                 [torch.from_numpy(b) for b in bs], None, None,
                                 activations=("relu", "tanh"), quant=False, qat=False, n_bits=16,
                                 fxp32_phase1=True)
    assert pkernel.fxp_mlp_fwd_cuda.launches == before
    # the launch plan: one row for a single row, else blocks of 8; one monitor
    # row per cluster of the grid
    plans = [pkernel.mlp_plan(m, (5, 33, 7)) for m in (1, 2, 8, 512)]
    assert [p.bm for p in plans] == [1, 8, 8, 8]
    assert [pkernel.monitor_rows(m, (5, 33, 7)) for m in (1, 2, 8, 512)] == [p.n_clusters for p in plans]
