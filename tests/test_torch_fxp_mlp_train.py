"""Port parity: `repro_torch.kernels.fxp_mlp.ops.fxp_mlp_train` (kernel B
with residuals forward, kernel 3 backward) against the JAX reference.

On the CPU both halves are the plain versions (`ref_mlp_forward`,
`ref_mlp_backward`); the reference runs its Pallas kernels in interpret
mode.  Inputs are made with numpy from a seed and handed to both sides.

Tolerances, from the reference's own tests: y at the fused forward's
2e-5 (`tests/kernels/test_fxp_mlp.py:92`), 1e-3 in the quant phase (one
ulp at a site input can flip a 16-bit code); gradients at
rtol 2e-4 / atol 2e-5 before the quant phase and 5e-3 / 2e-2 in it
(`tests/kernels/test_fxp_mlp_grad.py:91`).  At the actor's full width the
quant phase is held against the reference's oracle `ref_fxp_mlp` under
`jax.grad`, not against its Pallas kernels, whose forward fails its own
test there under jax 0.9 (`test_fused_matches_oracle[True-actor_halfcheetah]`).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.core import fixedpoint as rfxp
from repro.kernels.fxp_mlp import kernel as rkernel
from repro.kernels.fxp_mlp import ops as rops
from repro.kernels.fxp_mlp import ref as rref

from repro_torch.kernels.fxp_mlp import ops as pops
from repro_torch.kernels.fxp_mlp import ref as pref

NETS = [
    ("narrow", (5, 32, 24, 3), ("relu", "relu", "tanh")),
    ("tiny_ragged", (5, 33, 7), ("relu", "tanh")),
    ("critic_like", (9, 40, 1), ("relu", "none")),
]
ACTOR = ("actor_halfcheetah", (17, 400, 300, 6), ("relu", "relu", "tanh"))
CASES = ["off", "monitor", "quant"]
Y_TOL = {"off": dict(rtol=2e-5, atol=2e-5), "monitor": dict(rtol=2e-5, atol=2e-5), "quant": dict(rtol=1e-3, atol=1e-3)}
G_TOL = {"off": dict(rtol=2e-4, atol=2e-5), "monitor": dict(rtol=2e-4, atol=2e-5), "quant": dict(rtol=5e-3, atol=2e-2)}


def _net(dims, seed=0):
    rng = np.random.default_rng(seed)
    ws = [rng.uniform(-0.2, 0.2, size=(k, n)).astype(np.float32) for k, n in zip(dims[:-1], dims[1:])]
    bs = [rng.uniform(-0.2, 0.2, size=(n,)).astype(np.float32) for n in dims[1:]]
    return ws, bs


def _site_params(n_layers, n_bits=16):
    a_mins = np.linspace(-1.0, -3.0, n_layers).astype(np.float32)
    a_maxs = np.linspace(1.5, 3.5, n_layers).astype(np.float32)
    ds, zs = zip(*(rfxp.affine_params(jnp.float32(a_mins[i]), jnp.float32(a_maxs[i]), n_bits)
                   for i in range(n_layers)))
    return a_mins, a_maxs, np.array(ds, np.float32), np.array(zs, np.float32)


def _port_grads(x, ws, bs, deltas, zs, c, case, acts):
    qat = case != "off"
    tx = torch.from_numpy(x).requires_grad_(True)
    tw = [torch.from_numpy(w).requires_grad_(True) for w in ws]
    tb = [torch.from_numpy(b).requires_grad_(True) for b in bs]
    y, mins, maxs = pops.fxp_mlp_train(
        tx, tw, tb, torch.from_numpy(deltas) if qat else None, torch.from_numpy(zs) if qat else None,
        activations=acts, quant_phase=case == "quant", qat=qat)
    assert not mins.requires_grad and not maxs.requires_grad
    (y * torch.from_numpy(c)).sum().backward()
    return y.detach().numpy(), [tx.grad.numpy()] + [t.grad.numpy() for t in tw] + [t.grad.numpy() for t in tb]


def _check(got_y, got_g, want_y, want_g, case):
    np.testing.assert_allclose(got_y, np.asarray(want_y), **Y_TOL[case], err_msg="y")
    for i, (g, w) in enumerate(zip(got_g, want_g)):
        np.testing.assert_allclose(g, np.asarray(w), **G_TOL[case], err_msg=f"grad {i}")


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("batch", [1, 13])
@pytest.mark.parametrize("net", NETS, ids=[n[0] for n in NETS])
def test_train_matches_reference_vjp(net, batch, case):
    """y and d(sum(y·c))/d(x, W, b) against the reference's custom VJP."""
    _, dims, acts = net
    ws, bs = _net(dims)
    rng = np.random.default_rng(batch)
    x = (rng.normal(size=(batch, dims[0])) * 2).astype(np.float32)
    c = rng.normal(size=(batch, dims[-1])).astype(np.float32)
    _, _, deltas, zs = _site_params(len(ws))
    qat = case != "off"
    got_y, got_g = _port_grads(x, ws, bs, deltas, zs, c, case, acts)

    def loss(x, ws, bs):
        y, _, _ = rops.fxp_mlp_train(x, ws, bs, jnp.asarray(deltas) if qat else None,
                                     jnp.asarray(zs) if qat else None, activations=acts,
                                     quant_phase=jnp.array(case == "quant"), qat=qat)
        return jnp.sum(y * c), y

    (_, want_y), (gx, gw, gb) = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(x), tuple(map(jnp.asarray, ws)), tuple(map(jnp.asarray, bs)))
    _check(got_y, got_g, want_y, [gx, *gw, *gb], case)


@pytest.mark.parametrize("case", CASES)
def test_train_at_actor_width_matches_reference(case):
    """Full width, B = 8: the reference's VJP before the quant phase, its
    oracle under `jax.grad` in it (module docstring)."""
    _, dims, acts = ACTOR
    ws, bs = _net(dims, seed=4)
    rng = np.random.default_rng(8)
    x = (rng.normal(size=(8, dims[0])) * 2).astype(np.float32)
    c = rng.normal(size=(8, dims[-1])).astype(np.float32)
    a_mins, a_maxs, deltas, zs = _site_params(len(ws))
    qat = case != "off"
    got_y, got_g = _port_grads(x, ws, bs, deltas, zs, c, case, acts)

    def loss(x, ws, bs):
        if case == "quant":
            y, _, _ = rref.ref_fxp_mlp(x, ws, bs, activations=acts, quant_phase=jnp.array(True),
                                       a_mins=jnp.asarray(a_mins), a_maxs=jnp.asarray(a_maxs))
        else:
            y, _, _ = rops.fxp_mlp_train(x, ws, bs, jnp.asarray(deltas) if qat else None,
                                         jnp.asarray(zs) if qat else None, activations=acts,
                                         quant_phase=jnp.array(False), qat=qat)
        return jnp.sum(y * c), y

    (_, want_y), (gx, gw, gb) = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(x), tuple(map(jnp.asarray, ws)), tuple(map(jnp.asarray, bs)))
    _check(got_y, got_g, want_y, [gx, *gw, *gb], case)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("net", NETS, ids=[n[0] for n in NETS])
def test_residuals_match_reference_pallas(net, case):
    """`ref_mlp_forward(save_residuals=True)` against the reference kernel's
    residual outputs, unpadded: qs[l] and hs[l] (hs[L-1] = y)."""
    _, dims, acts = net
    ws, bs = _net(dims, seed=2)
    x = (np.random.default_rng(5).normal(size=(11, dims[0])) * 2).astype(np.float32)
    _, _, deltas, zs = _site_params(len(ws))
    qat, quant = case != "off", case == "quant"
    y, mins, maxs, qs, hs = pref.ref_mlp_forward(
        torch.from_numpy(x), [torch.from_numpy(w) for w in ws], [torch.from_numpy(b) for b in bs],
        torch.from_numpy(deltas), torch.from_numpy(zs), activations=acts, quant=quant, qat=qat,
        save_residuals=True)
    x2, wp, bp, m, bm = rops._pad_net(jnp.asarray(x), tuple(map(jnp.asarray, ws)), tuple(map(jnp.asarray, bs)))
    d, z = rops._norm_quant_params(jnp.asarray(deltas), jnp.asarray(zs), len(ws), qat)
    outs = rkernel.fxp_mlp_pallas(
        jnp.array([int(quant)], jnp.int32), x2, wp, bp, d, z, activations=acts, in_dims=dims[:-1], m_valid=m,
        bm=bm, n_bits=16, qat=qat, fxp32_phase1=True, interpret=True, save_residuals=True)
    n = len(ws)
    want_qs = [np.asarray(q)[:m, :k] for q, k in zip(outs[3:3 + n], dims[:-1])]
    want_hs = [np.asarray(h)[:m, :k] for h, k in zip(outs[3 + n:], dims[1:-1])] + [np.asarray(outs[0])[:m, :dims[-1]]]
    assert len(qs) == len(hs) == n and hs[-1] is y
    np.testing.assert_array_equal(qs[0].numpy(), want_qs[0])
    for got, want in zip(qs[1:] + hs, want_qs[1:] + want_hs):
        np.testing.assert_allclose(got.numpy(), want, **Y_TOL[case])


def test_site_clip_gradient_is_zero_outside_range():
    """STE clip mask (reference `test_fxp_mlp_grad.py:136`): no cotangent
    where the quantizer saturates, and the same dx as the reference."""
    dims, acts = (8, 16), ("none",)
    ws, bs = _net(dims, seed=5)
    d, z = rfxp.affine_params(jnp.float32(-1.0), jnp.float32(1.0), 16)
    deltas, zs = np.array([d], np.float32), np.array([z], np.float32)
    x = np.concatenate([np.full((4, 8), 7.0), np.zeros((4, 8))]).astype(np.float32)
    tx = torch.from_numpy(x).requires_grad_(True)
    y, _, _ = pops.fxp_mlp_train(tx, [torch.from_numpy(ws[0])], [torch.from_numpy(bs[0])], torch.from_numpy(deltas),
                                 torch.from_numpy(zs), activations=acts, quant_phase=True)
    y.sum().backward()
    gx = tx.grad.numpy()
    assert float(np.abs(gx[:4]).max()) == 0.0, "saturated rows must not flow"
    assert float(np.abs(gx[4:]).max()) > 0.0, "in-range rows must flow"
    want = jax.grad(lambda x: jnp.sum(rops.fxp_mlp_train(
        x, (jnp.asarray(ws[0]),), (jnp.asarray(bs[0]),), jnp.asarray(deltas), jnp.asarray(zs), activations=acts,
        quant_phase=jnp.array(True))[0]))(jnp.asarray(x))
    np.testing.assert_allclose(gx, np.asarray(want), **G_TOL["quant"])


def test_without_grad_it_is_the_plain_forward():
    """No input needing a gradient (or `torch.no_grad`): the plain fused
    forward, bitwise, with nothing attached to autograd."""
    dims, acts = (5, 32, 24, 3), ("relu", "relu", "tanh")
    ws, bs = _net(dims)
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(6, 5)).astype(np.float32))
    _, _, deltas, zs = _site_params(3)
    args = (x, [torch.from_numpy(w) for w in ws], [torch.from_numpy(b) for b in bs], torch.from_numpy(deltas),
            torch.from_numpy(zs))
    kw = dict(activations=acts, quant_phase=True)
    want = pops.fxp_mlp_forward(*args, **kw)
    for got in (pops.fxp_mlp_train(*args, **kw),):
        for g, w in zip(got, want):
            assert torch.equal(g, w) and not g.requires_grad
    tw = [w.clone().requires_grad_(True) for w in args[1]]
    with torch.no_grad():
        y, _, _ = pops.fxp_mlp_train(x, tw, args[2], args[3], args[4], **kw)
    assert torch.equal(y, want[0]) and y.grad_fn is None
