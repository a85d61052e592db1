"""Port parity: `repro_torch.optim.{adam,fxp_adam}` against the JAX
reference, bitwise.

Inputs are made with numpy from a seed and handed to both sides.  Every
update is elementwise float32, so the port must agree bit for bit.  One
exception: the bias corrections 1 − bᵗ of `step_constants` come from each
framework's float32 `pow`, and XLA's and libm's differ by one ulp at some
exponents (the first at t = 31 for b1 = 0.9, t = 168 for b2 = 0.999, but
earlier for other betas).  So `step_constants` at the paper's betas is held
bitwise for t ≤ 30 and, for any betas up to t = 5000, within one ulp of
the power bᵗ or of 1 − bᵗ, and the update tests run fewer than 30 steps.
A global-norm clip is a reduction, summed in another order by each
framework, so updates with it are held at rtol 1e-6 and one Q15.16 quantum.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.optim import adam as radam
from repro.optim import fxp_adam as rfxp_adam

from repro_torch.optim import adam as padam
from repro_torch.optim import fxp_adam as pfxp_adam


def _tree(seed, scale=0.1):
    rng = np.random.default_rng(seed)
    shapes = {"l0": {"w": (5, 7), "b": (7,)}, "l1": {"w": (7, 3), "b": (3,)}}
    return {k: {n: (rng.normal(size=s) * scale).astype(np.float32) for n, s in v.items()} for k, v in shapes.items()}


def _to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _to_torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _assert_tree_equal(got, want, what, **tol):
    for k in want:
        for n in want[k]:
            g, w = got[k][n].numpy(), np.asarray(want[k][n])
            if tol:
                np.testing.assert_allclose(g, w, **tol, err_msg=f"{what} {k}/{n}")
            else:
                np.testing.assert_array_equal(g, w, err_msg=f"{what} {k}/{n}")


def _constants(mod, cfg, step):
    return mod.step_constants(cfg, step)


@pytest.mark.parametrize("b1,b2", [(0.9, 0.999), (0.8, 0.99)])
def test_step_constants_match_reference(b1, b2):
    cfg_r = radam.AdamConfig(lr=3e-4, b1=b1, b2=b2)
    cfg_p = padam.AdamConfig(lr=3e-4, b1=b1, b2=b2)
    t = np.arange(1, 5001, dtype=np.int32)
    want = radam.step_constants(cfg_r, jnp.asarray(t))
    got = padam.step_constants(cfg_p, torch.from_numpy(t))
    for field in ("lr", "b1", "one_minus_b1", "b2", "one_minus_b2", "eps"):
        assert getattr(got, field).dtype == torch.float32
        np.testing.assert_array_equal(getattr(got, field).numpy(), np.asarray(getattr(want, field)), err_msg=field)
    for field in ("bc1", "bc2"):
        g, w = getattr(got, field).numpy(), np.asarray(getattr(want, field))
        if (b1, b2) == (0.9, 0.999):
            np.testing.assert_array_equal(g[:30], w[:30], err_msg=field)
        # one ulp of the power bᵗ = 1 − bc that `pow` returned, or of bc
        ulp = np.maximum(np.spacing(np.float32(1.0) - w), np.spacing(w))
        assert (np.abs(g - w) <= ulp).all(), field


@pytest.mark.parametrize("ste", [True, False])
@pytest.mark.parametrize("fxp", [False, True])
@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_leaf_update_matches_reference(fxp, weight_decay, ste):
    rng = np.random.default_rng(3)
    p, g = (rng.normal(size=(64, 9)) * 0.3).astype(np.float32), (rng.normal(size=(64, 9)) * 0.01).astype(np.float32)
    m, v = (rng.normal(size=(64, 9)) * 1e-3).astype(np.float32), np.abs(rng.normal(size=(64, 9)) * 1e-5).astype(np.float32)
    c_r = radam.step_constants(radam.AdamConfig(), jnp.int32(7))
    c_p = padam.StepConstants(*(torch.from_numpy(np.array(f)) for f in c_r))
    if fxp:
        want = rfxp_adam.leaf_update(*map(jnp.asarray, (p, g, m, v)), c_r, weight_decay=weight_decay, ste=ste)
        got = pfxp_adam.leaf_update(*map(torch.from_numpy, (p, g, m, v)), c_p, weight_decay=weight_decay, ste=ste)
    else:
        want = radam.leaf_update(*map(jnp.asarray, (p, g, m, v)), c_r, weight_decay=weight_decay)
        got = padam.leaf_update(*map(torch.from_numpy, (p, g, m, v)), c_p, weight_decay=weight_decay)
    for a, b, name in zip(got, want, ("p", "m", "v")):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)


@pytest.mark.parametrize(
    "cfg_kw", [{}, {"weight_decay": 0.01}, {"grad_clip_norm": 0.05}, {"lr": 1e-3, "b1": 0.8}],
    ids=["plain", "adamw", "clip", "lr_b1"],
)
@pytest.mark.parametrize("fxp", [False, True])
def test_update_trajectory_matches_reference(fxp, cfg_kw):
    """Ten steps of `update` from the same params and gradients: params,
    moments, step and metrics bitwise (at tolerance under a clip, module
    docstring)."""
    mod_r, mod_p = (rfxp_adam, pfxp_adam) if fxp else (radam, padam)
    cfg_r = (rfxp_adam.FxpAdamConfig if fxp else radam.AdamConfig)(**cfg_kw)
    cfg_p = (pfxp_adam.FxpAdamConfig if fxp else padam.AdamConfig)(**cfg_kw)
    params = _tree(0, scale=0.5)
    p_r, p_p = _to_jax(params), _to_torch(params)
    s_r, s_p = mod_r.init(p_r), mod_p.init(p_p)
    tol = dict(rtol=1e-6, atol=2.0**-16) if "grad_clip_norm" in cfg_kw else {}
    for i in range(10):
        grads = _tree(100 + i, scale=0.02)
        p_r, s_r, m_r = mod_r.update(cfg_r, _to_jax(grads), s_r, p_r)
        p_p, s_p, m_p = mod_p.update(cfg_p, _to_torch(grads), s_p, p_p)
        _assert_tree_equal(p_p, p_r, f"params step {i}", **tol)
        _assert_tree_equal(s_p.mu, s_r.mu, f"mu step {i}", **tol)
        _assert_tree_equal(s_p.nu, s_r.nu, f"nu step {i}", **tol)
        assert int(s_p.step) == int(s_r.step) == i + 1
        assert set(m_p) == set(m_r)
        for k in m_r:
            np.testing.assert_allclose(m_p[k].numpy(), np.asarray(m_r[k]), **(tol or dict(rtol=0, atol=0)), err_msg=k)


def test_moment_quantization_ablation_matches_reference():
    cfg_r = rfxp_adam.FxpAdamConfig(quantize_moments=True)
    cfg_p = pfxp_adam.FxpAdamConfig(quantize_moments=True)
    params, grads = _tree(1), _tree(2, scale=0.05)
    p_r, s_r, _ = rfxp_adam.update(cfg_r, _to_jax(grads), rfxp_adam.init(_to_jax(params)), _to_jax(params))
    p_p, s_p, _ = pfxp_adam.update(cfg_p, _to_torch(grads), pfxp_adam.init(_to_torch(params)), _to_torch(params))
    _assert_tree_equal(p_p, p_r, "params")
    _assert_tree_equal(s_p.mu, s_r.mu, "mu")
    _assert_tree_equal(s_p.nu, s_r.nu, "nu")


def test_global_norm_and_clip_match_reference():
    g = _tree(4)
    np.testing.assert_allclose(float(padam.global_norm(_to_torch(g))), float(radam.global_norm(_to_jax(g))),
                               rtol=1e-6)
    got, n_p = padam.clip_by_global_norm(_to_torch(g), 0.1)
    want, n_r = radam.clip_by_global_norm(_to_jax(g), 0.1)
    np.testing.assert_allclose(float(n_p), float(n_r), rtol=1e-6)
    for k in want:
        for n in want[k]:
            np.testing.assert_allclose(got[k][n].numpy(), np.asarray(want[k][n]), rtol=1e-6, atol=1e-9)


def test_sqrt_rn_is_correctly_rounded():
    """`sqrt_rn` is the IEEE float32 square root (numpy's, and XLA's), bit
    for bit, over 2^20 values spread across the exponent range; `leaf_update`
    and `global_norm` take it because PyTorch's CPU float32 `torch.sqrt` is
    one ulp off on part of these values."""
    from repro_torch.numerics import sqrt_rn

    rng = np.random.default_rng(0)
    x = (rng.uniform(0.5, 2.0, 1 << 20) * np.exp2(rng.integers(-60, 60, 1 << 20))).astype(np.float32)
    x[:4] = [0.0, 1.0, np.inf, np.float32(2.0**-149)]
    got = sqrt_rn(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), np.sqrt(x).view(np.int32))
    np.testing.assert_array_equal(got.view(np.int32), np.sqrt(x.astype(np.float64)).astype(np.float32).view(np.int32))
    # XLA's CPU backend flushes the subnormal input to zero; elsewhere it agrees
    np.testing.assert_array_equal(got[4:], np.asarray(jnp.sqrt(jnp.asarray(x[4:]))))
