"""Port parity: `repro_torch.optim.schedule` against the JAX reference.

`constant` and `linear_warmup` are a min and an IEEE quotient of float32
values: bitwise.  `warmup_cosine` goes through float32 `cos`, and XLA's and
PyTorch's CPU `cos` differ by an ulp at some arguments, so it is held at
rtol 1e-6 (a few ulps).  `warmup_rsqrt` takes two square roots, correctly
rounded in both (`repro_torch.numerics.sqrt_rn`), and one quotient; it is
held at the same rtol 1e-6.  A ten-step Adam trajectory under
`warmup_cosine` is bitwise: at these steps the two `cos` agree, and the
test says so if that ever changes.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401  (one intra-op thread a worker)

import jax.numpy as jnp

from repro.optim import adam as radam
from repro.optim import schedule as rs

from repro_torch.optim import adam as padam
from repro_torch.optim import schedule as ps

STEPS = np.arange(0, 2501, dtype=np.int32)
CASES = [
    ("constant", (), True),
    ("linear_warmup", (100,), True),
    ("linear_warmup", (0,), True),
    ("linear_warmup", (7,), True),
    ("warmup_cosine", (100, 2000), False),
    ("warmup_cosine", (7, 50, 0.3), False),
    ("warmup_cosine", (0, 1), False),
    ("warmup_rsqrt", (100,), False),
    ("warmup_rsqrt", (1,), False),
]


@pytest.mark.parametrize("name,args,bitwise", CASES, ids=[f"{c[0]}{c[1]}" for c in CASES])
def test_schedule_matches_reference(name, args, bitwise):
    got = getattr(ps, name)(*args)(torch.from_numpy(STEPS))
    want = np.broadcast_to(np.asarray(getattr(rs, name)(*args)(jnp.asarray(STEPS))), STEPS.shape)
    got = np.broadcast_to(got.numpy(), STEPS.shape)
    assert got.dtype == np.float32
    if bitwise:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("name,args", [(c[0], c[1]) for c in CASES], ids=[f"{c[0]}{c[1]}" for c in CASES])
def test_schedule_is_a_float32_scalar_on_the_steps_device(name, args):
    out = getattr(ps, name)(*args)(torch.tensor(37, dtype=torch.int32))
    assert out.dtype == torch.float32 and out.shape == () and out.device.type == "cpu"
    want = np.asarray(getattr(rs, name)(*args)(jnp.int32(37)))
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-6)


def _tree(seed, scale):
    rng = np.random.default_rng(seed)
    shapes = {"l0": {"w": (5, 7), "b": (7,)}, "l1": {"w": (7, 3), "b": (3,)}}
    return {k: {n: (rng.normal(size=s) * scale).astype(np.float32) for n, s in v.items()} for k, v in shapes.items()}


@pytest.mark.parametrize("total", [10, 40])
def test_adam_trajectory_under_warmup_cosine(total):
    """Ten Adam steps with `schedule=warmup_cosine(3, total)`: lr, params
    and moments bitwise."""
    cfg_r = radam.AdamConfig(lr=1e-3, schedule=rs.warmup_cosine(3, total))
    cfg_p = padam.AdamConfig(lr=1e-3, schedule=ps.warmup_cosine(3, total))
    params = _tree(0, 0.5)
    p_r = {k: {n: jnp.asarray(a) for n, a in v.items()} for k, v in params.items()}
    p_p = {k: {n: torch.from_numpy(a.copy()) for n, a in v.items()} for k, v in params.items()}
    s_r, s_p = radam.init(p_r), padam.init(p_p)
    for i in range(10):
        grads = _tree(100 + i, 0.02)
        p_r, s_r, m_r = radam.update(cfg_r, {k: {n: jnp.asarray(a) for n, a in v.items()} for k, v in grads.items()},
                                     s_r, p_r)
        p_p, s_p, m_p = padam.update(cfg_p, {k: {n: torch.from_numpy(a) for n, a in v.items()} for k, v in grads.items()},
                                     s_p, p_p)
        np.testing.assert_array_equal(m_p["lr"].numpy(), np.asarray(m_r["lr"]), err_msg=f"lr step {i}")
        for k in params:
            for n in params[k]:
                for got, want, what in ((p_p, p_r, "params"), (s_p.mu, s_r.mu, "mu"), (s_p.nu, s_r.nu, "nu")):
                    np.testing.assert_array_equal(got[k][n].numpy(), np.asarray(want[k][n]),
                                                  err_msg=f"{what} {k}/{n} step {i}")


def test_optim_package_reexports_the_reference_names():
    import repro.optim as roptim

    import repro_torch.optim as poptim

    for name in ("adam", "fxp_adam", "schedule", "AdamConfig", "AdamState", "clip_by_global_norm", "global_norm",
                 "FxpAdamConfig"):
        assert hasattr(roptim, name) and hasattr(poptim, name), name
