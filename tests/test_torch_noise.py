"""Port parity: `repro_torch.rl.noise` against the JAX reference.  Both
sides take the same standard-normal draws (the reference's, from its key),
so Gaussian and Ornstein-Uhlenbeck noise agree bitwise step by step."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401  (one intra-op thread a worker)

import jax

from repro.rl import noise as rnoise

from repro_torch.rl import noise as pnoise


@pytest.mark.parametrize("kind", ["gaussian", "ou", "none"])
def test_process_matches_reference_on_the_same_draws(kind):
    proc_r = rnoise.NoiseProcess(kind=kind, sigma=0.2, theta=0.3, dt=0.05)
    proc_p = pnoise.NoiseProcess(kind=kind, sigma=0.2, theta=0.3, dt=0.05)
    s_r, s_p = proc_r.init((4, 3)), proc_p.init((4, 3), device="cpu")
    key = jax.random.key(0)
    for i in range(6):
        k = jax.random.fold_in(key, i)
        s_r, eps_r = proc_r.sample(s_r, k)
        normal = torch.from_numpy(np.array(jax.random.normal(k, (4, 3))))
        s_p, eps_p = proc_p.advance(s_p, normal)
        np.testing.assert_array_equal(eps_p.numpy(), np.asarray(eps_r), err_msg=f"step {i}")
        np.testing.assert_array_equal(s_p.x.numpy(), np.asarray(s_r.x), err_msg=f"state {i}")


def test_sample_draws_from_the_generator():
    proc = pnoise.NoiseProcess(kind="ou", sigma=0.3)
    s0 = proc.init((2, 5), device="cpu")
    s1, eps1 = proc.sample(s0, torch.Generator().manual_seed(4))
    s2, eps2 = proc.sample(s0, torch.Generator().manual_seed(4))
    assert torch.equal(eps1, eps2) and torch.equal(s1.x, eps1) and eps1.abs().max() > 0
    _, none = pnoise.NoiseProcess(kind="none").sample(s0, torch.Generator())
    assert torch.equal(none, torch.zeros(2, 5))
    with pytest.raises(ValueError, match="unknown noise kind"):
        pnoise.NoiseProcess(kind="pink")


def test_deprecated_shims_match_reference_on_the_same_draws():
    """`ou_init`, `ou_step`, `gaussian` and the `OUState` alias: each warns
    like the reference's and steps as `NoiseProcess` does, bitwise on the
    reference's standard-normal draws."""
    with pytest.warns(DeprecationWarning, match="ou_init"):
        s_p = pnoise.ou_init((4, 3), device="cpu")
    with pytest.warns(DeprecationWarning, match="ou_init"):
        s_r = rnoise.ou_init((4, 3))
    assert pnoise.OUState is pnoise.NoiseState and isinstance(s_p, pnoise.OUState)
    assert np.array_equal(s_p.x.numpy(), np.asarray(s_r.x))
    key = jax.random.key(3)
    for i in range(4):
        k = jax.random.fold_in(key, i)
        with pytest.warns(DeprecationWarning, match="ou_step"):
            s_r, eps_r = rnoise.ou_step(s_r, k, theta=0.3, sigma=0.4, dt=0.05)
        normal = torch.from_numpy(np.array(jax.random.normal(k, (4, 3))))
        s_p, eps_p = pnoise.NoiseProcess(kind="ou", sigma=0.4, theta=0.3, dt=0.05).advance(s_p, normal)
        np.testing.assert_array_equal(eps_p.numpy(), np.asarray(eps_r))
    gen = torch.Generator().manual_seed(9)
    with pytest.warns(DeprecationWarning, match="ou_step"):
        s1, e1 = pnoise.ou_step(pnoise.NoiseState(torch.zeros(2, 3)), gen, sigma=0.4)
    s2, e2 = pnoise.NoiseProcess(kind="ou", sigma=0.4).sample(pnoise.NoiseState(torch.zeros(2, 3)),
                                                              torch.Generator().manual_seed(9))
    assert torch.equal(e1, e2) and torch.equal(s1.x, s2.x)
    with pytest.warns(DeprecationWarning, match="gaussian"):
        g = pnoise.gaussian(torch.Generator().manual_seed(2), (5,), sigma=0.3)
    _, want = pnoise.NoiseProcess(kind="gaussian", sigma=0.3).sample(
        pnoise.NoiseState(torch.zeros(5)), torch.Generator().manual_seed(2))
    assert torch.equal(g, want)
    for name in ("ou_init", "ou_step", "gaussian", "OUState"):
        assert name in pnoise.__all__
