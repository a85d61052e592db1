"""Port parity: `repro_torch.rl.envs` against the JAX reference's envs.

The port writes the fleet out as a leading batch axis; the reference
vmaps single-env functions.  Both step from the same states and actions
(numpy, from a seed).  The dynamics are elementwise float32 apart from
sums over at most 6 joints, which each framework may add in another order,
so states, observations and rewards are held at rtol 1e-6 / atol 1e-6;
`done` and the step counters exactly.  Random draws (initial states,
resets, observation noise) come from a `torch.Generator` in the port and a
JAX key in the reference, so they are checked for their structure, not
their values.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401  (one intra-op thread a worker)

import jax
import jax.numpy as jnp

from repro.rl.envs import base as rbase
from repro.rl.envs import locomotion as rloco

from repro_torch.rl import envs as penvs
from repro_torch.rl.envs import base as pbase

TOL = dict(rtol=1e-6, atol=1e-6)
NAMES = ["halfcheetah", "hopper", "swimmer", "pendulum"]
DIMS = {"halfcheetah": (17, 6), "hopper": (11, 3), "swimmer": (8, 2), "pendulum": (3, 1)}
N = 6


def _states(name, seed, t=None):
    """The same fleet state for both sides, plus actions."""
    env_r = rloco.make(name)
    rng = np.random.default_rng(seed)
    dof = 1 if name == "pendulum" else env_r.n_joints + env_r.n_aux
    q = (rng.normal(size=(N, dof)) * (2.0 if name == "pendulum" else 0.5)).astype(np.float32)
    qd = (rng.normal(size=(N, dof)) * 0.5).astype(np.float32)
    tt = np.asarray(t if t is not None else rng.integers(0, 5, size=N), np.int32)
    act = rng.uniform(-1.5, 1.5, size=(N, env_r.spec.act_dim)).astype(np.float32)
    keys = jax.random.split(jax.random.key(seed), N)
    s_r = rbase.EnvState(q=jnp.asarray(q), qd=jnp.asarray(qd), t=jnp.asarray(tt), key=keys)
    s_p = pbase.EnvState(q=torch.from_numpy(q), qd=torch.from_numpy(qd), t=torch.from_numpy(tt))
    return env_r, penvs.make(name), s_r, s_p, act


@pytest.mark.parametrize("name", NAMES)
def test_step_matches_reference(name):
    env_r, env_p, s_r, s_p, act = _states(name, seed=NAMES.index(name))
    for _ in range(3):
        s_r, obs_r, rew_r, done_r = jax.vmap(env_r.step)(s_r, jnp.asarray(act))
        s_p, obs_p, rew_p, done_p = env_p.step(s_p, torch.from_numpy(act))
        for got, want, what in ((s_p.q, s_r.q, "q"), (s_p.qd, s_r.qd, "qd"), (obs_p, obs_r, "obs"),
                                (rew_p, rew_r, "reward")):
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL, err_msg=what)
        np.testing.assert_array_equal(done_p.numpy(), np.asarray(done_r))
        np.testing.assert_array_equal(s_p.t.numpy(), np.asarray(s_r.t))


def test_hopper_falls_like_the_reference():
    """Termination on fall: a height below −0.7 ends the episode."""
    env_r, env_p, s_r, s_p, act = _states("hopper", seed=9)
    s_r.q = s_r.q.at[:3, 1].set(-2.0)
    s_p.q[:3, 1] = -2.0
    _, _, _, done_r = jax.vmap(env_r.step)(s_r, jnp.asarray(act))
    _, _, _, done_p = env_p.step(s_p, torch.from_numpy(act))
    assert done_p[:3].all()
    np.testing.assert_array_equal(done_p.numpy(), np.asarray(done_r))


@pytest.mark.parametrize("name", NAMES)
def test_step_auto_resets_only_done_lanes(name):
    """Lanes at the horizon come back as fresh episodes (t = 0); the others
    are the plain step; reward/done describe the step that happened."""
    env_r, env_p, s_r, s_p, act = _states(name, seed=20)
    horizon = env_p.spec.episode_length
    t = np.array([horizon - 1, 0, horizon - 1, 3, 1, horizon - 1], np.int32)
    s_p.t = torch.from_numpy(t)
    gen = torch.Generator().manual_seed(0)
    plain = env_p.step(s_p, torch.from_numpy(act))
    s2, obs2, rew2, done2 = pbase.step_auto(env_p, s_p, torch.from_numpy(act), gen)
    want_done = plain[3].numpy()
    assert want_done[t + 1 >= horizon].all()  # the horizon, and Hopper's falls
    np.testing.assert_array_equal(done2.numpy(), want_done)
    assert torch.equal(rew2, plain[2])
    keep = torch.from_numpy(~want_done)
    assert torch.equal(s2.q[keep], plain[0].q[keep]) and torch.equal(obs2[keep], plain[1][keep])
    assert (s2.t[~keep] == 0).all() and torch.equal(s2.t[keep], plain[0].t[keep])
    assert not torch.equal(s2.q[~keep], plain[0].q[~keep])
    # the reference selects the same lanes
    _, _, _, done_r = jax.vmap(lambda s, a: rbase.step_auto(env_r, s, a))(
        rbase.EnvState(q=s_r.q, qd=s_r.qd, t=jnp.asarray(t), key=s_r.key), jnp.asarray(act))
    np.testing.assert_array_equal(np.asarray(done_r), want_done)


@pytest.mark.parametrize("name", NAMES)
def test_init_and_dims_match_reference(name):
    env_r, env_p = rloco.make(name), penvs.make(name)
    assert env_p.spec == type(env_p.spec)(**{f: getattr(env_r.spec, f) for f in ("name", "obs_dim", "act_dim",
                                                                                    "episode_length")})
    assert (env_p.spec.obs_dim, env_p.spec.act_dim) == DIMS[name]
    s_r, obs_r = rbase.init_fleet(env_r, jax.random.key(0), N)
    s_p, obs_p = pbase.init_fleet(env_p, torch.Generator().manual_seed(0), N, device="cpu")
    assert tuple(obs_p.shape) == obs_r.shape and tuple(s_p.q.shape) == s_r.q.shape
    assert obs_p.dtype == torch.float32 and (s_p.t == 0).all()
    # the same distributions: positions within a few sigma of the reference's scale
    assert float(s_p.q.abs().max()) < (np.pi + 1e-6 if name == "pendulum" else 1.0)
    s_again, _ = pbase.env_init(env_p, torch.Generator().manual_seed(0), N)
    assert torch.equal(s_again.q, s_p.q)


def test_make_scenario_knobs():
    env = penvs.make("halfcheetah", episode_length=50, torque_gain=4.0, obs_noise=0.1)
    assert env.spec.episode_length == 50 and env.torque_gain == 4.0
    gen = torch.Generator().manual_seed(1)
    s, obs = pbase.init_fleet(env, gen, 3)
    s2, obs2, _, done = pbase.step_fleet(env, s, torch.zeros(3, 6), generator=gen)
    assert obs2.shape == (3, 17) and not done.any()
    with pytest.raises(ValueError, match="observation noise"):
        env.step(s, torch.zeros(3, 6))
    with pytest.raises(ValueError, match="generator"):
        pbase.step_fleet(env, s, torch.zeros(3, 6))


def test_deprecated_env_surface_matches_reference():
    """`Env`, `FunctionalEnv` and `auto_reset`: the in-repo envs keep the
    legacy `reset` spelling, `env_init` resolves either spelling, and
    `auto_reset` is `step_auto` itself."""
    assert pbase.auto_reset is pbase.step_auto and rbase.auto_reset is rbase.step_auto
    for name in NAMES:
        env_p, env_r = penvs.make(name), rloco.make(name)
        assert isinstance(env_p, pbase.FunctionalEnv) and isinstance(env_r, rbase.FunctionalEnv)
        assert isinstance(env_p, pbase.Env) and isinstance(env_r, rbase.Env)
        s1, o1 = env_p.reset(torch.Generator().manual_seed(4), 3, device="cpu")
        s2, o2 = env_p.init(torch.Generator().manual_seed(4), 3, device="cpu")
        assert torch.equal(o1, o2) and torch.equal(s1.q, s2.q)

    class LegacyEnv:
        """An env of the old protocol: only `reset`."""

        spec = penvs.make("pendulum").spec

        def reset(self, generator, n=1, *, device=None):
            return penvs.make("pendulum").init(generator, n, device=device)

    s, obs = pbase.env_init(LegacyEnv(), torch.Generator().manual_seed(1), 2, device="cpu")
    assert obs.shape == (2, 3)
    for name in ("Env", "FunctionalEnv", "auto_reset"):
        assert name in pbase.__all__ and name in penvs.__all__
