"""Port parity: one `repro_torch.rl.ddpg.update` against the JAX reference's,
from the same state, per training backend.

Both sides start from one reference `DDPGState` (carried across with
`convert.ddpg_state_from_numpy`) and the same batch (numpy, from a seed), at
the paper's full widths (halfcheetah: actor 17-400-300-6, critic
23-400-300-1) and B = 16.  On the CPU the port's "pallas" backend runs the
plain versions of kernels B and 3; the reference runs its Pallas kernels in
interpret mode.  Cases: QAT off, and QAT on in the monitor phase and in the
quant phase (the state after one reference update with delay 1).

Contracts (`ROADMAP.md`, from `tests/kernels/test_fxp_mlp_grad.py:187-190`):
losses rtol 1e-4 / atol 1e-5, the four nets rtol 1e-4 / atol 2e-5.  Adam
moments: a gradient may land one Q15.16 quantum (2⁻¹⁶) apart after its
projection, so mu within (1 − b1)·2⁻¹⁶ ≈ 2e-6 and nu within 1e-7, rtol
1e-4.  Range monitors: layer inputs past the first come out of sums taken
in another order, so rtol 1e-5 / atol 1e-6; counts and steps exactly.  The
5-update trajectory holds params within 8·2⁻¹⁶, the reference's contract
between its two training drivers (`tests/test_loop.py:171`).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401  (one intra-op thread a worker)

import jax
import jax.numpy as jnp

from repro.rl import ddpg as rddpg
from repro.rl.envs.locomotion import make

from repro_torch.convert import ddpg_state_from_numpy
from repro_torch.rl import ddpg as pddpg

B = 16
NETS = ("actor", "critic", "actor_target", "critic_target")
SPEC = make("halfcheetah").spec


def _batch(seed, mask=False):
    r = np.random.default_rng(seed)
    b = {
        "obs": r.normal(size=(B, SPEC.obs_dim)).astype(np.float32),
        "action": r.uniform(-1, 1, size=(B, SPEC.act_dim)).astype(np.float32),
        "reward": r.normal(size=(B,)).astype(np.float32),
        "next_obs": r.normal(size=(B, SPEC.obs_dim)).astype(np.float32),
        "done": r.uniform(size=(B,)) < 0.2,
    }
    if mask:
        b["mask"] = (np.arange(B) < B - 5).astype(np.float32)
    return b


def _cfgs(backend, qat, delay=1):
    kw = dict(batch_size=B, backend=backend, qat_enabled=qat, qat_delay=delay)
    return rddpg.DDPGConfig(**kw), pddpg.DDPGConfig(**kw)


def _port(state_r):
    return ddpg_state_from_numpy(jax.tree.map(np.asarray, state_r), device="cpu")


def _assert_close(got, want, what, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol, err_msg=what)


def _assert_state_close(st_p, st_r, *, params_atol=2e-5):
    for name in NETS:
        for layer, leaves in getattr(st_r, name).items():
            for leaf, want in leaves.items():
                _assert_close(getattr(st_p, name)[layer][leaf], want, f"{name}/{layer}/{leaf}", rtol=1e-4,
                              atol=params_atol)
    for name in ("actor_opt", "critic_opt"):
        o_p, o_r = getattr(st_p, name), getattr(st_r, name)
        assert int(o_p.step) == int(o_r.step)
        for layer, leaves in o_r.mu.items():
            for leaf in leaves:
                _assert_close(o_p.mu[layer][leaf], o_r.mu[layer][leaf], f"{name}.mu/{layer}/{leaf}", rtol=1e-4, atol=2e-6)
                _assert_close(o_p.nu[layer][leaf], o_r.nu[layer][leaf], f"{name}.nu/{layer}/{leaf}", rtol=1e-4, atol=1e-7)
    assert int(st_p.step) == int(st_r.step) and int(st_p.qat.step) == int(st_r.qat.step)
    for site, r in st_r.qat.ranges.items():
        p = st_p.qat.ranges[site]
        assert int(p.count) == int(r.count), site
        for field in ("a_min", "a_max"):
            _assert_close(getattr(p, field), getattr(r, field), f"{site}.{field}", rtol=1e-5, atol=1e-6)


def _assert_metrics_close(m_p, m_r):
    assert set(m_p) == set(m_r)
    for k in m_r:
        _assert_close(m_p[k], m_r[k], k, rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def reference_runs():
    """Per (backend, qat): the reference's start states and one update from
    each (jitted once per config)."""
    runs = {}
    for backend in ("jnp", "pallas"):
        for qat in (False, True):
            cfg_r, _ = _cfgs(backend, qat)
            upd = jax.jit(lambda s, b, cfg=cfg_r: rddpg.update(s, b, cfg))
            st0 = rddpg.init(jax.random.key(0), SPEC, cfg_r)
            b0, b1 = _batch(0), _batch(1)
            st1, m0 = upd(st0, jax.tree.map(jnp.asarray, b0))
            cases = {"monitor": (st0, b0, st1, m0)}
            if qat:
                st2, m1 = upd(st1, jax.tree.map(jnp.asarray, b1))
                cases["quant"] = (st1, b1, st2, m1)
            runs[backend, qat] = cases
    return runs


@pytest.mark.parametrize("case", ["off", "monitor", "quant"])
@pytest.mark.parametrize("backend", ["jnp", "pallas"])
def test_update_matches_reference(reference_runs, backend, case):
    qat = case != "off"
    start, batch, want_state, want_metrics = reference_runs[backend, qat]["quant" if case == "quant" else "monitor"]
    assert bool(start.qat.quantized_phase) == (case == "quant")
    _, cfg_p = _cfgs(backend, qat)
    st_p, m_p = pddpg.update(_port(start), {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}, cfg_p)
    _assert_metrics_close(m_p, want_metrics)
    _assert_state_close(st_p, want_state)


def test_masked_update_matches_reference():
    """Rows with mask 0 add nothing: the weighted loss of the reference."""
    cfg_r, cfg_p = _cfgs("pallas", True, delay=5)
    st0 = rddpg.init(jax.random.key(3), SPEC, cfg_r)
    batch = _batch(7, mask=True)
    want_state, want_metrics = jax.jit(lambda s, b: rddpg.update(s, b, cfg_r))(st0, jax.tree.map(jnp.asarray, batch))
    st_p, m_p = pddpg.update(_port(st0), {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}, cfg_p)
    _assert_metrics_close(m_p, want_metrics)
    _assert_state_close(st_p, want_state)


def test_five_update_trajectory_matches_reference():
    """Five "pallas" updates on the same batches, crossing the QAT delay
    (2): params within 8·2⁻¹⁶ of the reference's at every step."""
    cfg_r, cfg_p = _cfgs("pallas", True, delay=2)
    st_r = rddpg.init(jax.random.key(1), SPEC, cfg_r)
    st_p = _port(st_r)
    upd = jax.jit(lambda s, b: rddpg.update(s, b, cfg_r))
    for i in range(5):
        batch = _batch(10 + i)
        st_r, m_r = upd(st_r, jax.tree.map(jnp.asarray, batch))
        st_p, m_p = pddpg.update(st_p, {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}, cfg_p)
        for name in NETS:
            for layer, leaves in getattr(st_r, name).items():
                for leaf, want in leaves.items():
                    _assert_close(getattr(st_p, name)[layer][leaf], want, f"step {i} {name}/{layer}/{leaf}", rtol=0,
                                  atol=8 * 2.0**-16)
    assert bool(st_p.qat.quantized_phase) and bool(st_r.qat.quantized_phase)
    assert int(st_p.step) == int(st_r.step) == 5


@pytest.mark.parametrize("backend,err,match", [
    # the reference's guard (`tests/kernels/test_fxp_mlp_step.py:255`): the
    # message names all three trainable backends
    ("pallas_layer", ValueError, "pallas_fused_step"),
    ("pallas_layer", ValueError, "pallas_layer"),
])
def test_untrainable_backends_raise(backend, err, match):
    cfg = pddpg.DDPGConfig(batch_size=4, backend=backend)
    st = pddpg.init(SPEC, cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    batch = {k: torch.from_numpy(np.asarray(v)[:4]) for k, v in _batch(0).items()}
    with pytest.raises(err, match=match):
        pddpg.update(st, batch, cfg)


def test_init_follows_the_reference_layout_and_device_rule():
    cfg = pddpg.DDPGConfig()
    st = pddpg.init(SPEC, cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    ref = rddpg.init(jax.random.key(0), SPEC, rddpg.DDPGConfig())
    for name in NETS:
        for layer, leaves in getattr(ref, name).items():
            for leaf, want in leaves.items():
                got = getattr(st, name)[layer][leaf]
                assert tuple(got.shape) == want.shape and got.dtype == torch.float32
                # weights start on the Q15.16 lattice
                assert torch.equal(got * 65536, torch.round(got * 65536))
    assert sorted(st.qat.ranges) == sorted(ref.qat.ranges)
    assert int(st.actor_opt.step) == int(st.critic_opt.step) == int(st.qat.step) == int(st.step) == 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pddpg.init(SPEC, cfg, generator=torch.Generator().manual_seed(0))
