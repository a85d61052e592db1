"""Port parity: the fused whole-update step (kernels 4 and 5) and
`ddpg.update(backend="pallas_fused_step")` against the JAX reference.

On the CPU the port runs the kernels' plain twins
(`kernels.fxp_mlp.ref.ref_ddpg_critic_step` / `ref_ddpg_actor_step`); the
reference runs `ddpg_critic_step_pallas` / `ddpg_actor_step_pallas` in
interpret mode.  Inputs are numpy arrays from a seed, handed to both.

Contracts, the reference's own (`tests/kernels/test_fxp_mlp_step.py:84-126`):
params within 2⁻¹⁶ (one Q15.16 quantum) in the monitor phase and 1e-3 in
the quant phase; targets within 1e-6 in the monitor phase (1e-3 in the
quant phase); site extrema atol 1e-6; loss partials rtol 1e-5 / atol 1e-6.
The reference's test holds no moments.  Here they are held as
`tests/test_torch_ddpg_train.py` holds them: the two sides sum a gradient
in another order (the reference splits the critic's first layer by rows
for its lanes), so a gradient can land one quantum apart after its Q15.16
projection, which moves m by (1 − b1)·2⁻¹⁶ ≈ 1.5e-6: mu within 2e-6 and nu
within 1e-7, rtol 1e-4, in the monitor phase; 1e-3 in the quant phase.
The float path (QAT off, float weights) has no lattice to absorb a
last-bit difference of a sum, so there params and moments hold at 5e-4
(`test_fxp_mlp_step.py:136`).

The one-quantum reasoning assumes both sides take every decision alike.
On the card a ReLU decision at a pre-activation within float32 summation
error of 0 went the other way: on the inputs kept as chip_smoke.py's
standing case (`tests/data/kernel_step_relu_flip.gen`: B = 200 with 30
masked rows, monitor phase), row 117, unit 194 of the actor's second layer
has an exact pre-activation of −5.3e-7 from the twin's product inputs
(Σ|terms| = 4.54).  The twin's
float32 sum gave ≤ 0 (ReLU off), kernel 5's > 0 (on), so the kernel's
cotangent there, −9.66e-6, entered dW₁[:, 194].  At k = 34 (input 2.631)
it moved the gradient by 2.54e-5, 1.67 quanta (−23.62 against the twin's
−21.96 quanta); the Q15.16 projection made that two quanta, and the first
moment moved two quanta of (1 − b1)·2⁻¹⁶: 3.05e-6 against the 2e-6 bound.
Both sides are right to float32 in their own sum order.  A product
input's rounding is such a decision too: at B = 1, where the cotangent is
not divided by 128, seven of the critic's last-layer inputs of one row
rounded to the neighbouring Q15.16 point and moved dW₂ by up to 4.0 quanta
(`tools/step_check.py`).  So on the card (chip_smoke.py `kernel_step`, the
card-only tests, through `kernels.fxp_mlp.replay.check_step`) the kernel's
own pass-2 operands are replayed in float64 from their own previous layer:
each product input must be the rounding of a value within float32's
probabilistic rounding bound of its sum (λ·u·√Σ s_k² over the exact prefix sums, λ = 10; 1.39e-6 at row
117, unit 194, where the pre-activation from the kernel's own inputs is
9.3e-10), so at most one lattice step off and only across an edge that
close; each cotangent the exact backward of the kernel's own next layer
within the same bound; a ReLU or straight-through decision either way only
within it.  Then mu and nu are widened, leaf by leaf, by how far those
operands lie from the twin's (`replay.pass2_slack`); the parent kernels
pass that check too.  Params and targets keep the reference's contracts.
These CPU tests meet no such decision on their inputs and keep the bounds
above.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401  (one intra-op thread a worker)

import jax
import jax.numpy as jnp

from repro.kernels.fxp_mlp import kernel as rkernel
from repro.kernels.fxp_mlp import ops as rops
from repro.optim import adam as radam
from repro.optim import fxp_adam as rfxp_adam
from repro.rl import ddpg as rddpg
from repro.rl.envs.locomotion import make

from repro_torch.convert import ddpg_state_from_numpy
from repro_torch.core import fixedpoint as fxp
from repro_torch.kernels.fxp_mlp import ref as pref
from repro_torch.optim import adam as padam
from repro_torch.optim import fxp_adam as pfxp_adam
from repro_torch.rl import ddpg as pddpg

Q = 2.0**-16
OBS, ACT, HID = 5, 2, (24, 16)
ACTOR_ACTS, CRITIC_ACTS = ("relu", "relu", "tanh"), ("relu", "relu", "none")
SPEC = make("halfcheetah").spec


# --------------------------------------------------------------------------
# kernels 4 and 5 alone, narrow nets: plain twin vs the Pallas kernel
# --------------------------------------------------------------------------


def _lattice(a):
    return (np.round(a * 65536.0) / 65536.0).astype(np.float32)


def _tree(rng, dims, scale=0.3):
    ws = [_lattice(rng.normal(scale=scale, size=(k, n))) for k, n in zip(dims[:-1], dims[1:])]
    bs = [_lattice(rng.normal(scale=scale, size=(n,))) for n in dims[1:]]
    return ws, bs


def _moments(rng, dims):
    """Adam moments as a run leaves them: m small, v of the order of m²."""
    shapes = [(k, n) for k, n in zip(dims[:-1], dims[1:])] + [(n,) for n in dims[1:]]
    ms = [rng.normal(scale=1e-3, size=s).astype(np.float32) for s in shapes]
    vs = [(m.astype(np.float64) ** 2 * rng.uniform(1, 4, size=m.shape) + 1e-10).astype(np.float32) for m in ms]
    n = len(dims) - 1
    return (ms[:n], ms[n:]), (vs[:n], vs[n:])


def _step_case(seed, batch, masked):
    rng = np.random.default_rng(seed)
    a_dims, c_dims = (OBS, *HID, ACT), (OBS + ACT, *HID, 1)
    case = {
        "obs": rng.normal(size=(batch, OBS)).astype(np.float32) * 2,
        "action": rng.uniform(-1, 1, size=(batch, ACT)).astype(np.float32),
        "reward": rng.normal(size=(batch,)).astype(np.float32),
        "done": (rng.uniform(size=batch) < 0.2).astype(np.float32),
        "next_obs": rng.normal(size=(batch, OBS)).astype(np.float32) * 2,
        "w": (np.arange(batch) < batch - masked).astype(np.float32),
        "actor": _tree(rng, a_dims),
        "actor_t": _tree(rng, a_dims),
        "critic": _tree(rng, c_dims),
        "critic_t": _tree(rng, c_dims),
    }
    case["actor_m"], case["actor_v"] = _moments(rng, a_dims)
    case["critic_m"], case["critic_v"] = _moments(rng, c_dims)
    # site operands from fixed ranges (the sites' inputs reach past them, so
    # the straight-through masks clip somewhere)
    a_min = rng.uniform(-4, -1, size=6).astype(np.float32)
    a_max = rng.uniform(1, 4, size=6).astype(np.float32)
    d, z = fxp.affine_params(torch.from_numpy(a_min), torch.from_numpy(a_max), 16)
    case["deltas"], case["zs"] = d.numpy(), z.to(torch.float32).numpy()
    c = padam.step_constants(padam.AdamConfig(lr=1e-3), torch.tensor(3, dtype=torch.int32))
    inv_w = np.float32(1.0) / np.maximum(case["w"].sum(dtype=np.float32), np.float32(1.0))
    case["hyper"] = np.array([inv_w, 0.99, 0.005, np.float32(1 - 0.005), *(float(v) for v in c)], np.float32)
    return case


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _ttree(tree):
    return [_t(w) for w in tree[0]], [_t(b) for b in tree[1]]


def _ref_critic_step(c, quant, qat, fxp_weights):
    """`ddpg_critic_step_pallas` alone, operands padded as the reference's
    `fxp_mlp_train_step` pads them."""
    b = c["obs"].shape[0]
    bm = rops._row_block(b)
    mp = rops._round_up(b, bm)
    pad_wb = lambda t: rops._pad_wb([jnp.asarray(w) for w in t[0]], [jnp.asarray(x) for x in t[1]])  # noqa: E731
    ct = pad_wb(c["critic_t"])
    tw0_obs, tw0_act = rops._split_w0(ct[0], OBS, ACT)
    deltas, zs = rops._norm_quant_params(jnp.asarray(c["deltas"]), jnp.asarray(c["zs"]), 6, qat)
    c_wb = pad_wb(c["critic"])
    out = rkernel.ddpg_critic_step_pallas(
        jnp.asarray([int(quant)], jnp.int32),
        rops._pad_batch(jnp.concatenate([c["obs"], c["action"]], -1), mp),
        rops._pad_batch(jnp.asarray(c["next_obs"]), mp),
        rops._pad_batch(jnp.stack([c["reward"], c["done"], c["w"]], -1), mp),
        pad_wb(c["actor_t"]), tw0_obs, tw0_act, ct[1], ct[2:], ct[0], c_wb,
        pad_wb(c["critic_m"]), pad_wb(c["critic_v"]), deltas, zs, jnp.asarray(c["hyper"]),
        actor_acts=ACTOR_ACTS, critic_acts=CRITIC_ACTS, critic_in_dims=(OBS + ACT, *HID), m_valid=b, bm=bm,
        n_bits=16, qat=qat, fxp32_phase1=True, fxp_weights=fxp_weights, interpret=True,
    )
    return _unpad(out, c["critic"], mp // bm)


def _ref_actor_step(c, critic, quant, qat, fxp_weights):
    b = c["obs"].shape[0]
    bm = rops._row_block(b)
    mp = rops._round_up(b, bm)
    pad_wb = lambda t: rops._pad_wb([jnp.asarray(w) for w in t[0]], [jnp.asarray(x) for x in t[1]])  # noqa: E731
    cp = pad_wb(critic)
    cw0_obs, cw0_act = rops._split_w0(cp[0], OBS, ACT)
    deltas, zs = rops._norm_quant_params(jnp.asarray(c["deltas"]), jnp.asarray(c["zs"]), 6, qat)
    out = rkernel.ddpg_actor_step_pallas(
        jnp.asarray([int(quant)], jnp.int32), rops._pad_batch(jnp.asarray(c["obs"]), mp),
        rops._pad_batch(jnp.stack([c["reward"], c["done"], c["w"]], -1), mp),
        pad_wb(c["actor"]), pad_wb(c["actor_m"]), pad_wb(c["actor_v"]), pad_wb(c["actor_t"]),
        cw0_obs, cw0_act, cp[1], cp[2:], deltas, zs, jnp.asarray(c["hyper"]), obs_dim=OBS, act_dim=ACT,
        actor_acts=ACTOR_ACTS, critic_acts=CRITIC_ACTS, actor_in_dims=(OBS, *HID),
        critic_in_dims=(OBS + ACT, *HID), m_valid=b, bm=bm, n_bits=16, qat=qat, fxp32_phase1=True,
        fxp_weights=fxp_weights, interpret=True,
    )
    return _unpad(out, c["actor"], mp // bm)


def _unpad(out, like, n_blocks):
    new_p, new_m, new_v, new_t, mins, maxs, part = out
    trees = []
    for flat in (new_p, new_m, new_v, new_t):
        ws = [np.asarray(flat[2 * i])[: w.shape[0], : w.shape[1]] for i, w in enumerate(like[0])]
        bs = [np.asarray(flat[2 * i + 1])[0, : b.shape[0]] for i, b in enumerate(like[1])]
        trees.append((ws, bs))
    assert mins.shape[0] == n_blocks
    return (*trees, np.asarray(mins).min(0), np.asarray(maxs).max(0), np.asarray(part).sum(0))


def _port_step(which, c, quant, qat, fxp_weights, critic=None):
    kw = dict(actor_acts=ACTOR_ACTS, critic_acts=CRITIC_ACTS, n_bits=16, qat=qat, fxp32_phase1=True,
              fxp_weights=fxp_weights)
    d, z = (_t(c["deltas"]), _t(c["zs"])) if qat else (None, None)
    if which == "critic":
        out = pref.ref_ddpg_critic_step(
            _t(c["obs"]), _t(c["action"]), _t(c["reward"]), _t(c["done"]), _t(c["next_obs"]), _t(c["w"]),
            _ttree(c["actor_t"]), _ttree(c["critic"]), _ttree(c["critic_t"]), _ttree(c["critic_m"]),
            _ttree(c["critic_v"]), d, z, _t(c["hyper"]), quant, **kw)
    else:
        out = pref.ref_ddpg_actor_step(
            _t(c["obs"]), _t(c["w"]), _ttree(c["actor"]), _ttree(c["actor_m"]), _ttree(c["actor_v"]),
            _ttree(c["actor_t"]), _ttree(critic), d, z, _t(c["hyper"]), quant, **kw)
    *trees, mins, maxs, part = out
    np_tree = lambda t: ([w.numpy() for w in t[0]], [b.numpy() for b in t[1]])  # noqa: E731
    return (*(np_tree(t) for t in trees), mins.numpy().min(0), maxs.numpy().max(0), part.numpy().sum(0))


def _assert_trees(got, want, atol, what, rtol=0.0):
    for j, kind in enumerate(("w", "b")):
        for i, (g, w) in enumerate(zip(got[j], want[j])):
            np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=f"{what} {kind}{i}")


def _tolerances(phase, float_path=False):
    """(atol, rtol) of params, mu, nu and targets (module docstring)."""
    if float_path:
        return [(5e-4, 0.0)] * 3 + [(1e-6, 0.0)]
    if phase == "monitor":
        return [(Q, 0.0), (2e-6, 1e-4), (1e-7, 1e-4), (1e-6, 0.0)]
    return [(1e-3, 0.0)] * 4


def _assert_step(got, want, phase, float_path):
    for k, (name, (atol, rtol)) in enumerate(zip(("params", "m", "v", "target"), _tolerances(phase, float_path))):
        _assert_trees(got[k], want[k], atol, name, rtol)
    np.testing.assert_allclose(got[4], want[4], rtol=0, atol=1e-6, err_msg="mins")
    np.testing.assert_allclose(got[5], want[5], rtol=0, atol=1e-6, err_msg="maxs")
    np.testing.assert_allclose(got[6], want[6], rtol=1e-5, atol=1e-6, err_msg="partials")


STEP_CASES = [
    ("monitor", True, True),
    ("quant", True, True),
    ("monitor", False, True),
    ("quant", True, False),
    ("monitor", False, False),
]


@pytest.mark.parametrize("phase,qat,fxp_weights", STEP_CASES)
@pytest.mark.parametrize("batch,masked", [(20, 0), (20, 6)])
def test_critic_step_matches_pallas_kernel(phase, qat, fxp_weights, batch, masked):
    c = _step_case(batch + masked, batch, masked)
    quant = phase == "quant"
    got = _port_step("critic", c, quant, qat, fxp_weights)
    want = _ref_critic_step(c, quant, qat, fxp_weights)
    _assert_step(got, want, phase, float_path=not (qat or fxp_weights))


@pytest.mark.parametrize("phase,qat,fxp_weights", STEP_CASES)
@pytest.mark.parametrize("batch,masked", [(20, 0), (20, 6)])
def test_actor_step_matches_pallas_kernel(phase, qat, fxp_weights, batch, masked):
    """Through the same (updated) critic on both sides; mins/maxs hold the
    actor sites and then the critic sites, layer 0's over obs and the
    action together."""
    c = _step_case(100 + batch + masked, batch, masked)
    quant = phase == "quant"
    got = _port_step("actor", c, quant, qat, fxp_weights, critic=c["critic"])
    want = _ref_actor_step(c, c["critic"], quant, qat, fxp_weights)
    assert got[4].shape == (6,)
    _assert_step(got, want, phase, float_path=not (qat or fxp_weights))


@pytest.mark.parametrize("which", ["critic", "actor"])
def test_masked_rows_add_exactly_zero_gradient(which):
    """Rows with w = 0 carry an exactly zero cotangent: padding a batch with
    such rows (huge values in them) leaves every output of the step
    bitwise unchanged (QAT off, so no monitor sees the pad rows)."""
    c = _step_case(7, 20, 0)
    padded = dict(c)
    for k in ("obs", "action", "reward", "done", "next_obs"):
        pad = 1e6 * np.ones((12,) + c[k].shape[1:], np.float32)
        padded[k] = np.concatenate([c[k], pad if k != "done" else 0 * pad])
    padded["w"] = np.concatenate([c["w"], np.zeros(12, np.float32)])
    small = _port_step(which, c, False, False, True, critic=c["critic"])
    big = _port_step(which, padded, False, False, True, critic=c["critic"])
    for k in range(4):
        for j in range(2):
            for a, b in zip(small[k][j], big[k][j]):
                np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(small[6], big[6])


# --------------------------------------------------------------------------
# the epilogue: plain Adam + soft update vs the optimizers, bitwise
# --------------------------------------------------------------------------


def test_epilogue_bitmatches_fxp_adam_30_steps():
    """The fused step's epilogue (`ref._adam_soft`, the plain twin of the
    kernel's) against the port's and the reference's `fxp_adam.update`
    followed by the soft update: bitwise over 30 steps (under 30, where
    XLA's and libm's float32 `pow` give the same bias corrections;
    `ROADMAP.md` queue 3)."""
    rng = np.random.default_rng(5)
    shape = (8, 128)
    tau = 0.005
    p0 = _lattice(rng.normal(size=shape))
    cfg_r, cfg_p = rfxp_adam.FxpAdamConfig(lr=3e-3), pfxp_adam.FxpAdamConfig(lr=3e-3)
    p_r, st_r, t_r = jnp.asarray(p0), rfxp_adam.init(jnp.asarray(p0)), jnp.asarray(p0)
    p_p, st_p, t_p = torch.from_numpy(p0), pfxp_adam.init(torch.from_numpy(p0)), torch.from_numpy(p0)
    p_k, m_k, v_k, t_k = torch.from_numpy(p0), torch.zeros(shape), torch.zeros(shape), torch.from_numpy(p0)
    upd_r = rfxp_adam.update  # op by op, each result rounded, as PyTorch's ops round them
    for step in range(30):
        g = rng.normal(size=shape).astype(np.float32) * 0.01
        p_r, st_r, _ = upd_r(cfg_r, jnp.asarray(g), st_r, p_r)
        t_r = (1 - tau) * t_r + tau * p_r
        p_p, st_p, _ = pfxp_adam.update(cfg_p, torch.from_numpy(g), st_p, p_p)
        t_p = (1 - tau) * t_p + tau * p_p
        c = padam.step_constants(cfg_p, torch.tensor(step + 1, dtype=torch.int32))
        hyper = torch.stack([torch.tensor(1.0), torch.tensor(0.99), torch.tensor(tau),
                             torch.tensor(1 - tau, dtype=torch.float32), *c]).to(torch.float32)
        p_k, m_k, v_k, t_k = pref._adam_soft(p_k, torch.from_numpy(g), m_k, v_k, t_k, hyper, True)
        for got, port, want in ((p_k, p_p, p_r), (m_k, st_p.mu, st_r.mu), (v_k, st_p.nu, st_r.nu),
                                (t_k, t_p, t_r)):
            np.testing.assert_array_equal(got.numpy(), port.numpy(), err_msg=f"step {step}")
            np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=f"step {step}")


# --------------------------------------------------------------------------
# ddpg.update(backend="pallas_fused_step"): port vs reference, full widths
# --------------------------------------------------------------------------


def _batch(seed, n, mask_rows=None):
    r = np.random.default_rng(seed)
    b = {
        "obs": r.normal(size=(n, SPEC.obs_dim)).astype(np.float32),
        "action": r.uniform(-1, 1, size=(n, SPEC.act_dim)).astype(np.float32),
        "reward": r.normal(size=(n,)).astype(np.float32),
        "next_obs": r.normal(size=(n, SPEC.obs_dim)).astype(np.float32),
        "done": r.uniform(size=(n,)) < 0.1,
    }
    if mask_rows is not None:
        b["mask"] = (np.arange(n) < mask_rows).astype(np.float32)
    return b


def _port(state_r):
    return ddpg_state_from_numpy(jax.tree.map(np.asarray, state_r), device="cpu")


def _max_err(tree_p, tree_r):
    return max(float(np.abs(tree_p[layer][leaf].numpy() - np.asarray(tree_r[layer][leaf])).max())
               for layer in tree_r for leaf in tree_r[layer])


def test_fused_update_matches_reference_across_the_delay():
    """Four updates from one state (batches 8, 32, 32 masked to 20, 32),
    the QAT delay at 2: two monitor-phase steps, then two quant-phase ones.
    Params, moments and targets at the contracts of the module docstring,
    QAT ranges atol 1e-6, losses rtol 1e-5 / atol 1e-6."""
    kw = dict(batch_size=32, backend="pallas_fused_step", qat_delay=2)
    cfg_r, cfg_p = rddpg.DDPGConfig(**kw), pddpg.DDPGConfig(**kw)
    st_r = rddpg.init(jax.random.key(4), SPEC, cfg_r)
    st_p = _port(st_r)
    upd = jax.jit(lambda s, b: rddpg.update(s, b, cfg_r))
    for i, (n, mask_rows) in enumerate(((8, None), (32, None), (32, 20), (32, None))):
        phase = "quant" if bool(st_r.qat.quantized_phase) else "monitor"
        assert phase == ("monitor" if i < 2 else "quant")
        batch = _batch(40 + i, n, mask_rows)
        if mask_rows is None:
            batch["mask"] = np.ones(n, np.float32)  # one jitted signature for every step
        st_r, m_r = upd(st_r, jax.tree.map(jnp.asarray, batch))
        st_p, m_p = pddpg.update(st_p, {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}, cfg_p)
        (p_tol, _), mu_tol, nu_tol, (t_tol, _) = _tolerances(phase)
        for name in ("actor", "critic"):
            assert _max_err(getattr(st_p, name), getattr(st_r, name)) <= p_tol, (i, name)
        for name in ("actor_target", "critic_target"):
            assert _max_err(getattr(st_p, name), getattr(st_r, name)) <= t_tol, (i, name)
        for name in ("actor_opt", "critic_opt"):
            o_p, o_r = getattr(st_p, name), getattr(st_r, name)
            assert int(o_p.step) == int(o_r.step) == i + 1
            for moments, (atol, rtol) in ((("mu", mu_tol)), (("nu", nu_tol))):
                got, want = getattr(o_p, moments), getattr(o_r, moments)
                for layer in want:
                    for leaf in want[layer]:
                        np.testing.assert_allclose(got[layer][leaf].numpy(), np.asarray(want[layer][leaf]),
                                                   rtol=rtol, atol=atol, err_msg=f"step {i} {name}.{moments}")
        for site, r in st_r.qat.ranges.items():
            p = st_p.qat.ranges[site]
            assert int(p.count) == int(r.count), site
            for field in ("a_min", "a_max"):
                np.testing.assert_allclose(getattr(p, field).numpy(), np.asarray(getattr(r, field)), rtol=0,
                                           atol=1e-6, err_msg=f"step {i} {site}.{field}")
        for k in m_r:
            np.testing.assert_allclose(m_p[k].numpy(), np.asarray(m_r[k]), rtol=1e-5, atol=1e-6, err_msg=k)
    assert int(st_p.step) == int(st_r.step) == 4 and int(st_p.qat.step) == 4


# --------------------------------------------------------------------------
# the port's fused step vs the port's "pallas" backend
# --------------------------------------------------------------------------


def _port_run(backend, steps, *, delay, batch, mask_rows=None, qat=True, fxp_weights=True):
    cfg = pddpg.DDPGConfig(backend=backend, qat_delay=delay, qat_enabled=qat, fxp_weights=fxp_weights,
                           batch_size=batch)
    state = pddpg.init(SPEC, cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    metrics = {}
    for t in range(steps):
        b = {k: torch.from_numpy(np.asarray(v)) for k, v in _batch(100 + t, batch, mask_rows).items()}
        state, metrics = pddpg.update(state, b, cfg)
    return state, metrics


def _port_err(a, b, names):
    return max(max(float((x[layer][leaf] - y[layer][leaf]).abs().max()) for layer in x for leaf in x[layer])
               for x, y in ((getattr(a, n), getattr(b, n)) for n in names))


@pytest.mark.parametrize("batch,mask_rows", [(8, None), (32, None), (200, None), (32, 20)])
def test_fused_step_tracks_the_pallas_backend(batch, mask_rows):
    """Three monitor-phase updates: params within one quantum of backend
    "pallas", targets within 1e-6, QAT ranges within 1e-6, losses rtol 1e-5.
    At B = 200 params are held to two quanta: a sum over rows taken in
    another order lands a Q15.16 projection one quantum apart, and the
    reference's own fused step is two quanta (3.05e-5) from its "pallas"
    path there (`tests/kernels/test_fxp_mlp_step.py`, case [200-None])."""
    sf, mf = _port_run("pallas_fused_step", 3, delay=100, batch=batch, mask_rows=mask_rows)
    sp, mp = _port_run("pallas", 3, delay=100, batch=batch, mask_rows=mask_rows)
    p_tol = 2 * Q if batch == 200 else Q
    assert _port_err(sf, sp, ("actor", "critic")) <= p_tol
    assert _port_err(sf, sp, ("actor_target", "critic_target")) <= 1e-6
    for site, r in sp.qat.ranges.items():
        p = sf.qat.ranges[site]
        assert int(p.count) == int(r.count)
        torch.testing.assert_close(p.a_min, r.a_min, rtol=0, atol=1e-6)
        torch.testing.assert_close(p.a_max, r.a_max, rtol=0, atol=1e-6)
    for k in mp:
        torch.testing.assert_close(mf[k], mp[k], rtol=1e-5, atol=1e-6, msg=k)


def test_fused_step_tracks_the_pallas_backend_across_the_delay():
    """Five updates crossing the QAT delay (1) into the quant phase: the
    1e-3 contract."""
    sf, mf = _port_run("pallas_fused_step", 5, delay=1, batch=32)
    sp, mp = _port_run("pallas", 5, delay=1, batch=32)
    assert bool(sf.qat.quantized_phase)
    assert _port_err(sf, sp, ("actor", "critic", "actor_target", "critic_target")) <= 1e-3
    for k in mp:
        torch.testing.assert_close(mf[k], mp[k], rtol=1e-3, atol=1e-5, msg=k)


def test_the_update_runs_on_the_cpu_through_the_plain_twins(monkeypatch):
    """CPU tensors never reach a kernel wrapper: the plain twins run."""
    from repro_torch.kernels.fxp_mlp import ops

    def boom(*a, **k):
        raise AssertionError("a kernel wrapper was called for CPU tensors")

    monkeypatch.setattr(ops, "ddpg_critic_step_cuda", boom)
    monkeypatch.setattr(ops, "ddpg_actor_step_cuda", boom)
    state, metrics = _port_run("pallas_fused_step", 1, delay=0, batch=8)
    assert int(state.step) == 1 and all(torch.isfinite(v) for v in metrics.values())


def test_config_carries_across_unchanged():
    cfg_r = rddpg.DDPGConfig(backend="pallas_fused_step", qat_delay=7)
    cfg_p = pddpg.DDPGConfig(**{f.name: getattr(cfg_r, f.name) for f in dataclasses.fields(cfg_r)})
    assert cfg_p.backend == "pallas_fused_step" and cfg_p.qat_delay == 7
    assert radam.AdamConfig().lr == padam.AdamConfig().lr
