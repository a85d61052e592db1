"""Kernel 7's plain twins (`kernels.quantize.ref_qat_site_params`,
`ref_qat_fold`, which are `core.qat.site_params` / `fold_minmax`) and the
calls that use them (`QATContext.site_quant_params`, `observe_many(...,
tick=True)`, `ddpg.act`, the fused update), on the CPU.

Held bit for bit against the per-site PyTorch ops they replace (copies of
that code below: `finalized` + `affine_params` per site, `observe` per site
in two contexts + `tick`) and against the JAX reference's `repro.core.qat`,
in both Algorithm-1 phases, on the edge cases: a never-updated site (the
±inf initial range), a zero span, a span under the 1e-6 guard, a NaN and an
infinite extremum, one-signed ranges and signed zeros.  The card's kernel is
held to the same twins in `tests/test_torch_kernels_cuda.py`.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401  (one intra-op thread a worker)

import jax.numpy as jnp

from repro.core import qat as rqat
from repro.core import ranges as rranges

from repro_torch.core import fixedpoint as fxp
from repro_torch.core import qat as pqat
from repro_torch.core.ranges import RangeStat, finalized
from repro_torch.kernels import quantize
from repro_torch.kernels.quantize.kernel import qat_fold_cuda, qat_site_params_cuda
from repro_torch.optim import adam, fxp_adam
from repro_torch.rl import ddpg
from repro_torch.rl.envs import locomotion
from repro_torch.kernels.fxp_mlp.ops import fxp_mlp_train_step

NAN, INF = float("nan"), float("inf")
SITES = [f"s{i}" for i in range(9)]
# (a_min, a_max, count) per site
EDGES = [
    (-2.5, 3.125, 4),  # captured
    (INF, -INF, 0),  # never updated: the initial range
    (0.75, 0.75, 2),  # zero span
    (1.0, float(np.float32(1.0) + np.float32(9.5e-7)), 3),  # a span under the 1e-6 guard
    (NAN, 2.0, 3),  # a NaN extremum
    (-INF, 1.0, 1),  # an infinite extremum
    (0.5, 4.0, 5),  # all positive
    (-4.0, -0.25, 5),  # all negative
    (-0.0, 0.0, 1),  # signed zeros, zero span
]
DELAY = 4


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.detach().reshape(-1).contiguous().view(torch.int32).numpy()


def _assert_bitwise(got, want, what):
    np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=what)


def _stats(edges=EDGES):
    return [RangeStat(torch.tensor(lo, dtype=torch.float32), torch.tensor(hi, dtype=torch.float32),
                      torch.tensor(n, dtype=torch.int32)) for lo, hi, n in edges]


def _state(step, edges=EDGES):
    """The same QAT state in the port and in the reference."""
    p = pqat.QATState(config=pqat.QATConfig(delay=DELAY), step=torch.tensor(step, dtype=torch.int32),
                      ranges=dict(zip(SITES, _stats(edges))))
    r = rqat.QATState.init(delay=DELAY, sites=SITES)
    r = dataclasses.replace(r, step=jnp.int32(step), ranges={
        name: rranges.RangeStat(jnp.float32(lo), jnp.float32(hi), jnp.int32(n))
        for name, (lo, hi, n) in zip(SITES, edges)})
    return p, r


def _extrema(seed, n):
    """Fold extrema from a seed (n ≥ 3): an infinite maximum first, a NaN
    minimum second, signed zeros last."""
    rng = np.random.default_rng(seed)
    mins = (rng.normal(size=n) * 3 - 1).astype(np.float32)
    maxs = (rng.normal(size=n) * 3 + 1).astype(np.float32)
    maxs[0], mins[1], mins[-1], maxs[-1] = np.inf, np.nan, -0.0, 0.0
    return torch.from_numpy(mins), torch.from_numpy(maxs)


# --- copies of the per-site code kernel 7 replaces ---------------------------


def _site_quant_params_before(ranges: dict, names, n_bits=16):
    deltas, zs = [], []
    for name in names:
        a_min, a_max = finalized(ranges[name])
        d, z = fxp.affine_params(a_min, a_max, n_bits)
        deltas.append(d)
        zs.append(z.to(torch.float32))
    return torch.stack(deltas), torch.stack(zs)


def _fold_before(state, c_names, c_mins, c_maxs, a_names, a_mins, a_maxs):
    """`_update_fused_step`'s range evolution before kernel 7: `observe` per
    site in two contexts, then `tick`."""
    ctx1 = pqat.QATContext(state)
    for j, site in enumerate(c_names):
        ctx1.observe(site, c_mins[j], c_maxs[j])
    ctx2 = pqat.QATContext(ctx1.finalize())
    for j, site in enumerate(a_names):
        ctx2.observe(site, a_mins[j], a_maxs[j])
    return ctx2.finalize().tick()


def _assert_states_bitwise(got, want):
    _assert_bitwise(got.step, want.step, "step")
    assert list(got.ranges) == list(want.ranges)
    for name, stat in want.ranges.items():
        for field in ("a_min", "a_max", "count"):
            _assert_bitwise(getattr(got.ranges[name], field), getattr(stat, field), f"{name}.{field}")


def _assert_matches_reference(p_state, r_state):
    np.testing.assert_array_equal(p_state.step.numpy(), np.asarray(r_state.step))
    for name, stat in r_state.ranges.items():
        for field in ("a_min", "a_max", "count"):
            np.testing.assert_array_equal(getattr(p_state.ranges[name], field).numpy(),
                                          np.asarray(getattr(stat, field)), err_msg=f"{name}.{field}")


# --- the twins ---------------------------------------------------------------


@pytest.mark.parametrize("n_bits", [16, 8])
def test_site_params_twin_is_the_per_site_code_and_the_reference(n_bits):
    p_state, r_state = _state(step=0)
    got = quantize.qat_site_params(list(p_state.ranges.values()), n_bits)
    want = _site_quant_params_before(p_state.ranges, SITES, n_bits)
    r_cfg = dataclasses.replace(r_state.config, n_bits=n_bits)
    ref = rqat.QATContext(dataclasses.replace(r_state, config=r_cfg)).site_quant_params(SITES)
    for g, w, r, what in zip(got, want, ref, ("deltas", "zs")):
        assert g.dtype == torch.float32 and g.shape == (len(SITES),)
        _assert_bitwise(g, w, what)
        np.testing.assert_array_equal(g.numpy(), np.asarray(r), err_msg=what)
    # the NaN site: delta 1 and z 0, as the reference and the card convert
    assert got[0][4] == 1.0 and got[1][4] == 0.0


@pytest.mark.parametrize("step", [DELAY - 1, DELAY, DELAY + 3], ids=["monitor", "flip", "quant"])
def test_fold_twin_is_observe_per_site_and_the_reference(step):
    """The fused update's fold: the three critic sites, then all nine, then
    the tick — the twin, `observe_many(..., tick=True)` in one call or two
    (in a plain context and in `ddpg`'s, which dispatches to kernel 7 on
    the card), the per-site code and the reference's `observe` calls
    agree."""
    p_state, r_state = _state(step)
    c_names, a_names = SITES[6:], SITES
    c_mins, c_maxs = _extrema(1, 3)
    a_mins, a_maxs = _extrema(2, 9)
    want = _fold_before(p_state, c_names, c_mins, c_maxs, a_names, a_mins, a_maxs)

    index = {n: i for i, n in enumerate(SITES)}
    folds = [(index[n], c_mins[j], c_maxs[j]) for j, n in enumerate(c_names)]
    folds += [(index[n], a_mins[j], a_maxs[j]) for j, n in enumerate(a_names)]
    stats, new_step = quantize.ref_qat_fold(list(p_state.ranges.values()), p_state.step, folds, delay=DELAY,
                                            tick=True)
    _assert_states_bitwise(dataclasses.replace(p_state, ranges=dict(zip(SITES, stats)), step=new_step), want)

    ctx = pqat.QATContext(p_state)
    ctx.observe_many(c_names, c_mins, c_maxs)
    ctx.observe_many(a_names, a_mins, a_maxs, tick=True)
    got = ctx.finalize()
    _assert_states_bitwise(got, want)
    one = ddpg._qat_context(p_state)
    one.observe_many(c_names + a_names, [*c_mins, *a_mins], [*c_maxs, *a_maxs], tick=True)
    _assert_states_bitwise(one.finalize(), want)

    r_ctx = rqat.QATContext(r_state)
    for names, mins, maxs in ((c_names, c_mins, c_maxs), (a_names, a_mins, a_maxs)):
        for j, name in enumerate(names):
            r_ctx.observe(name, jnp.float32(mins[j].item()), jnp.float32(maxs[j].item()))
    _assert_matches_reference(got, r_ctx.finalize().tick())
    moved = step < DELAY
    assert bool(torch.isnan(got.ranges["s1"].a_min)) == moved  # the NaN extremum, kept only while monitoring
    assert int(got.ranges["s0"].count) == 4 + moved


def test_queued_folds_apply_before_a_read():
    """`observe_many`'s folds are in place before the next read of the
    ranges (`site_quant_params`, `observe`): the same as `observe` per
    site."""
    p_state, _ = _state(step=1)
    mins, maxs = _extrema(3, 9)
    ctx, before = pqat.QATContext(p_state), pqat.QATContext(p_state)
    ctx.observe_many(SITES, mins, maxs)
    for j, name in enumerate(SITES):
        before.observe(name, mins[j], maxs[j])
    for g, w in zip(ctx.site_quant_params(SITES), before.site_quant_params(SITES)):
        _assert_bitwise(g, w, "site params")
    ctx.observe("s0", torch.tensor(-9.0), torch.tensor(9.0))
    before.observe("s0", torch.tensor(-9.0), torch.tensor(9.0))
    _assert_states_bitwise(ctx.finalize(), before.finalize())


@pytest.mark.parametrize("phase", ["monitor", "quant"])
def test_ema_monitor_keeps_the_per_site_fold(phase):
    p_state, r_state = _state(step=1 if phase == "monitor" else DELAY + 1)
    p_state = dataclasses.replace(p_state, config=dataclasses.replace(p_state.config, monitor="ema"))
    r_state = dataclasses.replace(r_state, config=dataclasses.replace(r_state.config, monitor="ema"))
    mins, maxs = _extrema(4, 9)
    ctx, before, r_ctx = pqat.QATContext(p_state), pqat.QATContext(p_state), rqat.QATContext(r_state)
    ctx.observe_many(SITES, mins, maxs, tick=True)
    for j, name in enumerate(SITES):
        before.observe(name, mins[j], maxs[j])
        r_ctx.observe(name, jnp.float32(mins[j].item()), jnp.float32(maxs[j].item()))
    _assert_states_bitwise(ctx.finalize(), before.finalize().tick())
    _assert_matches_reference(ctx.finalize(), r_ctx.finalize().tick())


def test_a_read_only_context_folds_nothing():
    p_state, _ = _state(step=0)
    ctx = pqat.QATContext(p_state, fold=False)
    ctx.observe("s0", torch.tensor(-99.0), torch.tensor(99.0))
    ctx.observe_many(SITES, *_extrema(5, 9))
    x = torch.linspace(-50, 50, 12).reshape(3, 4)
    assert torch.equal(ctx.site("s0", x), pqat.QATContext(p_state).site("s0", x))
    _assert_states_bitwise(ctx.finalize(), p_state)


def test_disabled_qat_folds_and_ticks_as_before():
    p_state, _ = _state(step=2)
    p_state = dataclasses.replace(p_state, config=pqat.QATConfig(enabled=False))
    ctx = pqat.QATContext(p_state)
    ctx.observe_many(SITES, *_extrema(6, 9), tick=True)
    _assert_states_bitwise(ctx.finalize(), p_state.tick())


def test_the_new_calls_read_nothing_on_the_host(monkeypatch):
    """What a CUDA graph capture forbids (a host read of a tensor) is
    caught here on the CPU: the batched fold, its tick and the site
    operands read the phase and the ranges on the device."""
    p_state, _ = _state(step=1)
    mins, maxs = _extrema(7, 9)

    def refuse(*a, **k):
        raise AssertionError("a tensor was read on the host")

    for name in ("__bool__", "__int__", "__float__", "item", "tolist"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    ctx = ddpg._qat_context(p_state)
    ctx.observe_many(SITES, mins, maxs)
    deltas, _ = ctx.site_quant_params(SITES)
    ctx.observe_many(SITES[:3], mins[:3], maxs[:3], tick=True)
    state = ctx.finalize()
    monkeypatch.undo()
    assert deltas.shape == (9,) and int(state.step) == 2


@pytest.mark.parametrize("first", ["repro_torch.core.qat", "repro_torch.kernels.quantize", "repro_torch.rl.ddpg"])
def test_core_loads_no_kernel_module(first):
    """`core` is the lowest layer: `core.qat` imports nothing of `kernels`
    (its caller hands a context kernel 7), whichever module loads first."""
    import subprocess
    import sys

    loads = f"import {first}, repro_torch.core.qat, repro_torch.kernels.quantize, repro_torch.rl.ddpg"
    subprocess.run([sys.executable, "-c", loads], check=True)
    alone = ("import sys, repro_torch.core.qat; "
             "assert not [m for m in sys.modules if m.startswith('repro_torch.kernels')]")
    subprocess.run([sys.executable, "-c", alone], check=True)


def test_the_kernel_wrappers_refuse_what_the_kernel_does_not_take():
    """The launch wrappers check their operands before any build or launch:
    CPU tensors, more sites or folds than the kernel holds."""
    def args(stats):
        return [s.a_min for s in stats], [s.a_max for s in stats], [s.count for s in stats]

    step = torch.tensor(0, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        qat_site_params_cuda(*args(_stats()))
    with pytest.raises(ValueError, match="CUDA"):
        qat_fold_cuda(*args(_stats()), step, [], delay=1, tick=True)
    with pytest.raises(ValueError, match="1..32 sites"):
        qat_site_params_cuda(*args(_stats(EDGES * 4)))
    stat = _stats()[:1]
    with pytest.raises(ValueError, match="at most 64 folds"):
        qat_fold_cuda(*args(stat), step, [(0, stat[0].a_min, stat[0].a_max)] * 65, delay=1, tick=True)


# --- the DDPG calls over a QAT-delay crossing --------------------------------

SPEC = locomotion.make("halfcheetah").spec


def _act_before(state, obs, *, cfg, generator):
    """`ddpg.act` before kernel 7: its context folded kernel B's extrema."""
    with torch.no_grad():
        ctx = pqat.QATContext(state.qat) if state.qat.config.enabled else None
        a = ddpg.actor_forward(state.actor, obs, ctx, backend=cfg.backend)
        a = a + cfg.exploration_sigma * torch.randn(a.shape, generator=generator, device=a.device)
        return torch.clamp(a, -1.0, 1.0)


def _update_fused_step_before(state, batch, cfg):
    """`ddpg._update_fused_step` before kernel 7 (its range evolution as
    per-site `observe` calls in two contexts, its operands per site)."""
    obs, action = batch["obs"], batch["action"]
    reward, next_obs = batch["reward"], batch["next_obs"]
    done = batch["done"].to(torch.float32)
    w = torch.ones((obs.shape[0],), dtype=torch.float32)
    deltas, zs = _site_quant_params_before(state.qat.ranges, ddpg.ACTOR_SITES + ddpg.CRITIC_SITES)
    opt_c, opt_a = fxp_adam.FxpAdamConfig(lr=cfg.critic_lr), fxp_adam.FxpAdamConfig(lr=cfg.actor_lr)
    consts_c = adam.step_constants(opt_c, state.critic_opt.step + 1)
    consts_a = adam.step_constants(opt_a, state.actor_opt.step + 1)
    wb = lambda p: ddpg._params_to_wb(p, len(ddpg.ACTOR_ACTS))  # noqa: E731
    with torch.no_grad():
        out = fxp_mlp_train_step(
            obs, action, reward, done, next_obs, w,
            wb(state.actor), wb(state.critic), wb(state.actor_target), wb(state.critic_target),
            wb(state.actor_opt.mu), wb(state.actor_opt.nu), wb(state.critic_opt.mu), wb(state.critic_opt.nu),
            deltas, zs, consts_c, consts_a, state.qat.quantized_phase,
            actor_acts=ddpg.ACTOR_ACTS, critic_acts=ddpg.CRITIC_ACTS, obs_dim=int(obs.shape[-1]),
            act_dim=int(action.shape[-1]), gamma=cfg.gamma, tau=cfg.tau, n_bits=state.qat.config.n_bits,
            qat=True, fxp32_phase1=state.qat.config.fxp32_phase1, fxp_weights=True,
        )
        qat = _fold_before(state.qat, ddpg.CRITIC_SITES, out.c_mins, out.c_maxs,
                           ddpg.ACTOR_SITES + ddpg.CRITIC_SITES, out.a_mins, out.a_maxs)
        wbp = ddpg._wb_to_params
        return ddpg.DDPGState(
            actor=wbp(out.actor), critic=wbp(out.critic), actor_target=wbp(out.actor_t),
            critic_target=wbp(out.critic_t),
            actor_opt=adam.AdamState(step=state.actor_opt.step + 1, mu=wbp(out.actor_m), nu=wbp(out.actor_v)),
            critic_opt=adam.AdamState(step=state.critic_opt.step + 1, mu=wbp(out.critic_m),
                                      nu=wbp(out.critic_v)),
            qat=qat, step=state.step + 1)


def _batch(seed, n):
    g = torch.Generator().manual_seed(seed)
    return {"obs": torch.randn(n, SPEC.obs_dim, generator=g), "action": torch.rand(n, SPEC.act_dim, generator=g) * 2 - 1,
            "reward": torch.randn(n, generator=g), "next_obs": torch.randn(n, SPEC.obs_dim, generator=g),
            "done": torch.rand(n, generator=g) < 0.1}


def test_act_and_fused_update_are_bitwise_the_code_before_across_the_delay():
    """Four updates across a QAT delay of 2 (two monitor, two quant), with
    an act before each: the actions and every leaf of the state bitwise
    what the per-site code gave."""
    from repro_torch import tree

    cfg = ddpg.DDPGConfig(backend="pallas_fused_step", qat_delay=2, batch_size=8)
    state = ddpg.init(SPEC, cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    before = state
    for t in range(4):
        obs = _batch(50 + t, 3)["obs"]
        a = ddpg.act(state, obs, cfg=cfg, generator=torch.Generator().manual_seed(t))
        a_before = _act_before(before, obs, cfg=cfg, generator=torch.Generator().manual_seed(t))
        _assert_bitwise(a, a_before, f"action {t}")
        batch = _batch(100 + t, cfg.batch_size)
        state, _ = ddpg.update(state, batch, cfg)
        before = _update_fused_step_before(before, batch, cfg)
        for (path, got), (_, want) in zip(tree.flatten_with_path(state), tree.flatten_with_path(before)):
            _assert_bitwise(got, want, f"update {t}: {path}")
    assert int(state.qat.step) == 4 and int(state.qat.ranges["actor/l0"].count) == 2
