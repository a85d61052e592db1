"""The port's window drivers, `repro_torch.rl.loop.train_device` and
`train_fused`, on the CPU (`device="cpu"`: the same timestep runs eagerly;
on the card it is a captured CUDA graph, checked by `chip_smoke.py`).

Mirrors the reference's `tests/test_loop.py`: `train_device` against
`train_host` from the same config and seed (params within 8·2⁻¹⁶, obs and
rewards rtol 1e-4 / atol 1e-5, equal buffer size and agent step; `:153`),
through the port's fused-step backend and through "jnp"; the fleet run
(`n_envs = 4`, the same asserted counts; `:180`); and `train_fused`'s
history accumulated over the whole eval window (`:81`)."""

import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.rl import ddpg, loop
from repro_torch.rl.envs import make
from repro_torch.rl.envs.base import EnvSpec, EnvState

SMALL = dict(total_steps=24, warmup_steps=8, replay_capacity=64, eval_every=12, eval_episodes=2, seed=3)
NETS = ("actor", "critic", "actor_target", "critic_target")


def _no_eval(*args):
    return torch.zeros(())


@pytest.mark.parametrize("backend", ["pallas_fused_step", "jnp"])
def test_train_device_matches_train_host(backend):
    env = make("pendulum")
    dcfg = ddpg.DDPGConfig(batch_size=8, backend=backend, qat_delay=6)
    cfg = loop.TrainConfig(n_envs=1, **SMALL)
    ts_h, _ = loop.train_host(env, cfg, dcfg, device="cpu")
    ts_d, hist = loop.train_device(env, cfg, dcfg, device="cpu", eval_fn=_no_eval)
    assert int(ts_h.agent.step) == int(ts_d.agent.step) == 17
    assert bool(ts_d.agent.qat.quantized_phase)  # the delay was crossed inside the run
    for name in NETS:
        h, d = getattr(ts_h.agent, name), getattr(ts_d.agent, name)
        for layer in h:
            for leaf in h[layer]:
                torch.testing.assert_close(d[layer][leaf], h[layer][leaf], rtol=0, atol=8 * 2.0**-16)
    torch.testing.assert_close(ts_d.obs, ts_h.obs, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(ts_d.buf.reward, ts_h.buf.reward, rtol=1e-4, atol=1e-5)
    assert int(ts_h.buf.size) == int(ts_d.buf.size) == 24
    assert hist["step"] == [12, 24]


def test_train_device_fleet_runs_and_reports():
    """n_envs > 1: every step stores a whole fleet row-batch and performs
    at most one update; history reports env-step and update throughput."""
    env = make("pendulum")
    dcfg = ddpg.DDPGConfig(qat_enabled=False, batch_size=8, backend="pallas_fused_step")
    cfg = loop.TrainConfig(n_envs=4, **SMALL)
    ts, hist = loop.train_device(env, cfg, dcfg, device="cpu", eval_fn=_no_eval)
    assert ts.obs.shape == (4, env.spec.obs_dim)
    # 24 steps x 4 lanes = 96 transitions through a 64-slot ring
    assert int(ts.buf.size) == 64
    # updates start once the buffer holds the warmup: 4 lanes a step fill
    # the 8-slot warmup after step 1, so steps 1..23 each apply one update
    assert int(ts.agent.step) == 23
    assert set(hist) == {"step", "eval_reward", "train_reward", "ips", "updates_per_s"}
    assert all(v > 0 for v in hist["ips"]) and all(v > 0 for v in hist["updates_per_s"])
    assert all(math.isfinite(v) for v in hist["train_reward"])


@dataclasses.dataclass(frozen=True)
class _CountingEnv:
    """Deterministic stub: the reward of step t is exactly t, never done,
    so the eval-window mean can be checked by hand."""

    spec: EnvSpec = EnvSpec("counting", obs_dim=3, act_dim=2, episode_length=10**6)

    def init(self, generator, n, *, device=None):
        dev = generator.device if device is None else torch.device(device)
        z = torch.zeros((n, 1), device=dev)
        return EnvState(q=z, qd=z, t=torch.zeros((n,), dtype=torch.int32, device=dev)), torch.zeros((n, 3), device=dev)

    def step(self, s, action, generator=None):
        ns = EnvState(q=s.q, qd=s.qd, t=s.t + 1)
        n = s.t.shape[0]
        return ns, torch.zeros((n, 3), device=s.q.device), s.t.to(torch.float32), torch.zeros((n,), dtype=torch.bool)


def test_train_fused_history_accumulates_across_eval_window(monkeypatch):
    """eval_every = 2 chunks of 3 steps: rewards are t = 0..5, so the
    window mean is 2.5, not the boundary chunk's 4.0."""
    monkeypatch.setattr(loop, "evaluate", lambda *a, **k: torch.zeros(()))
    env = _CountingEnv()
    cfg = loop.TrainConfig(total_steps=12, eval_every=6, warmup_steps=10**6, replay_capacity=32, eval_episodes=1)
    dcfg = ddpg.DDPGConfig(qat_enabled=False, batch_size=4)
    _, history = loop.train_fused(env, cfg, dcfg, chunk=3, device="cpu")
    assert history["step"] == [6, 12]
    np.testing.assert_allclose(history["train_reward"][0], 2.5, rtol=1e-6)
    np.testing.assert_allclose(history["train_reward"][1], 8.5, rtol=1e-6)
    assert all(v > 0 for v in history["ips"])


def test_train_config_normalization_single_path():
    """Every surface lands on the same frozen TrainConfig, with the
    reference's fields and defaults."""
    base = loop.TrainConfig(total_steps=7, chunk=3)
    assert (base.eval_every, base.eval_episodes, loop.TrainConfig().chunk) == (5_000, 10, 1000)
    assert loop.as_train_config(base) is base
    assert loop.as_train_config(None) == loop.TrainConfig()
    assert loop.as_train_config({"total_steps": 7, "chunk": 3}) == base
    duck = dataclasses.make_dataclass("Duck", [("total_steps", int, 7), ("chunk", int, 3)])()
    assert loop.as_train_config(duck) == base
    assert loop.as_train_config(base, chunk=5).chunk == 5
    assert loop.as_train_config(base, chunk=None).chunk == 3
    with pytest.raises(dataclasses.FrozenInstanceError):
        base.chunk = 9


def test_train_device_evaluates_each_window_by_default():
    """Without eval_fn, each window ends with `evaluate` (the paper's
    protocol) and nothing runs as a graph on the CPU."""
    env = make("pendulum", episode_length=5)
    dcfg = ddpg.DDPGConfig(batch_size=4, backend="pallas_fused_step", qat_delay=2)
    cfg = loop.TrainConfig(total_steps=6, warmup_steps=3, replay_capacity=16, eval_every=3, eval_episodes=2)
    before = loop.train_device.graph_replays
    ts, hist = loop.train_device(env, cfg, dcfg, device="cpu")
    assert hist["step"] == [3, 6] and all(math.isfinite(v) for v in hist["eval_reward"])
    assert int(ts.agent.step) == 4 and loop.train_device.graph_replays == before


def test_the_device_rule():
    env = make("pendulum")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            loop.train_device(env, loop.TrainConfig(total_steps=1), ddpg.DDPGConfig(backend="pallas_fused_step"))


class _NoHostReads:
    """Inside, reading a tensor's value on the host raises: what a CUDA
    graph capture forbids (it would synchronise), caught here on the CPU."""

    NAMES = ("__bool__", "__int__", "__float__", "item", "tolist")

    def __enter__(self):
        self.saved = {n: getattr(torch.Tensor, n) for n in self.NAMES}

        def refuse(self_, *a, **k):
            raise AssertionError("a tensor was read on the host")

        for n in self.NAMES:
            setattr(torch.Tensor, n, refuse)
        return self

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(torch.Tensor, n, fn)
        return False


def test_the_timestep_pieces_read_nothing_on_the_host():
    """What `train_device` captures, piece by piece, on CPU tensors: noise,
    the env fleet step with its resets, replay store and sample (the cursor
    and size are device tensors, the sample's bound too), the QAT site
    operands and range evolution, Adam's step constants, and the phase a
    kernel launch takes (the device flag, not a host bool)."""
    from repro_torch.core.qat import QATContext
    from repro_torch.optim import adam
    from repro_torch.rl import replay
    from repro_torch.rl.envs.base import step_fleet

    env = make("halfcheetah")
    dcfg = ddpg.DDPGConfig(batch_size=8, backend="pallas_fused_step", qat_delay=1)
    cfg = loop.TrainConfig(total_steps=4, warmup_steps=2, replay_capacity=16, n_envs=2)
    ts = loop.init_train_state(env, cfg, dcfg, device="cpu")
    proc = loop._noise_proc(cfg, dcfg)
    assert isinstance(ts.buf.ptr, torch.Tensor) and isinstance(ts.buf.size, torch.Tensor)
    with _NoHostReads():
        nz, eps = proc.sample(ts.noise, ts.gen)
        action = torch.clamp(eps, -1.0, 1.0)
        env_state, next_obs, reward, done = step_fleet(env, ts.env_state, action, generator=ts.env_gen)
        buf = replay.add_batch(ts.buf, {"obs": ts.obs, "action": action, "reward": reward, "next_obs": next_obs,
                                        "done": done})
        batch = replay.sample(buf, ts.gen, dcfg.batch_size)
        ctx = QATContext(ts.agent.qat)
        phase = ctx.quant_operand
        deltas, zs = ctx.site_quant_params(ddpg.ACTOR_SITES + ddpg.CRITIC_SITES)
        ctx.observe("critic/l0", batch["obs"].min(), batch["obs"].max())
        ctx.finalize().tick()
        adam.step_constants(adam.AdamConfig(), ts.agent.actor_opt.step + 1)
    assert isinstance(phase, torch.Tensor) and phase.dtype == torch.bool
    assert QATContext(ts.agent.qat, True).quant_operand is True
    assert int(buf.size) == 2 and int(buf.ptr) == 2 and batch["obs"].shape == (8, env.spec.obs_dim)
    assert deltas.shape == zs.shape == (6,)
