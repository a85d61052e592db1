"""The port's host training loop, `repro_torch.rl.loop.train_host`, on the
CPU with `configs/fixar_ddpg.SMOKE` cut short (pendulum, B = 32, the
paper's 400-300 nets, 12 steps): it runs end to end through the "pallas"
backend's plain versions, updates start
once the buffer holds `warmup_steps` transitions, the QAT phase flips after
`qat_delay` updates, the Fig.-9 `times` and trace spans are there, and
`evaluate` returns a finite scalar.  The reference's loop draws from JAX
keys, so the two loops are compared by their counts, not their numbers."""

import dataclasses
import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.fixar_ddpg import SMOKE
from repro_torch.obs import Tracer
from repro_torch.rl import ddpg, loop
from repro_torch.rl.envs import make
from repro_torch.serve.policy import PolicyEngine

SMALL = dict(total_steps=12, warmup_steps=4, replay_capacity=64, n_envs=1)


@pytest.fixture(scope="module")
def trained():
    env = make(SMOKE.env)
    dcfg = dataclasses.replace(SMOKE.ddpg, backend="pallas", qat_delay=3)
    tracer = Tracer()
    ts, info = loop.train_host(env, loop.TrainConfig(**SMALL), dcfg, device="cpu", tracer=tracer)
    return env, dcfg, ts, info, tracer


def test_updates_start_at_warmup_and_the_phase_flips(trained):
    _, _, ts, info, _ = trained
    n_updates = SMALL["total_steps"] - SMALL["warmup_steps"] + 1
    assert int(ts.agent.step) == int(ts.agent.actor_opt.step) == int(ts.agent.qat.step) == n_updates
    assert bool(ts.agent.qat.quantized_phase)
    # monitor-phase updates captured ranges at every site
    assert all(int(r.count) > 0 for r in ts.agent.qat.ranges.values())
    assert ts.buf.size == SMALL["total_steps"] and ts.obs.shape == (1, 3)
    assert info["total_steps"] == SMALL["total_steps"]
    assert set(info["times"]) == {"env", "runtime", "accelerator"}
    assert all(v > 0 for v in info["times"].values())


def test_trace_spans_per_step(trained):
    *_, tracer = trained
    names = [e["name"] for e in tracer.events()]
    for span in ("loop.act", "loop.env", "loop.replay", "loop.update"):
        assert names.count(span) == SMALL["total_steps"], span


def test_evaluate_returns_a_scalar_and_the_actor_serves(trained):
    env, dcfg, ts, _, _ = trained
    r = loop.evaluate(env, ts.agent, dcfg, torch.Generator().manual_seed(0), n_episodes=2)
    assert r.shape == () and math.isfinite(float(r))
    engine = PolicyEngine.from_ddpg(ts.agent, device="cpu", force_mode="fused")
    assert engine.frozen is not None and engine.frozen.quantized
    obs = torch.randn(5, 3).numpy()
    got = engine.run_batch(obs)
    want = ddpg.act(ts.agent, torch.from_numpy(obs), cfg=dcfg)
    torch.testing.assert_close(torch.from_numpy(got), want, rtol=1e-5, atol=1e-6)
    engine.close()


def test_fleet_and_config_normalisation():
    env = make("pendulum")
    dcfg = ddpg.DDPGConfig(batch_size=4, backend="jnp", qat_enabled=False)
    cfg = loop.as_train_config({"total_steps": 3, "warmup_steps": 2, "replay_capacity": 16, "n_envs": 3})
    assert loop.as_train_config(cfg) is cfg
    ts, _ = loop.train_host(env, cfg, dcfg, device="cpu")
    # 3 lanes a step meet the warmup of 2 at the first step: an update every step
    assert ts.buf.size == 9 and int(ts.agent.step) == 3 and ts.obs.shape == (3, 3)


def test_unported_options_and_the_device_rule_raise():
    env = make("pendulum")
    cfg, dcfg = loop.TrainConfig(total_steps=1), ddpg.DDPGConfig()
    with pytest.raises(NotImplementedError, match="learner"):
        loop.train_host(env, cfg, dcfg, device="cpu", learner=object())
    with pytest.raises(NotImplementedError, match="observability"):
        loop.train_host(env, cfg, dcfg, device="cpu", observability=object())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            loop.train_host(env, cfg, dcfg)
