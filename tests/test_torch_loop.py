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
import _torch_threads  # noqa: E402,F401  (one intra-op thread a worker)

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
    """`learner=` and `observability=` are ported: a value without their
    surface (`load_state` / `run_update` / `state`; `tracer` /
    `ensure_server` / `flush`) raises; without a card and without a device
    the loop raises (the device rule)."""
    env = make("pendulum")
    cfg, dcfg = loop.TrainConfig(total_steps=1), ddpg.DDPGConfig()
    with pytest.raises(AttributeError, match="load_state"):
        loop.train_host(env, cfg, dcfg, device="cpu", learner=object())
    with pytest.raises(AttributeError, match="tracer"):
        loop.train_host(env, cfg, dcfg, device="cpu", observability=object())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            loop.train_host(env, cfg, dcfg)


# --------------------------------------------------------------------- #
# train_host(learner=, observability=)
# --------------------------------------------------------------------- #

LEARNER_RUN = dict(total_steps=10, warmup_steps=4, replay_capacity=64, n_envs=1)


@pytest.mark.parametrize("mode", ["jnp", "fused", "fused_step"])
def test_train_host_through_a_learner_is_bitwise_the_direct_loop(mode):
    """A learner forced to the mode of `dcfg.backend`, at a batch size that
    is one of its buckets, ends `train_host` on the same agent, bitwise, as
    the loop's own `ddpg.update` (the paper's nets, the kernels' plain
    versions, the QAT delay crossed)."""
    from repro_torch import tree
    from repro_torch.runtime.engine import BatcherConfig
    from repro_torch.train.learner import TRAIN_BACKENDS, LearnerEngine

    env = make(SMOKE.env)
    dcfg = dataclasses.replace(SMOKE.ddpg, batch_size=8, backend=TRAIN_BACKENDS[mode], qat_delay=3)
    cfg = loop.TrainConfig(**LEARNER_RUN)
    want, _ = loop.train_host(env, cfg, dcfg, device="cpu")
    seed_state = ddpg.init(env.spec, dcfg, generator=torch.Generator().manual_seed(99), device="cpu")
    learner = LearnerEngine.from_ddpg(seed_state, dcfg, force_mode=mode, batcher=BatcherConfig(buckets=(8, 32)))
    got, _ = loop.train_host(env, cfg, dcfg, device="cpu", learner=learner)
    assert bool(got.agent.qat.quantized_phase)
    for (path, a), (_, b) in zip(tree.flatten_with_path(got.agent), tree.flatten_with_path(want.agent)):
        assert torch.equal(a, b), path
    assert torch.equal(got.buf.reward, want.buf.reward) and torch.equal(got.obs, want.obs)


def test_train_host_streams_updates_through_learner():
    """The reference's checks (`tests/test_loop.py`): every post-warmup
    step streams one update through the engine, and the loop's final agent
    is the engine's state."""
    from repro_torch.runtime.engine import BatcherConfig
    from repro_torch.train.learner import LearnerEngine

    env = make("pendulum")
    cfg = loop.TrainConfig(total_steps=6, warmup_steps=2, replay_capacity=32, eval_every=10**6)
    dcfg = ddpg.DDPGConfig(qat_enabled=False, batch_size=8)
    seed_state = ddpg.init(env.spec, dcfg, generator=torch.Generator().manual_seed(0), device="cpu")
    learner = LearnerEngine.from_ddpg(seed_state, dcfg, force_mode="jnp", batcher=BatcherConfig(buckets=(8, 16)))
    ts, info = loop.train_host(env, cfg, dcfg, device="cpu", learner=learner)
    st = learner.stats()
    assert st["updates"] == int(ts.agent.step) > 0
    assert st["transitions"] == st["updates"] * dcfg.batch_size
    assert st["mode_histogram"] == {"train": {"jnp": st["updates"]}}
    assert ts.agent is learner.state
    assert info["times"]["accelerator"] > 0


def test_train_host_observability_traces_serves_and_flushes(tmp_path):
    """`observability=`: its tracer takes the loop's spans (and the
    learner's, on one bundle), its HTTP endpoint is up while training, and
    the trace lands at its path when the loop ends."""
    import json
    import urllib.error
    import urllib.request

    from repro_torch.obs import Observability, read_jsonl
    from repro_torch.runtime.engine import BatcherConfig
    from repro_torch.train.learner import LearnerEngine

    env = make("pendulum")
    cfg = loop.TrainConfig(total_steps=5, warmup_steps=2, replay_capacity=32)
    dcfg = ddpg.DDPGConfig(batch_size=8, backend="jnp", qat_delay=2)
    path = tmp_path / "trace.jsonl"
    obs = Observability.tracing(path, serve_http=0)
    seen = {}
    try:
        seed_state = ddpg.init(env.spec, dcfg, generator=torch.Generator().manual_seed(0), device="cpu")
        learner = LearnerEngine.from_ddpg(seed_state, dcfg, force_mode="jnp", batcher=BatcherConfig(buckets=(8,)),
                                          obs=obs)

        def update_and_scrape(batch):
            out = run_update(batch)
            try:
                with urllib.request.urlopen(obs.server.url + "/healthz", timeout=5.0) as r:
                    seen["healthz"] = json.loads(r.read())
            except urllib.error.HTTPError as err:  # 503: the uncalibrated cost model's drift
                seen["healthz"] = json.loads(err.read())
            return out

        run_update, learner.run_update = learner.run_update, update_and_scrape
        loop.train_host(env, cfg, dcfg, device="cpu", learner=learner, observability=obs)
        names = [e["name"] for e in read_jsonl(path)]
    finally:
        obs.close()
    assert names.count("loop.act") == names.count("loop.update") == cfg.total_steps
    assert names.count("learner.launch") == 4 and "learner.block_until_ready" in names  # updates from step 1
    assert seen["healthz"]["checks"]["learner"]["updates"] >= 1
