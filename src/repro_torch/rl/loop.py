"""FIXAR's end-to-end DRL loop, the operation sequence of Fig. 3 (port of
the host driver of `repro.rl.loop`).

`train_host` is the paper-faithful loop: each timestep acts (actor forward
plus exploration noise), steps the env fleet, stores the fleet's
transitions and samples a batch from replay, then runs one `ddpg.update`
once the buffer holds `warmup_steps` transitions.  It times the three
Fig.-9 segments — env, runtime (replay and transfer) and accelerator (act
and update) — each ended by a `torch.cuda.synchronize()` on the card, and
emits them as `loop.*` trace spans when given a tracer.  Env fleet, replay
and agent all live on the loop's device.

Not ported yet (`ROADMAP.md`): the `lax.scan` window drivers
`train_device`/`train_fused`, whose PyTorch counterpart is a CUDA-graph-
captured window; `learner=` (the learner engine) and `observability=`
(the fleet telemetry bundle) raise.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.rl import ddpg, replay
from repro_torch.rl.envs.base import EnvState, env_init, init_fleet, step_fleet
from repro_torch.rl.noise import NoiseProcess, NoiseState

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The host loop's config: the reference's `TrainConfig` without the
    fields of what is not ported (`eval_every`/`eval_episodes`, read by no
    driver here, and the window drivers' `chunk`)."""

    total_steps: int = 10_000
    warmup_steps: int = 1_000  # env steps before updates start
    replay_capacity: int = 100_000
    n_envs: int = 1
    seed: int = 0
    noise_kind: str = "gaussian"  # rl/noise process: gaussian|ou|none
    noise_sigma: Optional[float] = None  # None -> dcfg.exploration_sigma


def as_train_config(cfg=None) -> TrainConfig:
    """Normalize onto `TrainConfig`: pass-through for a `TrainConfig`,
    a copy of its fields for a duck-typed config object (the reference's
    `TrainConfig` among them), kwargs for a dict, defaults for None."""
    if cfg is None:
        cfg = TrainConfig()
    elif isinstance(cfg, dict):
        cfg = TrainConfig(**cfg)
    elif not isinstance(cfg, TrainConfig):
        names = (f.name for f in dataclasses.fields(TrainConfig))
        cfg = TrainConfig(**{n: getattr(cfg, n) for n in names if hasattr(cfg, n)})
    return cfg


def _noise_proc(cfg: TrainConfig, dcfg: ddpg.DDPGConfig) -> NoiseProcess:
    sigma = dcfg.exploration_sigma if cfg.noise_sigma is None else cfg.noise_sigma
    return NoiseProcess(kind=cfg.noise_kind, sigma=sigma)


@dataclasses.dataclass
class TrainState:
    agent: ddpg.DDPGState
    env_state: EnvState  # fleet-batched (leading n_envs axis)
    obs: Tensor  # (n_envs, obs_dim)
    buf: replay.ReplayBuffer
    noise: NoiseState  # (n_envs, act_dim) exploration carry
    env_gen: torch.Generator  # env initial states, resets, observation noise
    gen: torch.Generator  # exploration noise, replay sampling


def init_train_state(env, cfg: TrainConfig, dcfg: ddpg.DDPGConfig, *, device: DeviceLike = None) -> TrainState:
    """Agent, fleet, replay and noise on `device` (the card unless "cpu"),
    every random draw from generators seeded by `cfg.seed`."""
    cfg = as_train_config(cfg)
    dev = resolve_device(device)
    agent = ddpg.init(env.spec, dcfg, generator=torch.Generator().manual_seed(cfg.seed), device=dev)
    n = max(cfg.n_envs, 1)
    env_gen = torch.Generator(device=dev).manual_seed(cfg.seed + 1)
    env_state, obs = init_fleet(env, env_gen, n, device=dev)
    buf = replay.init(cfg.replay_capacity, env.spec.obs_dim, env.spec.act_dim, device=dev)
    nz = _noise_proc(cfg, dcfg).init((n, env.spec.act_dim), device=dev)
    gen = torch.Generator(device=dev).manual_seed(cfg.seed + 2)
    return TrainState(agent=agent, env_state=env_state, obs=obs, buf=buf, noise=nz, env_gen=env_gen, gen=gen)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def train_host(
    env,
    cfg: TrainConfig,
    dcfg: ddpg.DDPGConfig,
    *,
    device: DeviceLike = None,
    learner=None,
    tracer=None,
    observability=None,
) -> tuple[TrainState, dict[str, Any]]:
    """Paper-faithful host loop with the Fig.-9 timing breakdown (module
    docstring).  `tracer` (an `obs.Tracer`), when enabled, gets one span
    per segment and timestep: `loop.act`, `loop.env`, `loop.replay` and
    `loop.update`.

    Returns (final TrainState, {"times": {env, runtime, accelerator}
    seconds, "total_steps"})."""
    if learner is not None:
        raise NotImplementedError("learner= (the learner engine) is not ported yet: ROADMAP.md Queue 2")
    if observability is not None:
        raise NotImplementedError("observability= (fleet telemetry) is not ported yet: ROADMAP.md Queue 2")
    cfg = as_train_config(cfg)
    ts = init_train_state(env, cfg, dcfg, device=device)
    dev = ts.obs.device
    proc = _noise_proc(cfg, dcfg)
    times = {"env": 0.0, "runtime": 0.0, "accelerator": 0.0}
    agent, env_state, obs, buf, nz = ts.agent, ts.env_state, ts.obs, ts.buf, ts.noise
    for step in range(cfg.total_steps):
        t0 = time.perf_counter()
        # 1. actor forward (inference) + exploration noise  [FPGA FP + PRNG]
        nz, eps = proc.sample(nz, ts.gen)
        action = ddpg.act(agent, obs, cfg=dcfg, noise=eps)
        _sync(dev)
        t1 = time.perf_counter()

        # 2. environment transition (the fleet)             [host CPU in paper]
        env_state, next_obs, reward, done = step_fleet(env, env_state, action, generator=ts.env_gen)
        _sync(dev)
        t2 = time.perf_counter()

        # 3. store the fleet's transitions, 4. sample a batch [replay memory]
        buf = replay.add_batch(
            buf, {"obs": obs, "action": action, "reward": reward, "next_obs": next_obs, "done": done}
        )
        batch = replay.sample(buf, ts.gen, dcfg.batch_size)
        _sync(dev)
        t3 = time.perf_counter()

        # 5. critic/actor BP+WU                              [FPGA training]
        if buf.size >= cfg.warmup_steps:
            agent, _ = ddpg.update(agent, batch, dcfg)
            _sync(dev)
        t4 = time.perf_counter()

        times["accelerator"] += (t1 - t0) + (t4 - t3)
        times["env"] += t2 - t1
        times["runtime"] += t3 - t2
        if tracer is not None and tracer.enabled:
            tracer.complete("loop.act", t0, t1, cat="loop", step=step)
            tracer.complete("loop.env", t1, t2, cat="loop", step=step)
            tracer.complete("loop.replay", t2, t3, cat="loop", step=step)
            if t4 > t3:
                tracer.complete("loop.update", t3, t4, cat="loop", step=step)
        obs = next_obs

    ts = dataclasses.replace(ts, agent=agent, env_state=env_state, obs=obs, buf=buf, noise=nz)
    return ts, {"times": times, "total_steps": cfg.total_steps}


def evaluate(env, agent: ddpg.DDPGState, dcfg: ddpg.DDPGConfig, generator: torch.Generator,
             n_episodes: int = 10) -> Tensor:
    """Paper protocol: mean cumulative reward over `n_episodes` random
    starts (drawn from `generator`), accumulating until the agent falls
    (done) or the episode ends.  The episodes run as one fleet, without
    reset or exploration; returns a 0-d tensor."""
    dev = agent.step.device
    with torch.no_grad():
        env_state, obs = env_init(env, generator, n_episodes, device=dev)
        total = torch.zeros((n_episodes,), dtype=torch.float32, device=dev)
        alive = torch.ones((n_episodes,), dtype=torch.float32, device=dev)
        for _ in range(env.spec.episode_length):
            action = ddpg.act(agent, obs, cfg=dcfg)
            env_state, obs, r, done = step_fleet(env, env_state, action, generator=generator, autoreset=False)
            total = total + r * alive
            alive = alive * (1.0 - done.to(torch.float32))
        return total.mean()


__all__ = ["TrainConfig", "as_train_config", "TrainState", "init_train_state", "train_host", "evaluate"]
