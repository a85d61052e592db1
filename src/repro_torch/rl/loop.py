"""FIXAR's end-to-end DRL loop, the operation sequence of Fig. 3 (port of
`repro.rl.loop`).

Every driver runs the same timestep: act (actor forward plus exploration
noise), step the env fleet, store the fleet's transitions, sample a batch
from replay, and run one `ddpg.update` once the buffer holds
`warmup_steps` transitions.  Env fleet, replay and agent all live on the
loop's device, and whether a step updates is known on the host: the
buffer holds min(steps · n_envs, capacity) transitions.

* `train_host` is the paper-faithful loop.  It times the three Fig.-9
  segments — env, runtime (replay and transfer) and accelerator (act and
  update) — each ended by a `torch.cuda.synchronize()` on the card, and
  emits them as `loop.*` trace spans when given a tracer.
* `train_device` runs the reference's device-resident driver (one
  `lax.scan` per eval window there): on the card, the first updating
  timestep runs eagerly, the second is captured once as a CUDA graph, and
  that graph is replayed for every later updating timestep of every
  window; the host reads back only each window's scalars and evaluates
  between windows.  The warmup steps run eagerly.  A graph needs fixed
  addresses, so each step's new state is copied into one static
  `TrainState`, and the loop's generators are registered with the graph so
  every replay draws fresh numbers.  Capture needs an update that reads
  nothing on the host: on the card `train_device` takes
  `backend="pallas_fused_step"` (kernels 4 and 5) and raises for the
  others, and a capture that fails raises; it never falls back to eager
  steps.  On the CPU (`device="cpu"`) the same timestep runs eagerly, for
  every backend.
* `train_fused` is the reference's chunked driver over the same windows.

Only `train_host` takes a learner engine (`learner=`) and a telemetry
bundle (`observability=`), as in the reference: the window drivers'
captured timestep reads nothing on the host, and a learner's queue holds
host arrays.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

import torch

from repro_torch import tree
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.rl import ddpg, replay
from repro_torch.rl.envs.base import EnvState, env_init, init_fleet, step_fleet
from repro_torch.rl.noise import NoiseProcess, NoiseState

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """One config for every training driver (`train_host`, `train_device`,
    `train_fused`), the reference's fields and defaults."""

    total_steps: int = 10_000
    warmup_steps: int = 1_000  # env steps before updates start
    replay_capacity: int = 100_000
    eval_every: int = 5_000  # paper: evaluate every 5000 timesteps
    eval_episodes: int = 10  # paper: 10 random starts
    n_envs: int = 1
    seed: int = 0
    chunk: int = 1000  # train_fused window length
    noise_kind: str = "gaussian"  # rl/noise process: gaussian|ou|none
    noise_sigma: Optional[float] = None  # None -> dcfg.exploration_sigma


# Deprecated alias (pre-redesign name), kept as the reference keeps it: the
# same class, so old constructor kwargs work and isinstance checks hold.
LoopConfig = TrainConfig


def as_train_config(cfg=None, **overrides) -> TrainConfig:
    """Normalize onto `TrainConfig`: pass-through for a `TrainConfig`,
    a copy of its fields for a duck-typed config object (the reference's
    `TrainConfig` among them), kwargs for a dict, defaults for None.
    `overrides` are per-call kwargs (`train_fused(chunk=...)`); only those
    not None win."""
    if cfg is None:
        cfg = TrainConfig()
    elif isinstance(cfg, dict):
        cfg = TrainConfig(**cfg)
    elif not isinstance(cfg, TrainConfig):
        names = (f.name for f in dataclasses.fields(TrainConfig))
        cfg = TrainConfig(**{n: getattr(cfg, n) for n in names if hasattr(cfg, n)})
    live = {k: v for k, v in overrides.items() if v is not None}
    return dataclasses.replace(cfg, **live) if live else cfg


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


def _updates_at(step: int, cfg: TrainConfig) -> bool:
    """Does timestep `step` (from 0) update?  The buffer then holds
    min((step + 1) · n_envs, capacity) transitions: known on the host."""
    return min((step + 1) * max(cfg.n_envs, 1), cfg.replay_capacity) >= cfg.warmup_steps


def _timestep(ts: TrainState, env, proc: NoiseProcess, dcfg: ddpg.DDPGConfig, update: bool,
              mark: Callable[[], None] = lambda: None,
              update_fn: Optional[Callable[[ddpg.DDPGState, dict], ddpg.DDPGState]] = None
              ) -> tuple[TrainState, Tensor]:
    """One FIXAR timestep (module docstring), the one every driver runs;
    returns the new state and the fleet's rewards.  Reads nothing on the
    host unless `update_fn` does.  `mark` is called after each of the
    Fig.-9 segments that ran: act, env, replay, and the update when there
    is one.  `update_fn(agent, batch) -> agent` replaces `ddpg.update`
    (`train_host` passes its learner's)."""
    # 1. actor forward (inference) + exploration noise  [FPGA FP + PRNG]
    nz, eps = proc.sample(ts.noise, ts.gen)
    action = ddpg.act(ts.agent, ts.obs, cfg=dcfg, noise=eps)
    mark()
    # 2. environment transition (the fleet)             [host CPU in paper]
    env_state, next_obs, reward, done = step_fleet(env, ts.env_state, action, generator=ts.env_gen)
    mark()
    # 3. store the fleet's transitions, 4. sample a batch [replay memory]
    buf = replay.add_batch(
        ts.buf, {"obs": ts.obs, "action": action, "reward": reward, "next_obs": next_obs, "done": done}
    )
    batch = replay.sample(buf, ts.gen, dcfg.batch_size)
    mark()
    # 5. critic/actor BP+WU                              [FPGA training]
    agent = ts.agent
    if update:
        agent = ddpg.update(agent, batch, dcfg)[0] if update_fn is None else update_fn(agent, batch)
        mark()
    return dataclasses.replace(ts, agent=agent, env_state=env_state, obs=next_obs, buf=buf, noise=nz), reward


class _Window:
    """Runs timesteps on one static `TrainState` (module docstring): each
    step's new state is copied into it, and on the card the updating
    timestep is captured once as a CUDA graph and replayed."""

    def __init__(self, ts: TrainState, env, cfg: TrainConfig, dcfg: ddpg.DDPGConfig):
        self.ts, self.env, self.cfg, self.dcfg = ts, env, cfg, dcfg
        self.proc = _noise_proc(cfg, dcfg)
        self.dev = ts.obs.device
        self.reward_sum = torch.zeros((), dtype=torch.float32, device=self.dev)
        self.graph = None
        self.warm = False  # an updating step has run eagerly (kernels loaded)
        if self.dev.type == "cuda":
            if dcfg.backend != "pallas_fused_step":
                raise ValueError(
                    f"train_device on the card captures the updating timestep as a CUDA graph, which needs "
                    f"backend='pallas_fused_step' (backend={dcfg.backend!r} reads the QAT phase on the host); "
                    "pass device='cpu' to run it eagerly"
                )

    def _step(self, update: bool) -> None:
        new, reward = _timestep(self.ts, self.env, self.proc, self.dcfg, update)
        pairs = [(d, s) for d, s in zip(tree.leaves(self.ts), tree.leaves(new)) if d is not s]
        # one multi-tensor copy per dtype, not one copy kernel per leaf
        groups: dict = {}
        for d, s in pairs:
            groups.setdefault(d.dtype, ([], []))
            groups[d.dtype][0].append(d)
            groups[d.dtype][1].append(s)
        for dsts, srcs in groups.values():
            torch._foreach_copy_(dsts, srcs)
        self.reward_sum.add_(reward.to(torch.float32).mean())

    def _capture(self) -> None:
        graph = torch.cuda.CUDAGraph()
        for gen in (self.ts.gen, self.ts.env_gen):
            graph.register_generator_state(gen)
        with torch.cuda.graph(graph):
            self._step(update=True)
        self.graph = graph

    def run(self, first: int, steps: int) -> tuple[Tensor, int]:
        """Timesteps first .. first + steps − 1; returns (the sum of the
        steps' mean rewards, on the device; the number of updates)."""
        self.reward_sum.zero_()
        updates = 0
        for step in range(first, first + steps):
            update = _updates_at(step, self.cfg)
            updates += update
            if self.dev.type != "cuda" or not update or not self.warm:
                self._step(update)
                self.warm = self.warm or update
                continue
            if self.graph is None:
                self._capture()  # records the step; the replay below runs it
            self.graph.replay()
            train_device.graph_replays += 1
        return self.reward_sum, updates


def _eval_generator(cfg: TrainConfig, steps_done: int, dev: torch.device) -> torch.Generator:
    return torch.Generator(device=dev).manual_seed(cfg.seed + 7 + steps_done)


def train_device(
    env,
    cfg: Optional[TrainConfig] = None,
    dcfg: Optional[ddpg.DDPGConfig] = None,
    *,
    device: DeviceLike = None,
    eval_fn: Optional[Callable] = None,
) -> tuple[TrainState, dict[str, Any]]:
    """Device-resident training (module docstring): one window of
    `cfg.eval_every` timesteps at a time, evaluated after each.  History
    per window: `step`, `eval_reward`, `train_reward` (the window's mean
    fleet reward), `ips` (env steps/s = window · n_envs / wall) and
    `updates_per_s` (updates / wall).  `train_device.graph_replays` counts
    the timesteps that ran as graph replays, in this driver and in
    `train_fused` (never on the CPU)."""
    cfg = as_train_config(cfg)
    dcfg = ddpg.DDPGConfig() if dcfg is None else dcfg
    ts = init_train_state(env, cfg, dcfg, device=device)
    win = _Window(ts, env, cfg, dcfg)
    evaluator = evaluate if eval_fn is None else eval_fn
    history = {"step": [], "eval_reward": [], "train_reward": [], "ips": [], "updates_per_s": []}
    steps_done = 0
    while steps_done < cfg.total_steps:
        window = min(cfg.eval_every, cfg.total_steps - steps_done)
        t0 = time.perf_counter()
        reward_sum, updates = win.run(steps_done, window)
        reward = float(reward_sum) / window  # the window's one read of the device
        dt = time.perf_counter() - t0
        steps_done += window
        ev = evaluator(env, win.ts.agent, dcfg, _eval_generator(cfg, steps_done, win.dev), cfg.eval_episodes)
        history["step"].append(steps_done)
        history["eval_reward"].append(float(ev))
        history["train_reward"].append(reward)
        history["ips"].append(window * max(cfg.n_envs, 1) / dt)
        history["updates_per_s"].append(updates / dt)
    return win.ts, history


train_device.graph_replays = 0


def train_fused(
    env,
    cfg: TrainConfig,
    dcfg: ddpg.DDPGConfig,
    eval_fn: Optional[Callable] = None,
    chunk: Optional[int] = None,
    *,
    device: DeviceLike = None,
) -> tuple[TrainState, dict[str, Any]]:
    """The reference's chunked driver over the same windows as
    `train_device`, `cfg.chunk` timesteps at a time (`chunk` overrides it).
    History per eval window (every `cfg.eval_every` steps), accumulated
    over all of the window's chunks: `step`, `eval_reward`, `train_reward`,
    `ips`."""
    cfg = as_train_config(cfg, chunk=chunk)
    ts = init_train_state(env, cfg, dcfg, device=device)
    win = _Window(ts, env, cfg, dcfg)
    evaluator = evaluate if eval_fn is None else eval_fn
    history = {"step": [], "eval_reward": [], "train_reward": [], "ips": []}
    steps_done = 0
    win_reward, win_chunks, win_steps, win_secs = 0.0, 0, 0, 0.0
    while steps_done < cfg.total_steps:
        t0 = time.perf_counter()
        reward_sum, _ = win.run(steps_done, cfg.chunk)
        mean_r = float(reward_sum) / cfg.chunk
        dt = time.perf_counter() - t0
        steps_done += cfg.chunk
        win_reward += mean_r
        win_chunks += 1
        win_steps += cfg.chunk * max(cfg.n_envs, 1)
        win_secs += dt
        if steps_done % cfg.eval_every < cfg.chunk:
            ev = evaluator(env, win.ts.agent, dcfg, _eval_generator(cfg, steps_done, win.dev), cfg.eval_episodes)
            history["step"].append(steps_done)
            history["eval_reward"].append(float(ev))
            history["train_reward"].append(win_reward / win_chunks)
            history["ips"].append(win_steps / win_secs)
            win_reward, win_chunks, win_steps, win_secs = 0.0, 0, 0, 0.0
    return win.ts, history


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
    docstring).

    `learner` (optional) is a `train.learner.LearnerEngine` (or anything
    with its `load_state` / `run_update` / `state` surface): the freshly
    initialized agent is installed into it, and every update copies the
    sampled batch to host numpy arrays and streams it through
    `learner.run_update` — bucket padding, train-phase dispatch and the
    learner's metrics included — instead of the loop's own `ddpg.update`.
    The engine copies the batch back to its state's device inside
    `run_update`; both copies are billed to the update segment.  The
    update backend is whatever the engine's dispatcher picks;
    `dcfg.backend` still drives acting.  The replay sample draws from the
    loop's generator either way, so a learner forced to the mode of
    `dcfg.backend` (`TRAIN_BACKENDS`) at a `batch_size` that is one of its
    buckets ends on the same agent, bitwise.

    `tracer` (an `obs.Tracer`), when enabled, gets one span per segment
    and timestep: `loop.act`, `loop.env`, `loop.replay` and `loop.update`,
    layered over a learner's own engine spans.

    `observability` (an `obs.Observability`): its tracer is used when
    `tracer` is None, its HTTP endpoint (`serve_http=port`) is started so
    the host serves /metrics and /healthz while training, and its tracer is
    flushed on exit, normal or aborted.

    Returns (final TrainState, {"times": {env, runtime, accelerator}
    seconds, "total_steps"})."""
    cfg = as_train_config(cfg)
    if observability is not None:
        if tracer is None:
            tracer = observability.tracer
        observability.ensure_server()
    ts = init_train_state(env, cfg, dcfg, device=device)
    dev = ts.obs.device
    proc = _noise_proc(cfg, dcfg)
    times = {"env": 0.0, "runtime": 0.0, "accelerator": 0.0}
    stamps: list[float] = []  # the step's start, then the end of each segment

    def mark() -> None:
        _sync(dev)
        stamps.append(time.perf_counter())

    update_fn = None
    if learner is not None:
        learner.load_state(ts.agent)

        def update_fn(agent: ddpg.DDPGState, batch: dict) -> ddpg.DDPGState:
            learner.run_update({k: v.cpu().numpy() for k, v in batch.items()})  # blocks until applied
            return learner.state

    try:
        for step in range(cfg.total_steps):
            stamps[:] = [time.perf_counter()]
            update = _updates_at(step, cfg)
            ts, _ = _timestep(ts, env, proc, dcfg, update, mark, update_fn)
            t0, t1, t2, t3 = stamps[:4]
            t4 = stamps[4] if update else time.perf_counter()
            times["accelerator"] += (t1 - t0) + (t4 - t3)
            times["env"] += t2 - t1
            times["runtime"] += t3 - t2
            if tracer is not None and tracer.enabled:
                tracer.complete("loop.act", t0, t1, cat="loop", step=step)
                tracer.complete("loop.env", t1, t2, cat="loop", step=step)
                tracer.complete("loop.replay", t2, t3, cat="loop", step=step)
                if t4 > t3:
                    tracer.complete("loop.update", t3, t4, cat="loop", step=step)
    finally:
        if observability is not None:
            observability.flush()
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


__all__ = [
    "TrainConfig",
    "LoopConfig",
    "as_train_config",
    "TrainState",
    "init_train_state",
    "train_host",
    "train_device",
    "train_fused",
    "evaluate",
]
