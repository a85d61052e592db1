"""The functional environment API (port of `repro.rl.envs.base`).

An environment is a frozen config with a static `EnvSpec` and two
functions over an explicit, fleet-batched `EnvState`:

    init(generator, n, device) -> (state, obs)   — n fresh episodes
    step(state, action, generator=None)
                               -> (state, obs, reward, done)

The reference vmaps single-env functions over a fleet; here the fleet is a
leading batch axis written out, so one call steps every env.  Random draws
come from an explicit `torch.Generator` the caller passes (initial states,
the resets of `step_auto`, observation noise); the reference's JAX keys
are not carried over, so the two give different random numbers.

`step_auto` folds reset-on-done into the step: the reset episodes are
always drawn and selected per lane with `torch.where`, so a fleet never
desynchronizes and the step needs no host round trip.  `reward`/`done`
describe the transition that just happened; `state`/`obs` are post-reset
for done lanes.  Truncation (`t == episode_length`) resets like
termination.

Compat, as in the reference: the `Env` protocol, the `FunctionalEnv`
mixin that keeps the pre-redesign `reset` spelling of `init`, `env_init`
resolving either spelling, and `auto_reset`, the old name of `step_auto`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Protocol, runtime_checkable

import torch

from repro_torch.device import DeviceLike

Tensor = torch.Tensor


@dataclasses.dataclass
class EnvState:
    q: Tensor  # (n, dof) generalized positions
    qd: Tensor  # (n, dof) generalized velocities
    t: Tensor  # (n,) i32 timestep counter


@dataclasses.dataclass(frozen=True)
class EnvSpec:
    name: str
    obs_dim: int
    act_dim: int
    episode_length: int = 1000  # paper: episode = 1000 timesteps


@runtime_checkable
class Env(Protocol):
    """The functional env protocol: `spec` + `init`/`step` over an explicit
    fleet state, all randomness through the generator passed in.
    Implementations are frozen dataclasses (hashable configs)."""

    spec: EnvSpec

    def init(self, generator: torch.Generator, n: int = 1, *, device: DeviceLike = None) -> tuple[EnvState, Tensor]: ...

    def step(self, state: EnvState, action: Tensor, generator: Optional[torch.Generator] = None
             ) -> tuple[EnvState, Tensor, Tensor, Tensor]:
        """-> (new_state, obs, reward, done)"""


class FunctionalEnv:
    """Mixin providing the legacy `reset` spelling as an alias of `init`,
    kept so pre-redesign call sites (`env.reset(generator)`) keep working;
    new code calls `init` (or `env_init` when the env object may predate
    the redesign)."""

    def reset(self, generator: torch.Generator, n: int = 1, *, device: DeviceLike = None) -> tuple[EnvState, Tensor]:
        return self.init(generator, n, device=device)


def env_init(env, generator: torch.Generator, n: int = 1, *, device: DeviceLike = None) -> tuple[EnvState, Tensor]:
    """`env.init`, falling back to the legacy `reset` method: n fresh
    episodes drawn from `generator`, on `device` (the generator's device
    when None)."""
    fn = getattr(env, "init", None)
    if fn is None:
        fn = env.reset
    return fn(generator, n, device=device)


def step_auto(env, state: EnvState, action: Tensor, generator: torch.Generator) -> tuple[EnvState, Tensor, Tensor, Tensor]:
    """Step with automatic reset of the done lanes (module docstring)."""
    new_state, obs, reward, done = env.step(state, action, generator)
    reset_state, reset_obs = env_init(env, generator, int(done.shape[0]), device=obs.device)
    sel = done[:, None]
    out_state = EnvState(
        q=torch.where(sel, reset_state.q, new_state.q),
        qd=torch.where(sel, reset_state.qd, new_state.qd),
        t=torch.where(done, reset_state.t, new_state.t),
    )
    return out_state, torch.where(sel, reset_obs, obs), reward, done


# Pre-redesign name for `step_auto`, with the same (env, state, action,
# generator) calling convention — the same function, not a near-copy.
auto_reset = step_auto


def init_fleet(env, generator: torch.Generator, n_envs: int, *, device: DeviceLike = None) -> tuple[EnvState, Tensor]:
    """An `n_envs` fleet: every leaf has a leading fleet axis."""
    return env_init(env, generator, n_envs, device=device)


def step_fleet(
    env, state: EnvState, action: Tensor, *, generator: Optional[torch.Generator] = None, autoreset: bool = True
) -> tuple[EnvState, Tensor, Tensor, Tensor]:
    """Step a fleet, resetting done lanes by default (`generator` draws the
    resets and any observation noise)."""
    if autoreset:
        if generator is None:
            raise ValueError("autoreset draws fresh episodes: pass generator=")
        return step_auto(env, state, action, generator)
    return env.step(state, action, generator)


__all__ = ["EnvSpec", "EnvState", "Env", "FunctionalEnv", "env_init", "step_auto", "auto_reset", "init_fleet",
           "step_fleet"]
