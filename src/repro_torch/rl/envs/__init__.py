"""Fleet-batched continuous-control environments (port of `repro.rl.envs`)."""

from repro_torch.rl.envs.base import (
    Env,
    EnvSpec,
    EnvState,
    FunctionalEnv,
    auto_reset,
    env_init,
    init_fleet,
    step_auto,
    step_fleet,
)
from repro_torch.rl.envs.locomotion import REGISTRY, make

__all__ = ["Env", "EnvSpec", "EnvState", "FunctionalEnv", "auto_reset", "env_init", "init_fleet", "step_auto",
           "step_fleet", "REGISTRY", "make"]
