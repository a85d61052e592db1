"""FIXAR's own workload: DDPG 400-300 actor-critic on continuous-control
benchmarks (the paper's §VI configuration; port of
`repro.configs.fixar_ddpg`).  `chip_smoke.py`'s training phase runs
`CONFIG` cut in length, the CPU loop test `SMOKE`."""

import dataclasses

from repro_torch.rl.ddpg import DDPGConfig


@dataclasses.dataclass(frozen=True)
class FixarConfig:
    env: str = "halfcheetah"
    ddpg: DDPGConfig = dataclasses.field(default_factory=DDPGConfig)
    total_steps: int = 1_000_000  # paper: 1M timesteps
    eval_every: int = 5_000  # paper cadence
    qat_delay_frac: float = 0.4  # delay = frac * total steps


CONFIG = FixarConfig()
SMOKE = FixarConfig(env="pendulum", total_steps=2_000, ddpg=DDPGConfig(batch_size=32))
