"""DDPG with FIXAR's fixed-point QAT, its envs, replay, noise and host
training loop (port of `repro.rl`)."""

from repro_torch.rl import ddpg, loop, noise, replay
from repro_torch.rl.envs import locomotion
