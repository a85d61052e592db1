"""DDPG with FIXAR's fixed-point QAT, its envs, replay, noise and host
training loop (port of `repro.rl`)."""
