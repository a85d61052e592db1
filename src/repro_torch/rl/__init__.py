"""DDPG with FIXAR's fixed-point QAT (port of `repro.rl`; serving subset)."""
