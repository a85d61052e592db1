"""Configurations of the port's workloads (port of `repro.configs`): the
paper's DDPG workload and the LM zoo's eleven architectures, pure data."""

from repro_torch.configs.registry import ALIASES, ARCH_IDS, get, get_smoke, lm_archs
