"""Architecture registry (port of `repro.configs.registry`):
`get(arch_id)` -> full ModelConfig, `get_smoke(arch_id)` -> reduced
same-family config for CPU smoke tests."""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

ARCH_IDS = [
    "gemma3_1b", "internlm2_1_8b", "qwen2_0_5b", "deepseek_7b", "rwkv6_1_6b",
    "dbrx_132b", "moonshot_v1_16b_a3b", "phi3_vision_4_2b", "hubert_xlarge",
    "recurrentgemma_2b", "fixar_ddpg",
]

# external ids (as given in the assignment) -> module names
ALIASES = {
    "gemma3-1b": "gemma3_1b",
    "internlm2-1.8b": "internlm2_1_8b",
    "qwen2-0.5b": "qwen2_0_5b",
    "deepseek-7b": "deepseek_7b",
    "rwkv6-1.6b": "rwkv6_1_6b",
    "dbrx-132b": "dbrx_132b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "phi-3-vision-4.2b": "phi3_vision_4_2b",
    "hubert-xlarge": "hubert_xlarge",
    "recurrentgemma-2b": "recurrentgemma_2b",
}


# configs of the port alone: reached by `get`, kept out of `ARCH_IDS`,
# `ALIASES` and `lm_archs()`, which are the JAX package's lists
PORT_ARCH_IDS = ["moonlight_16b_a3b"]


def _module(arch: str):
    name = ALIASES.get(arch, arch).replace("-", "_").replace(".", "_")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke(arch: str) -> ModelConfig:
    return _module(arch).SMOKE


def lm_archs() -> list[str]:
    return [a for a in ARCH_IDS if a != "fixar_ddpg"]
