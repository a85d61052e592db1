"""The LM zoo's models (port of `repro.models`): the attention family.
MoE, RWKV-6 and RG-LRU blocks wait for later slices (ROADMAP queue 1)."""

from repro_torch.models import config, frontend, layers, transformer
from repro_torch.models.config import ALL_SHAPES, ModelConfig, ShapeConfig
