"""The LM zoo's models (port of `repro.models`): attention, MoE, RWKV-6 and
RG-LRU blocks, assembled by `transformer`."""

from repro_torch.models import config, frontend, layers, moe, rglru, rwkv6, transformer
from repro_torch.models.config import ALL_SHAPES, ModelConfig, ShapeConfig
