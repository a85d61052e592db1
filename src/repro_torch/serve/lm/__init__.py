"""repro_torch.serve.lm — continuously batched LM serving on the shared
runtime (port of `repro.serve.lm`): `LMEngine` decodes many sequences per
device call with per-sequence KV lanes, mid-decode admission and eviction
of finished sequences, for the attention family of `configs/`."""

from repro_torch.serve.lm.engine import LMEngine, LMRequest

__all__ = ["LMEngine", "LMRequest"]
