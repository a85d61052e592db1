"""repro_torch.serve.lm — continuously batched LM serving on the shared
runtime (port of `repro.serve.lm`): `LMEngine` decodes many sequences per
device call with per-sequence lanes (KV caches and recurrent states),
mid-decode admission and eviction of finished sequences, for every LM arch
of `configs/`."""

from repro_torch.serve.lm.engine import LMEngine, LMRequest

__all__ = ["LMEngine", "LMRequest"]
