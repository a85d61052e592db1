"""Modality frontend stubs (port of `repro.models.frontend`): the [vlm] and
[audio] entries are the transformer backbone only, and `batch["frontend"]`
carries precomputed frame/patch embeddings.

vision_stub (phi-3-vision): batch["frontend"] = (B, frontend_len, frontend_dim)
    CLIP patch embeddings, linearly projected into d_model and overwriting
    the first `frontend_len` token positions (prefix).

audio_stub (hubert): batch["frontend"] = (B, S, frontend_dim) conv-stem frame
    embeddings, projected to d_model and used *instead of* token embeddings.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.parallelism import Logical, ShardingRules, constrain
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import _uniform

Tensor = torch.Tensor


def frontend_init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    if cfg.frontend == "none":
        return {}
    return {"proj": _uniform(gen, (cfg.frontend_dim, cfg.d_model), cfg.frontend_dim)}


def frontend_specs(cfg: ModelConfig) -> dict:
    if cfg.frontend == "none":
        return {}
    return {"proj": Logical(None, "embed")}


def apply_frontend(x_embed: Tensor, params: dict, batch: dict, cfg: ModelConfig,
                   rules: Optional[ShardingRules]) -> Tensor:
    """Merge frontend embeddings into the token-embedding sequence."""
    if cfg.frontend == "none" or "frontend" not in batch:
        return x_embed
    dt = cfg.compute_dtype
    fe = batch["frontend"].to(dt) @ params["proj"].to(dt)
    if cfg.frontend == "audio_stub":
        return constrain(fe, rules, "batch", "seq", "embed")
    # vision_stub: prefix replace
    flen = cfg.frontend_len
    merged = torch.cat([fe[:, :flen], x_embed[:, flen:]], dim=1)
    return constrain(merged, rules, "batch", "seq", "embed")
