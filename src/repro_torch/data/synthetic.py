"""Deterministic synthetic data pipeline (port of `repro.data.synthetic`).

Every batch is a pure function of (seed, step) — the property the
fault-tolerance story leans on: a restarted worker resumes at the
checkpointed step and regenerates exactly the batches it would have seen
(runtime/ft.py DataSkipAhead).

The token stream is a mixture of Zipf-distributed unigrams and deterministic
n-gram structure, so LM losses actually *decrease* during smoke training
(pure uniform noise would pin the loss at log V).

The draws come from a CPU `torch.Generator` seeded from (seed, step), and
the batch is then moved to the caller's device: a run on the card and a run
on the CPU see the same tokens.  `jax.random` and `torch.Generator` never
agree, so the stream has the reference's semantics, not its values.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.config import ModelConfig, ShapeConfig

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    zipf_a: float = 1.2
    structure_period: int = 8  # deterministic n-gram backbone


def _batch_generator(cfg: DataConfig, step: int) -> torch.Generator:
    """A CPU generator for (seed, step): the pair hashed by numpy's
    `SeedSequence`, so neighbouring steps draw unrelated streams."""
    seed = int(np.random.SeedSequence([cfg.seed, step]).generate_state(1, np.uint64)[0] >> np.uint64(1))
    return torch.Generator().manual_seed(seed)


def make_batch(cfg: DataConfig, model_cfg: ModelConfig, shape: ShapeConfig, step: int, *,
               device: DeviceLike = None) -> dict[str, Tensor]:
    """Full global batch for `step`, on `device`: int32 "tokens" (B, S)
    (decode shapes: (B, 1)), float32 "frontend" embeddings for the vision
    and audio stubs, int32 "labels" (B, S) for training shapes — the next
    tokens, −100 on the vision prefix; for the audio stub random targets
    on 8 % of the frames, −100 elsewhere."""
    dev = resolve_device(device)
    b, s = shape.global_batch, shape.seq_len
    gen = _batch_generator(cfg, step)
    v = model_cfg.vocab_size

    # Zipf-ish tokens: u^(alpha) maps uniform to a heavy head
    u = torch.rand((b, s + 1), generator=gen)
    toks = (v * u ** cfg.zipf_a).to(torch.int32) % v
    # deterministic structure: every `period`-th token repeats the previous
    struct = torch.arange(s + 1) % cfg.structure_period == 0
    toks = torch.where(struct[None, :], torch.roll(toks, 1, dims=1), toks)

    if shape.kind == "decode":
        return {"tokens": toks[:, :1].to(dev)}
    batch: dict[str, Tensor] = {}
    if model_cfg.frontend != "audio_stub":
        batch["tokens"] = toks[:, :s]
    if model_cfg.frontend == "vision_stub":
        batch["frontend"] = torch.randn((b, model_cfg.frontend_len, model_cfg.frontend_dim), generator=gen)
    elif model_cfg.frontend == "audio_stub":
        batch["frontend"] = torch.randn((b, s, model_cfg.frontend_dim), generator=gen)
    if shape.kind == "train":
        if model_cfg.frontend == "audio_stub":
            # HuBERT-style masked-frame targets: 8% of frames predicted
            labels = torch.randint(0, v, (b, s), generator=gen, dtype=torch.int32)
            mask = torch.rand((b, s), generator=gen) < 0.08
            batch["labels"] = torch.where(mask, labels, -100)
        else:
            labels = toks[:, 1:s + 1]
            if model_cfg.frontend == "vision_stub":
                img = torch.arange(s)[None, :] < model_cfg.frontend_len
                labels = torch.where(img, -100, labels)
            batch["labels"] = labels
    return {k: t.contiguous().to(dev) for k, t in batch.items()}


class DataIterator:
    """Stateful wrapper with O(1) skip-ahead (checkpoint-restore safe)."""

    def __init__(self, cfg: DataConfig, model_cfg: ModelConfig, shape: ShapeConfig, start_step: int = 0, *,
                 device: DeviceLike = None):
        self.cfg, self.model_cfg, self.shape = cfg, model_cfg, shape
        self.device = resolve_device(device)
        self.step = start_step

    def __iter__(self) -> Iterator[dict[str, Tensor]]:
        return self

    def __next__(self) -> dict[str, Tensor]:
        b = make_batch(self.cfg, self.model_cfg, self.shape, self.step, device=self.device)
        self.step += 1
        return b

    def skip_to(self, step: int):
        self.step = step


__all__ = ["DataConfig", "make_batch", "DataIterator"]
