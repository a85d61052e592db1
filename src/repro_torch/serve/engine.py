"""LM serving: prefill + batched decode with KV caches (port of
`repro.serve.engine`).

`make_serve_step` decodes one new token against a cache, `make_prefill`
processes a prompt (filling the caches), and `generate` runs the whole
loop for one batch of prompts.  Greedy decoding is the contract; with
`temperature > 0` tokens are drawn from an explicit `torch.Generator`, and
they are not expected to match the reference's `jax.random.categorical`.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.parallelism import ShardingRules
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig

Tensor = torch.Tensor
Params = dict[str, Any]


def make_serve_step(cfg: ModelConfig, *, rules: Optional[ShardingRules] = None):
    """decode one token: (params, tokens (B,1), cache, pos) -> (logits, cache).
    `pos` may be an int (lockstep batch) or a (B,) tensor of per-row
    positions (continuous batching — serve/lm decodes heterogeneous lanes
    in one call).  The cache is updated in place."""

    def serve_step(params, tokens, cache, pos):
        return T.decode_step(params, tokens, cache, pos, cfg, rules=rules)

    return serve_step


def make_prefill(cfg: ModelConfig, *, rules: Optional[ShardingRules] = None, attn_chunk: int = 0):
    """prefill: (params, batch[, cache]) — logits only without a cache,
    (logits, cache) with one (decode follows)."""

    def prefill_step(params, batch, cache=None):
        return T.prefill(params, batch, cfg, rules=rules, attn_chunk=attn_chunk, cache=cache)

    return prefill_step


def _next_token(logits: Tensor, temperature: float, generator: Optional[torch.Generator]) -> Tensor:
    if temperature > 0.0:
        if generator is None:
            raise ValueError("temperature > 0 samples: pass generator=")
        probs = torch.softmax(logits.to(torch.float32) / temperature, dim=-1)
        return torch.multinomial(probs.to(generator.device), 1, generator=generator)[:, 0].to(logits.device)
    return torch.argmax(logits, dim=-1)  # the first maximal index on a tie, as jnp.argmax


@torch.inference_mode()
def generate(params: Params, cfg: ModelConfig, prompt, max_new: int, *,
             generator: Optional[torch.Generator] = None, temperature: float = 0.0) -> Tensor:
    """Greedy (or sampled) generation for a (B, S) batch of prompts; runs
    where `params` lie and returns (B, S + max_new) int32 token ids there.

    `params` may be the float32 tree or `transformer.serving_params` of it:
    the product weights are cast to the compute dtype once, here, which
    gives bitwise the logits of casting them at every use."""
    params = T.serving_params(params, cfg)
    dev = params["embed"]["embedding"].device
    prompt = prompt if isinstance(prompt, Tensor) else torch.as_tensor(np.asarray(prompt))
    prompt = prompt.to(dev, torch.int32)
    b, s = prompt.shape
    cache = T.init_cache(cfg, b, s + max_new, device=dev)
    # one batched prefill pass fills the KV caches and yields the prompt's
    # last-position logits
    logits, cache = T.prefill(params, {"tokens": prompt}, cfg, cache=cache)
    out = [prompt]
    for i in range(max_new):
        tok = _next_token(logits, temperature, generator)[:, None].to(torch.int32)
        out.append(tok)
        if i + 1 < max_new:  # the last token's logits are never read
            step_logits, cache = T.decode_step(params, tok, cache, s + i, cfg)
            logits = step_logits[:, -1]
    return torch.cat(out, dim=1)


__all__ = ["make_serve_step", "make_prefill", "generate"]
