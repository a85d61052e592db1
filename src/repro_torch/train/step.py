"""LM training step: loss + grads + (fixed-point) Adam + QAT threading (port
of `repro.train.step`).

The FIXAR technique rides along as a first-class feature: when cfg.qat is
set, every activation site fake-quantizes per Algorithm 1 (32-bit lattice
pre-delay with range monitoring, 16-bit affine after), gradients and weights
are projected onto the Q15.16 lattice (the fixed-point gradient/weight
memories), and the per-layer ranges thread through the layer walk.

Microbatching (gradient accumulation) walks the microbatch slices in a
Python loop (the reference's `lax.scan`) with a float32 grad accumulator,
the ranges threaded from one microbatch to the next.

Gradients come from `torch.autograd.grad` on detached copies of the
params, which stay plain tensors (no `requires_grad`) in the state.
Nothing reads the device on the host: the QAT phase is a device-side bool
(`step >= qat_delay`) that the sites select on, and the microbatch mean
divides by a device tensor.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch import tree
from repro_torch.core.parallelism import ShardingRules, is_dtensor, sharded_scope
from repro_torch.core.qat import quantize_grads, quantize_weights
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adam

Tensor = torch.Tensor
Params = dict[str, Any]


@dataclasses.dataclass
class TrainState:
    """The reference's `TrainState`, walked by `repro_torch.tree` in its
    pytree order (params, opt, ranges, step), so `checkpoint.ckpt` writes
    and restores it leaf for leaf as the reference's."""

    params: Params
    opt: adam.AdamState
    ranges: Params  # QAT range trees (present even when qat off)
    step: Tensor  # int32 scalar


def init_state(gen, cfg: ModelConfig, *, device: DeviceLike = None) -> TrainState:
    """Fresh params (`transformer.init_params`: `gen` a `torch.Generator`
    or a seed), zero Adam moments, empty ranges, step 0, on `device`."""
    dev = resolve_device(device)
    params = T.init_params(gen, cfg, device=dev)
    return TrainState(params=params, opt=adam.init(params), ranges=T.init_ranges(cfg, device=dev),
                      step=torch.zeros((), dtype=torch.int32, device=dev))


def value_and_grad(cfg: ModelConfig, params: Params, ranges: Optional[Params], batch: dict[str, Tensor],
                   quant_phase: Tensor, *, rules: Optional[ShardingRules] = None, attn_chunk: int = 0,
                   unroll: bool = False, ce_chunk: int = 0) -> tuple[Tensor, dict, Params]:
    """`loss_fn` and its gradient with respect to `params`: (loss, extras,
    grads), loss detached, grads in `params`' tree (zeros for a leaf the
    loss does not reach, as JAX's grad gives them).  `ranges` None runs
    without the QAT sites; remat follows `cfg.remat`."""
    live = [leaf.detach().requires_grad_(True) for leaf in tree.leaves(params)]
    with sharded_scope():
        loss, extras = T.loss_fn(tree.unflatten(params, live), batch, cfg, rules=rules, ranges=ranges,
                                 quant_phase=quant_phase, remat=cfg.remat != "none", attn_chunk=attn_chunk,
                                 unroll=unroll, ce_chunk=ce_chunk)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else _like_param(g, p) for p, g in zip(live, grads)]
    return loss.detach(), extras, tree.unflatten(params, grads)


def _like_param(g: Tensor, p: Tensor) -> Tensor:
    """A sharded gradient laid out as its parameter: a partial sum over the
    batch shards is reduced here (the data-parallel gradient all-reduce)."""
    if is_dtensor(g) and g.placements != p.placements:
        return g.redistribute(p.device_mesh, p.placements)
    return g


def make_train_step(cfg: ModelConfig, opt_cfg: adam.AdamConfig, *, rules: Optional[ShardingRules] = None,
                    n_microbatches: int = 1, attn_chunk: int = 0, unroll: bool = False, ce_chunk: int = 0):
    """Returns train_step(state, batch) -> (state, metrics)."""
    kw = dict(rules=rules, attn_chunk=attn_chunk, unroll=unroll, ce_chunk=ce_chunk)

    def grads_of(params, ranges, batch, quant_phase):
        loss, extras, grads = value_and_grad(cfg, params, ranges if cfg.qat else None, batch, quant_phase, **kw)
        return loss, (extras["ranges"] if cfg.qat else ranges), grads

    def train_step(state: TrainState, batch: dict[str, Tensor]) -> tuple[TrainState, dict[str, Tensor]]:
        quant_phase = state.step >= cfg.qat_delay
        if n_microbatches == 1:
            loss, new_ranges, grads = grads_of(state.params, state.ranges, batch, quant_phase)
        else:
            mb = {k: v.reshape((n_microbatches, v.shape[0] // n_microbatches) + v.shape[1:])
                  for k, v in batch.items()}
            gsum = adam.tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                                 state.params)
            new_ranges, losses = state.ranges, []
            for i in range(n_microbatches):
                loss_i, new_ranges, g = grads_of(state.params, new_ranges, {k: v[i] for k, v in mb.items()},
                                                 quant_phase)
                gsum = adam.tree_map(lambda a, gg: a + gg.to(torch.float32), gsum, g)
                losses.append(loss_i)
            n = torch.full((), float(n_microbatches), dtype=torch.float32, device=state.step.device)
            grads = adam.tree_map(lambda g: g / n, gsum)
            loss = torch.stack(losses).mean()

        with torch.no_grad():
            if cfg.qat:  # fxp32 gradient memory
                grads = quantize_grads(grads)
            new_params, new_opt, metrics = adam.update(opt_cfg, grads, state.opt, state.params)
            if cfg.qat:  # fxp32 weight memory
                new_params = quantize_weights(new_params)
        metrics = dict(metrics, loss=loss, quant_phase=quant_phase.to(torch.int32))
        return TrainState(params=new_params, opt=new_opt, ranges=new_ranges, step=state.step + 1), metrics

    return train_step


def learner_update_fns(cfg: ModelConfig, opt_cfg: adam.AdamConfig, **kwargs) -> dict:
    """The LM train step in `train/learner.LearnerEngine`'s update-family
    contract: {mode: update_fn(state, batch) -> (state, metrics)}.

    The LM step has one trainable path (autograd), so the family is the
    single "jnp" mode (the reference's name) — dispatch degenerates to a
    pass-through, but the engine's queueing, coalescing and metrics apply
    unchanged.  LM batches carry no per-row loss mask, so pair this with
    `LearnerEngine(pad_policy="exact")` and buckets matching the batch
    shapes (`kwargs` forward to `make_train_step`)."""
    return {"jnp": make_train_step(cfg, opt_cfg, **kwargs)}


__all__ = ["TrainState", "init_state", "value_and_grad", "make_train_step", "learner_update_fns"]
