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

An MLA model (`config.DeepSeekV3Config`) carries its MoE layers' routing
bias in `TrainState.router_bias`, (n_periods, n_experts) float32, not a
parameter: after each step b += `bias_update_rate`·sign(mean load −
load), per layer over all experts, from the step's loads (DeepSeek-V3's
aux-loss-free balancing).  Its step's metrics add the MoE counters, device
tensors: "moe_rows_held" (rows the held experts computed, over the
layers), "moe_load_max_over_mean" (the worst layer's), "moe_rows_dropped"
(0: the dispatch is dropless) and "moe_bias_absmax" (after the update),
and "moe_load", the step's (n_periods, n_experts) loads the update read.
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
    router_bias: Optional[Tensor] = None  # an MLA model's (n_periods, n_experts) routing bias


def init_state(gen, cfg: ModelConfig, *, device: DeviceLike = None) -> TrainState:
    """Fresh params (`transformer.init_params`: `gen` a `torch.Generator`
    or a seed), zero Adam moments, empty ranges, step 0, on `device`."""
    dev = resolve_device(device)
    params = T.init_params(gen, cfg, device=dev)
    bias = (torch.zeros((cfg.n_periods, cfg.n_experts), dtype=torch.float32, device=dev)
            if cfg.is_mla else None)
    return TrainState(params=params, opt=adam.init(params), ranges=T.init_ranges(cfg, device=dev),
                      step=torch.zeros((), dtype=torch.int32, device=dev), router_bias=bias)


def value_and_grad(cfg: ModelConfig, params: Params, ranges: Optional[Params], batch: dict[str, Tensor],
                   quant_phase: Tensor, *, rules: Optional[ShardingRules] = None, attn_chunk: int = 0,
                   unroll: bool = False, ce_chunk: int = 0,
                   router_bias: Optional[Tensor] = None) -> tuple[Tensor, dict, Params]:
    """`loss_fn` and its gradient with respect to `params`: (loss, extras,
    grads), loss detached, grads in `params`' tree (zeros for a leaf the
    loss does not reach, as JAX's grad gives them).  `ranges` None runs
    without the QAT sites; remat follows `cfg.remat`."""
    live = [leaf.detach().requires_grad_(True) for leaf in tree.leaves(params)]
    with sharded_scope():
        loss, extras = T.loss_fn(tree.unflatten(params, live), batch, cfg, rules=rules, ranges=ranges,
                                 quant_phase=quant_phase, remat=cfg.remat != "none", attn_chunk=attn_chunk,
                                 unroll=unroll, ce_chunk=ce_chunk, router_bias=router_bias)
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

    def grads_of(params, ranges, batch, quant_phase, bias):
        loss, extras, grads = value_and_grad(cfg, params, ranges if cfg.qat else None, batch, quant_phase,
                                             router_bias=bias, **kw)
        return loss, (extras["ranges"] if cfg.qat else ranges), grads, extras.get("moe")

    def train_step(state: TrainState, batch: dict[str, Tensor]) -> tuple[TrainState, dict[str, Tensor]]:
        quant_phase = state.step >= cfg.qat_delay
        moe = None
        if n_microbatches == 1:
            loss, new_ranges, grads, moe = grads_of(state.params, state.ranges, batch, quant_phase,
                                                    state.router_bias)
        else:
            if state.router_bias is not None:
                raise NotImplementedError("an MLA model's step takes one microbatch")
            mb = {k: v.reshape((n_microbatches, v.shape[0] // n_microbatches) + v.shape[1:])
                  for k, v in batch.items()}
            gsum = adam.tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                                 state.params)
            new_ranges, losses = state.ranges, []
            for i in range(n_microbatches):
                loss_i, new_ranges, g, _ = grads_of(state.params, new_ranges, {k: v[i] for k, v in mb.items()},
                                                    quant_phase, None)
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
        bias = state.router_bias
        if moe is not None:
            bias, counters = _balance(cfg, bias, moe)
            metrics.update(counters)
        return TrainState(params=new_params, opt=new_opt, ranges=new_ranges, step=state.step + 1,
                          router_bias=bias), metrics

    return train_step


def _balance(cfg: ModelConfig, bias: Tensor, moe: dict) -> tuple[Tensor, dict[str, Tensor]]:
    """The aux-loss-free bias update from the step's loads, and the MoE
    counters (module docstring)."""
    with torch.no_grad():
        load = moe["load"].to(torch.float32)  # (n_periods, n_experts)
        mean = load.mean(-1, keepdim=True)
        bias = bias + cfg.bias_update_rate * torch.sign(mean - load)
        counters = {"moe_rows_held": moe["rows_held"],
                    "moe_load_max_over_mean": (load.max(-1).values / mean[:, 0]).max(),
                    "moe_rows_dropped": moe["rows_dropped"], "moe_bias_absmax": bias.abs().max(),
                    "moe_load": moe["load"]}
    return bias, counters


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
