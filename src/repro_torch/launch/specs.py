"""Input, state and cache shapes and their shardings for the launchers
(port of `repro.launch.specs`).

Shapes are built without memory: the port's own `init_params`,
`init_state` and `init_cache` run under `FakeTensorMode` (the counterpart
of `jax.eval_shape`), and every leaf is returned as a `ShapeDtype` — its
shape and dtype, usable outside the mode.  Shardings resolve the models'
`Logical` trees through `core.parallelism.tree_shardings`, with the
shape-aware divisibility guard.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch import tree
from repro_torch.core.parallelism import Logical, Mesh, ShardingRules, map_logical, tree_shardings
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig, ShapeConfig
from repro_torch.optim import adam
from repro_torch.train.step import TrainState, init_state


@dataclasses.dataclass(frozen=True)
class ShapeDtype:
    """A tensor's shape and dtype without its data (`jax.ShapeDtypeStruct`)."""

    shape: tuple
    dtype: torch.dtype


SDS = ShapeDtype  # the reference's name


def _abstract(build):
    """`build()` (a tree of tensors made on the CPU) run under
    `FakeTensorMode`, every leaf replaced by its `ShapeDtype`."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        fake = build()
    return tree.tree_map(lambda t: ShapeDtype(tuple(t.shape), t.dtype), fake)


# ---------------------------------------------------------------------------
# batch input specs
# ---------------------------------------------------------------------------


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict[str, Any]:
    """`ShapeDtype` stand-ins for every model input of this cell."""
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        return {"tokens": ShapeDtype((b, 1), torch.int32)}
    batch: dict[str, Any] = {}
    if cfg.frontend != "audio_stub":
        batch["tokens"] = ShapeDtype((b, s), torch.int32)
    if cfg.frontend == "vision_stub":
        batch["frontend"] = ShapeDtype((b, cfg.frontend_len, cfg.frontend_dim), torch.float32)
    elif cfg.frontend == "audio_stub":
        batch["frontend"] = ShapeDtype((b, s, cfg.frontend_dim), torch.float32)
    if shape.kind == "train":
        batch["labels"] = ShapeDtype((b, s), torch.int32)
    return batch


def input_spec_logical(cfg: ModelConfig, shape: ShapeConfig) -> dict[str, Any]:
    out: dict[str, Any] = {}
    if shape.kind == "decode":
        return {"tokens": Logical("batch", None)}
    if cfg.frontend != "audio_stub":
        out["tokens"] = Logical("batch", "seq")
    if cfg.frontend == "vision_stub":
        out["frontend"] = Logical("batch", None, None)
    elif cfg.frontend == "audio_stub":
        out["frontend"] = Logical("batch", "seq", None)
    if shape.kind == "train":
        out["labels"] = Logical("batch", "seq")
    return out


# ---------------------------------------------------------------------------
# state / params / cache specs
# ---------------------------------------------------------------------------


def params_shapes(cfg: ModelConfig):
    return _abstract(lambda: T.init_params(torch.Generator().manual_seed(0), cfg, device="cpu"))


def state_shapes(cfg: ModelConfig):
    return _abstract(lambda: init_state(torch.Generator().manual_seed(0), cfg, device="cpu"))


def cache_shapes(cfg: ModelConfig, batch: int, max_seq: int):
    return _abstract(lambda: T.init_cache(cfg, batch, max_seq, device="cpu"))


def state_logical(cfg: ModelConfig) -> TrainState:
    pspecs = T.param_specs(cfg)
    return TrainState(
        params=pspecs,
        opt=adam.AdamState(step=Logical(), mu=pspecs, nu=pspecs),
        ranges=map_logical(lambda _: Logical(), T.ranges_specs(cfg)),  # replicated, no axes
        step=Logical(),
        router_bias=Logical(None, None) if cfg.is_mla else None,  # replicated
    )


def train_shardings(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh, rules: ShardingRules):
    """(state_shardings, batch_shardings) for make_train_step's signature."""
    st_sh = tree_shardings(state_logical(cfg), mesh, rules, shape_tree=state_shapes(cfg))
    b_sh = tree_shardings(input_spec_logical(cfg, shape), mesh, rules, shape_tree=input_specs(cfg, shape))
    return st_sh, b_sh


def serve_shardings(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh, rules: ShardingRules):
    """(params_sh, tokens_sh, cache_sh) for serve_step / prefill."""
    p_sh = tree_shardings(T.param_specs(cfg), mesh, rules, shape_tree=params_shapes(cfg))
    b_sh = tree_shardings(input_spec_logical(cfg, shape), mesh, rules, shape_tree=input_specs(cfg, shape))
    if shape.kind != "decode":
        return p_sh, b_sh, None
    c_shapes = cache_shapes(cfg, shape.global_batch, shape.seq_len)
    c_sh = tree_shardings(T.cache_specs(cfg), mesh, rules, shape_tree=c_shapes)
    return p_sh, b_sh, c_sh


__all__ = ["ShapeDtype", "SDS", "input_specs", "input_spec_logical", "params_shapes", "state_shapes", "cache_shapes",
           "state_logical", "train_shardings", "serve_shardings"]
