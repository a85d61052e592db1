"""Adam/AdamW on parameter trees (port of `repro.optim.adam`).

A parameter tree here is any tree `repro_torch.tree` walks: the port's
``{"l0": {"w": ..., "b": ...}, ...}`` actor and critic, or an LM's
``{"embed", ..., "scan": [...], "tail": [...]}``.  `leaf_update` is the
flat per-leaf form against
precomputed `StepConstants`, shared by `update` and (in the reference) the
fused training-step kernel's epilogue.  Everything runs under
`torch.no_grad`: the optimizer is not differentiated.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch import tree
from repro_torch.core.parallelism import is_dtensor
from repro_torch.numerics import sqrt_rn

Tensor = torch.Tensor
Tree = dict[str, Any]


def tree_map(fn, *trees: Tree) -> Tree:
    """`fn` over the leaves of equally shaped trees, in `repro_torch.tree`'s
    order; the result has the first tree's structure."""
    return tree.unflatten(trees[0], [fn(*xs) for xs in zip(*map(tree.leaves, trees), strict=True)])


def tree_leaves(t: Tree) -> list[Tensor]:
    """Leaves in the order `jax.tree.leaves` gives (`repro_torch.tree.leaves`)."""
    return tree.leaves(t)


@dataclasses.dataclass
class AdamState:
    step: Tensor  # i32 scalar
    mu: Tree  # first moment
    nu: Tree  # second moment

    def to(self, device) -> "AdamState":
        move = lambda t: t.to(device)  # noqa: E731
        return AdamState(step=self.step.to(device), mu=tree_map(move, self.mu), nu=tree_map(move, self.nu))


@dataclasses.dataclass(frozen=True)
class AdamConfig:
    lr: float = 1e-4  # FIXAR: Adam lr 1e-4 (§VI-B)
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0  # AdamW when > 0
    grad_clip_norm: Optional[float] = None
    # callable step -> lr multiplier; None = constant
    schedule: Optional[Callable[[Tensor], Tensor]] = None


def init(params: Tree) -> AdamState:
    leaf = tree_leaves(params)[0]
    zeros = lambda p: torch.zeros_like(p)  # noqa: E731
    return AdamState(
        step=torch.zeros((), dtype=torch.int32, device=leaf.device),
        mu=tree_map(zeros, params),
        nu=tree_map(zeros, params),
    )


def global_norm(tree: Tree) -> Tensor:
    """√Σ leaf², float32.  Over sharded (DTensor) leaves the per-leaf sums
    of squares are reduced across the ranks in one all-reduce
    (`_sharded_sum_squares`); the result is a plain 0-d tensor, the same on
    every rank."""
    leaves = tree_leaves(tree)
    if any(is_dtensor(leaf) for leaf in leaves):
        return sqrt_rn(_sharded_sum_squares(leaves))
    return sqrt_rn(sum(torch.sum(torch.square(leaf.to(torch.float32))) for leaf in leaves))


def _sharded_sum_squares(leaves: list) -> Tensor:
    """Σ over the leaves of Σ leaf², with one collective: every rank sums
    the squares of its local piece of each leaf, counted only on the rank
    that owns that piece (coordinate 0 along each mesh dim that replicates
    the leaf); the (n_leaves,) vector of those sums is all-reduced over the
    world and then added up in leaf order.  A partial-sum leaf is reduced
    first."""
    import torch.distributed as dist
    from torch.distributed.tensor import Partial, Replicate

    parts = []
    for leaf in leaves:
        if not is_dtensor(leaf):
            raise TypeError("a tree of sharded leaves holds a plain tensor")
        if any(isinstance(p, Partial) for p in leaf.placements):
            leaf = leaf.redistribute(leaf.device_mesh, tuple(
                Replicate() if isinstance(p, Partial) else p for p in leaf.placements))
        coord = leaf.device_mesh.get_coordinate()
        owner = all(c == 0 for c, p in zip(coord, leaf.placements) if isinstance(p, Replicate))
        ss = torch.sum(torch.square(leaf.to_local().to(torch.float32)))
        parts.append(ss if owner else torch.zeros_like(ss))
    if leaves[0].device_mesh.size() != dist.get_world_size():
        raise ValueError("a sharded global norm needs a mesh over the whole world")
    vec = torch.stack(parts)
    dist.all_reduce(vec)
    return sum(vec.unbind(0))


def clip_by_global_norm(grads: Tree, max_norm: float) -> tuple[Tree, Tensor]:
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-12), max=1.0)
    return tree_map(lambda g: g * scale, grads), norm


class StepConstants(NamedTuple):
    """Per-step scalars of the Adam update, 0-d float32 tensors computed
    once per step.  The `(1 - b)` complements are folded in Python double
    and then cast to float32, as the reference folds them."""

    lr: Tensor
    b1: Tensor
    one_minus_b1: Tensor
    b2: Tensor
    one_minus_b2: Tensor
    eps: Tensor
    bc1: Tensor  # 1 - b1**t  (bias correction, post-increment step t)
    bc2: Tensor  # 1 - b2**t


def step_constants(cfg: AdamConfig, step: Tensor) -> StepConstants:
    """Constants for the update at post-increment step `step` (= state.step
    + 1): schedule-folded lr, bias corrections and the beta complements."""
    dev = step.device
    t = step.to(torch.float32)
    # `full`, not `tensor`: no host-to-device copy, which would wait for the device
    f32 = lambda v: torch.full((), v, dtype=torch.float32, device=dev)  # noqa: E731
    lr = f32(cfg.lr)
    if cfg.schedule is not None:
        lr = lr * cfg.schedule(step)
    b1, b2 = f32(cfg.b1), f32(cfg.b2)
    return StepConstants(
        lr=lr,
        b1=b1,
        one_minus_b1=f32(1 - cfg.b1),
        b2=b2,
        one_minus_b2=f32(1 - cfg.b2),
        eps=f32(cfg.eps),
        bc1=1.0 - torch.pow(b1, t),
        bc2=1.0 - torch.pow(b2, t),
    )


def leaf_update(
    p: Tensor, g: Tensor, m: Tensor, v: Tensor, c: StepConstants, *, weight_decay: float = 0.0
) -> tuple[Tensor, Tensor, Tensor]:
    """One leaf of the Adam step: elementwise float32 against precomputed
    `StepConstants`.  Returns (new_p, new_m, new_v)."""
    g = g.to(torch.float32)
    m = c.b1 * m + c.one_minus_b1 * g
    v = c.b2 * v + c.one_minus_b2 * torch.square(g)
    mhat = m / c.bc1
    vhat = v / c.bc2
    delta = mhat / (sqrt_rn(vhat) + c.eps)
    if weight_decay > 0.0:
        delta = delta + weight_decay * p.to(torch.float32)
    return (p - c.lr * delta).to(p.dtype), m, v


def _apply(cfg: AdamConfig, grads: Tree, state: AdamState, params: Tree, leaf_fn):
    """The tree walk shared by `update` and `fxp_adam.update`."""
    metrics: dict[str, Tensor] = {}
    with torch.no_grad():
        if cfg.grad_clip_norm is not None:
            grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip_norm)
            metrics["grad_norm"] = gnorm
        step = state.step + 1
        c = step_constants(cfg, step)
        metrics["lr"] = c.lr
        out = [leaf_fn(p, g, m, v, c)
               for p, g, m, v in zip(*map(tree.leaves, (params, grads, state.mu, state.nu)), strict=True)]
        pick = lambda i: tree.unflatten(params, [o[i] for o in out])  # noqa: E731
        return pick(0), AdamState(step=step, mu=pick(1), nu=pick(2)), metrics


def update(cfg: AdamConfig, grads: Tree, state: AdamState, params: Tree) -> tuple[Tree, AdamState, dict]:
    """Returns (new_params, new_state, metrics)."""
    return _apply(
        cfg, grads, state, params, lambda p, g, m, v, c: leaf_update(p, g, m, v, c, weight_decay=cfg.weight_decay)
    )


__all__ = [
    "AdamConfig",
    "AdamState",
    "StepConstants",
    "init",
    "update",
    "step_constants",
    "leaf_update",
    "global_norm",
    "clip_by_global_norm",
    "tree_map",
    "tree_leaves",
]
