"""Carry weights and frozen quantizers across from the JAX reference.

Both functions take numpy arrays (convert on the JAX side with
`np.asarray`), so this module imports nothing from JAX or `repro`:

  * `actor_from_numpy` — the reference's actor params
    ``{"l0": {"w", "b"}, ...}`` → the port's params on `device`;
  * `frozen_from_numpy` — a reference `FrozenQuant`'s fields → the port's
    `FrozenQuant` on `device`;
  * `ddpg_state_from_numpy` — a whole reference `DDPGState` (nets, targets,
    Adam states, QAT state) → the port's `DDPGState` on `device`;
  * `ddpg_state_to_numpy` — its inverse: the port's `DDPGState` with every
    leaf a numpy array, its leaves in the reference's pytree order;
  * `lm_params_from_numpy` / `lm_ranges_from_numpy` / `lm_cache_from_numpy`
    — an LM's param tree, QAT range tree or KV-cache tree in the
    reference's layout (`jax.tree.map(np.asarray, tree)`) → the port's
    `models.transformer` trees on `device`, leaf for leaf;
  * `lm_params_to_numpy` / `lm_ranges_to_numpy` / `lm_cache_to_numpy` —
    their inverses (a bfloat16 leaf comes back as a float32 array, which
    holds it exactly: numpy has no bfloat16 of its own).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import tree
from repro_torch.core.qat import FrozenQuant, QATConfig, QATState
from repro_torch.core.ranges import RangeStat
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.optim.adam import AdamState
from repro_torch.rl.ddpg import DDPGState


def _tensor(a, dev: torch.device, dtype=np.float32) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=dtype, copy=True)).to(dev)


def actor_from_numpy(params: dict, *, device: DeviceLike = None) -> dict:
    """``{"l0": {"w": (K, N), "b": (N,)}, ...}`` of numpy arrays → the same
    dict of float32 tensors on `device`."""
    dev = resolve_device(device)
    return {name: {k: _tensor(v, dev) for k, v in layer.items()} for name, layer in params.items()}


def frozen_from_numpy(
    a_mins,
    a_maxs,
    deltas,
    zs,
    *,
    quantized: bool,
    n_bits: int,
    fxp32_phase1: bool,
    device: DeviceLike = None,
) -> FrozenQuant:
    """A reference `FrozenQuant`'s fields (numpy (L,) arrays and its static
    flags) → the port's `FrozenQuant` on `device`."""
    dev = resolve_device(device)
    return FrozenQuant(
        a_mins=_tensor(a_mins, dev),
        a_maxs=_tensor(a_maxs, dev),
        deltas=_tensor(deltas, dev),
        zs=_tensor(zs, dev),
        quantized=bool(quantized),
        n_bits=int(n_bits),
        fxp32_phase1=bool(fxp32_phase1),
    )


def ddpg_state_from_numpy(state, *, device: DeviceLike = None) -> DDPGState:
    """A reference `DDPGState` taken to numpy leaf by leaf (for example
    `jax.tree.map(np.asarray, state)`, which keeps its attribute layout and
    the static QAT config) → the port's `DDPGState` on `device`: the four
    nets, both Adam states with their steps, the QAT step and every site's
    `RangeStat`."""
    dev = resolve_device(device)
    i32 = lambda a: _tensor(a, dev, np.int32)  # noqa: E731

    def adam(s) -> AdamState:
        return AdamState(step=i32(s.step), mu=actor_from_numpy(s.mu, device=dev), nu=actor_from_numpy(s.nu, device=dev))

    c = state.qat.config
    qat = QATState(
        config=QATConfig(delay=int(c.delay), n_bits=int(c.n_bits), enabled=bool(c.enabled), monitor=str(c.monitor),
                         fxp32_phase1=bool(c.fxp32_phase1)),
        step=i32(state.qat.step),
        ranges={
            name: RangeStat(a_min=_tensor(r.a_min, dev), a_max=_tensor(r.a_max, dev), count=i32(r.count))
            for name, r in state.qat.ranges.items()
        },
    )
    return DDPGState(
        actor=actor_from_numpy(state.actor, device=dev),
        critic=actor_from_numpy(state.critic, device=dev),
        actor_target=actor_from_numpy(state.actor_target, device=dev),
        critic_target=actor_from_numpy(state.critic_target, device=dev),
        actor_opt=adam(state.actor_opt),
        critic_opt=adam(state.critic_opt),
        qat=qat,
        step=i32(state.step),
    )


def ddpg_state_to_numpy(state: DDPGState) -> DDPGState:
    """The port's `DDPGState` with every tensor copied to a numpy array of
    its dtype (the counters int32), the layout kept: `ddpg_state_from_numpy`
    takes it back.  `repro_torch.tree.leaves` lists its leaves in the
    order of `jax.tree_util.tree_leaves` over the reference's state, so
    `jax.tree_util.tree_unflatten` of a reference state's treedef over
    them builds the reference's `DDPGState`."""
    return tree.tree_map(lambda t: t.detach().cpu().numpy(), state)


def _np_to_torch(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: carry the bits across
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def _tree_from_numpy(tree, dev: torch.device, dtype=None):
    """dicts, lists and range stats (anything with `a_min`, `a_max`,
    `count`) of arrays → the same tree of tensors on `dev` (cast to `dtype`
    when given)."""
    if isinstance(tree, dict):
        return {k: _tree_from_numpy(v, dev, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_from_numpy(v, dev, dtype) for v in tree]
    if all(hasattr(tree, f) for f in ("a_min", "a_max", "count")):
        return RangeStat(a_min=_tensor(tree.a_min, dev), a_max=_tensor(tree.a_max, dev),
                         count=_tensor(tree.count, dev, np.int32))
    t = _np_to_torch(tree)
    return t.to(dev) if dtype is None else t.to(dev, dtype)


def _tree_to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _tree_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_to_numpy(v) for v in tree]
    if isinstance(tree, RangeStat):
        return RangeStat(*(_tree_to_numpy(getattr(tree, f)) for f in ("a_min", "a_max", "count")))
    t = tree.detach().cpu()
    return (t.to(torch.float32) if t.dtype == torch.bfloat16 else t).numpy()


def lm_params_from_numpy(params: dict, *, device: DeviceLike = None) -> dict:
    """The reference's LM param tree (`models.transformer.init_params`
    layout, numpy leaves) → the port's, float32 tensors on `device`."""
    return _tree_from_numpy(params, resolve_device(device), torch.float32)


def lm_params_to_numpy(params: dict) -> dict:
    """The port's LM param tree → the same tree of numpy arrays."""
    return _tree_to_numpy(params)


def lm_ranges_from_numpy(ranges: dict, *, device: DeviceLike = None) -> dict:
    """The reference's QAT range tree (`init_ranges` layout: RangeStats of
    stacked (n,) arrays) → the port's on `device`."""
    return _tree_from_numpy(ranges, resolve_device(device))


def lm_ranges_to_numpy(ranges: dict) -> dict:
    return _tree_to_numpy(ranges)


def lm_cache_from_numpy(cache: dict, cfg: ModelConfig, *, device: DeviceLike = None) -> dict:
    """The reference's decode-cache tree (`init_cache` layout) → the port's
    on `device`: K/V in `cfg`'s compute dtype, the recurrent states
    (RWKV-6 "wkv", "x_tm", "x_cm"; RG-LRU "h", "conv") in float32, as the
    reference keeps them under any compute dtype."""
    dev = resolve_device(device)

    def layer(slot: dict) -> dict:
        return {name: _np_to_torch(a).to(dev, cfg.compute_dtype if name in ("k", "v") else torch.float32)
                for name, a in slot.items()}

    return {part: [layer(slot) for slot in cache[part]] for part in ("scan", "tail")}


def lm_cache_to_numpy(cache: dict) -> dict:
    return _tree_to_numpy(cache)


__all__ = ["actor_from_numpy", "frozen_from_numpy", "ddpg_state_from_numpy", "ddpg_state_to_numpy",
           "lm_params_from_numpy", "lm_params_to_numpy", "lm_ranges_from_numpy", "lm_ranges_to_numpy",
           "lm_cache_from_numpy", "lm_cache_to_numpy"]
