"""Carry weights and frozen quantizers across from the JAX reference.

Both functions take numpy arrays (convert on the JAX side with
`np.asarray`), so this module imports nothing from JAX or `repro`:

  * `actor_from_numpy` — the reference's actor params
    ``{"l0": {"w", "b"}, ...}`` → the port's params on `device`;
  * `frozen_from_numpy` — a reference `FrozenQuant`'s fields → the port's
    `FrozenQuant` on `device`;
  * `ddpg_state_from_numpy` — a whole reference `DDPGState` (nets, targets,
    Adam states, QAT state) → the port's `DDPGState` on `device`.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.qat import FrozenQuant, QATConfig, QATState
from repro_torch.core.ranges import RangeStat
from repro_torch.device import DeviceLike, resolve_device
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


__all__ = ["actor_from_numpy", "frozen_from_numpy", "ddpg_state_from_numpy"]
