"""Exploration noise — the PRNG module of Fig. 2 (port of `repro.rl.noise`).

A frozen `NoiseProcess` config plus an explicit `NoiseState` carry:

    proc = NoiseProcess(kind="ou", sigma=0.2)
    state = proc.init((n_envs, act_dim), device=dev)
    state, eps = proc.sample(state, generator)

`kind="gaussian"` is i.i.d. noise (the carry is returned untouched),
`kind="ou"` the Ornstein-Uhlenbeck process of the original DDPG paper,
`kind="none"` no exploration.  `advance` is the same step given the
standard-normal draws, so a test can feed both ports the same numbers.

The reference's deprecated free functions (`ou_init`, `ou_step`,
`gaussian`, the `OUState` alias) are kept as shims over `NoiseProcess`;
each warns with a `DeprecationWarning`, and where the reference takes a
JAX key they take a `torch.Generator`.
"""

from __future__ import annotations

import dataclasses
import warnings

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.numerics import sqrt_rn

Tensor = torch.Tensor

KINDS = ("gaussian", "ou", "none")


@dataclasses.dataclass
class NoiseState:
    x: Tensor  # process carry: the OU state; zeros for the i.i.d. kinds


@dataclasses.dataclass(frozen=True)
class NoiseProcess:
    """Static exploration-noise config."""

    kind: str = "gaussian"  # "gaussian" | "ou" | "none"
    sigma: float = 0.1  # gaussian stddev / OU volatility
    theta: float = 0.15  # OU mean-reversion rate
    dt: float = 1e-2  # OU integration step

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown noise kind {self.kind!r}; expected one of {KINDS}")

    def init(self, shape, *, device: DeviceLike = None) -> NoiseState:
        return NoiseState(x=torch.zeros(shape, dtype=torch.float32, device=resolve_device(device)))

    def advance(self, state: NoiseState, normal: Tensor) -> tuple[NoiseState, Tensor]:
        """One step given standard-normal draws of `state.x.shape`:
        (new_state, eps)."""
        if self.kind == "none":
            return state, torch.zeros_like(state.x)
        if self.kind == "gaussian":
            return state, self.sigma * normal
        sqrt_dt = sqrt_rn(torch.full((), self.dt, dtype=torch.float32, device=state.x.device))
        x = state.x + self.theta * (-state.x) * self.dt + self.sigma * sqrt_dt * normal
        return NoiseState(x=x), x

    def sample(self, state: NoiseState, generator: torch.Generator) -> tuple[NoiseState, Tensor]:
        """One noise draw of `state.x.shape`: (new_state, eps)."""
        if self.kind == "none":
            return self.advance(state, None)
        normal = torch.randn(state.x.shape, generator=generator, device=generator.device)
        return self.advance(state, normal.to(state.x.device))


# --------------------------------------------------------------------- #
# Deprecation shims — the pre-redesign free-function surface.
# --------------------------------------------------------------------- #


def _warn(old: str, new: str) -> None:
    warnings.warn(f"repro_torch.rl.noise.{old} is deprecated; use {new}", DeprecationWarning, stacklevel=3)


def ou_init(shape, *, device: DeviceLike = None) -> NoiseState:
    """Deprecated: use ``NoiseProcess(kind='ou').init(shape)``."""
    _warn("ou_init", "NoiseProcess(kind='ou').init(shape)")
    return NoiseProcess(kind="ou").init(shape, device=device)


def ou_step(state: NoiseState, generator: torch.Generator, *, theta: float = 0.15, sigma: float = 0.2,
            dt: float = 1e-2) -> tuple[NoiseState, Tensor]:
    """Deprecated: use ``NoiseProcess(kind='ou', ...).sample(state, generator)``."""
    _warn("ou_step", "NoiseProcess(kind='ou', ...).sample(state, generator)")
    return NoiseProcess(kind="ou", sigma=sigma, theta=theta, dt=dt).sample(state, generator)


def gaussian(generator: torch.Generator, shape, sigma: float = 0.1, *, device: DeviceLike = None) -> Tensor:
    """Deprecated: use ``NoiseProcess(kind='gaussian', sigma=...).sample``."""
    _warn("gaussian", "NoiseProcess(kind='gaussian', sigma=...).sample")
    proc = NoiseProcess(kind="gaussian", sigma=sigma)
    _, eps = proc.sample(proc.init(shape, device=device if device is not None else generator.device), generator)
    return eps


# the old OUState name aliased the same single-field carry
OUState = NoiseState

__all__ = ["KINDS", "NoiseState", "NoiseProcess", "ou_init", "ou_step", "gaussian", "OUState"]
