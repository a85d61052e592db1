"""Quantization-Aware Training state for DRL — FIXAR Algorithm 1 (port of
`repro.core.qat`).

    for t = 1..T:
        if t < d:  activations fxp32, monitor A_min, A_max
        else:      activations quantized to n bits with the captured ranges

`QATState` carries the step counter and the per-site range monitors.
`QATContext` is what one training step uses: `site` applies a QAT site
inline (range monitor + phase-selected fake quantizer with its STE),
`observe` folds extrema that a kernel measured on-chip, `site_quant_params`
hands the fused kernel its per-site affine operands, and `finalize` returns
the state with the new ranges.  `freeze_quant` snapshots the finalized
ranges into a `FrozenQuant`, the only QAT object the serving path holds.

The phase flag: range updates are selected on the device with `torch.where`
on `QATState.quantized_phase`, as the reference selects them.  The choice of
datapath (which quantizer, which kernel mode) is a host decision on the
plain-PyTorch sites, so a `QATContext` reads the phase once (or takes it
from the caller, who read it once per update) and every site and kernel
launch of that step uses that Python bool.  The fused kernels can read the
phase on the device instead (`quant_operand`), so acting and the fused
update need no host read, and a CUDA graph can capture them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import fixedpoint as fxp
from repro_torch.core.ranges import (
    RangeStat,
    finalized,
    init_ranges,
    update_ema_scalar,
    update_minmax_scalar,
)
from repro_torch import tree
from repro_torch.device import DeviceLike, resolve_device

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class QATConfig:
    """Static QAT hyperparameters."""

    delay: int = 0
    n_bits: int = 16
    enabled: bool = True
    # "minmax" (paper) or "ema" (beyond-paper robust option)
    monitor: str = "minmax"
    # project full-precision activations onto the Q15.16 lattice (paper: the
    # accelerator is fixed-point from step 0)
    fxp32_phase1: bool = True


@dataclasses.dataclass
class QATState:
    """Dynamic QAT state: config, step counter, per-site running ranges."""

    config: QATConfig
    step: Tensor  # i32 scalar
    ranges: dict[str, RangeStat]

    @staticmethod
    def init(
        delay: int,
        sites: list[str],
        n_bits: int = 16,
        enabled: bool = True,
        monitor: str = "minmax",
        fxp32_phase1: bool = True,
        *,
        device: DeviceLike = None,
    ) -> "QATState":
        dev = resolve_device(device)
        return QATState(
            config=QATConfig(
                delay=delay,
                n_bits=n_bits,
                enabled=enabled,
                monitor=monitor,
                fxp32_phase1=fxp32_phase1,
            ),
            step=torch.tensor(0, dtype=torch.int32, device=dev),
            ranges=init_ranges(sites, dev),
        )

    @property
    def quantized_phase(self) -> Tensor:
        """Boolean scalar: past the quantization delay?"""
        return self.step >= self.config.delay

    def tick(self) -> "QATState":
        return dataclasses.replace(self, step=self.step + 1)

    def to(self, device) -> "QATState":
        """The same state with its tensors on `device`."""
        return dataclasses.replace(
            self, step=self.step.to(device), ranges={k: v.to(device) for k, v in self.ranges.items()}
        )


class QATContext:
    """The QAT sites of one training step.

    Collects the per-site range updates made by `site()`/`observe()` calls
    and returns the new state from `finalize()`.  `quant` is the phase as a
    host bool; None reads `state.quantized_phase` once, on first use.
    """

    def __init__(self, state: QATState, quant: Optional[bool] = None):
        self.state = state
        self._quant = quant
        self._new_ranges: dict[str, RangeStat] = dict(state.ranges)

    @property
    def quant(self) -> bool:
        """The phase as a host bool: past the quantization delay?"""
        if self._quant is None:
            self._quant = bool(self.state.quantized_phase)
        return self._quant

    @property
    def quant_operand(self):
        """The phase for a fused-kernel launch: the host bool when this
        context was given one, else the device-side flag (no host read;
        the kernel reads it)."""
        return self.state.quantized_phase if self._quant is None else self._quant

    def _check(self, name: str) -> None:
        if name not in self.state.ranges:
            raise KeyError(f"QAT site {name!r} not registered; known: {sorted(self.state.ranges)[:8]}...")

    def site(self, name: str, x: Tensor) -> Tensor:
        """Monitor `x` (monitor phase only) and return it fake-quantized:
        onto the n-bit affine grid of the captured range in the quant phase,
        onto Q15.16 (or unchanged) before it.  STE gradient either way."""
        cfg = self.state.config
        if not cfg.enabled:
            return x
        self._check(name)
        self.observe(name, x.min(), x.max())
        if self.quant:
            a_min, a_max = finalized(self._new_ranges[name])
            return fxp.fake_quant_affine(x, a_min, a_max, cfg.n_bits)
        return fxp.fake_quant(x, fxp.FXP32) if cfg.fxp32_phase1 else x

    def observe(self, name: str, mn: Tensor, mx: Tensor) -> None:
        """Fold externally computed site extrema into the running ranges,
        kept only in the monitor phase (a `torch.where` on the device-side
        phase, as the reference has it)."""
        cfg = self.state.config
        if not cfg.enabled:
            return
        self._check(name)
        stat = self._new_ranges[name]
        upd = update_minmax_scalar if cfg.monitor == "minmax" else update_ema_scalar
        cand = upd(stat, mn.detach(), mx.detach())
        phase = self.state.quantized_phase
        self._new_ranges[name] = RangeStat(
            a_min=torch.where(phase, stat.a_min, cand.a_min),
            a_max=torch.where(phase, stat.a_max, cand.a_max),
            count=torch.where(phase, stat.count, cand.count),
        )

    def site_quant_params(self, names: list[str]) -> tuple[Tensor, Tensor]:
        """Stacked (deltas, zs) affine operands of `names` from the current
        finalized ranges — what the fused kernel reads in its quant phase."""
        cfg = self.state.config
        deltas, zs = [], []
        for name in names:
            a_min, a_max = finalized(self._new_ranges[name])
            d, z = fxp.affine_params(a_min, a_max, cfg.n_bits)
            deltas.append(d)
            zs.append(z.to(torch.float32))
        return torch.stack(deltas), torch.stack(zs)

    def finalize(self) -> QATState:
        return dataclasses.replace(self.state, ranges=self._new_ranges)


@dataclasses.dataclass(frozen=True)
class FrozenQuant:
    """Inference-time snapshot of per-site quantization parameters.

    The serving engine never touches live range monitors: it holds only this
    snapshot.  `a_mins`/`a_maxs` feed `fake_quant_affine` (the `layer` and
    `jnp` modes); `deltas`/`zs` are the fused kernel's operands.
    """

    a_mins: Tensor  # (L,) finalized per-site range minima
    a_maxs: Tensor  # (L,)
    deltas: Tensor  # (L,) affine scale per site (fused-kernel operand)
    zs: Tensor  # (L,) affine zero point per site, float32
    quantized: bool = True
    n_bits: int = 16
    fxp32_phase1: bool = True

    def site(self, i: int, x: Tensor) -> Tensor:
        """Apply site `i`'s frozen quantizer (sans monitoring)."""
        if self.quantized:
            return fxp.fake_quant_affine(x, self.a_mins[i], self.a_maxs[i], self.n_bits)
        return fxp.fake_quant(x, fxp.FXP32) if self.fxp32_phase1 else x

    def to(self, device) -> "FrozenQuant":
        """The same snapshot with its tensors on `device`."""
        return dataclasses.replace(
            self,
            a_mins=self.a_mins.to(device),
            a_maxs=self.a_maxs.to(device),
            deltas=self.deltas.to(device),
            zs=self.zs.to(device),
        )


def freeze_quant(state: QATState, sites: list[str]) -> Optional[FrozenQuant]:
    """Snapshot `sites`' quant params for serving; None when QAT is off.

    Reads the step counter once on the host (freeze time, not serve time)
    so the phase becomes a plain bool of the snapshot.
    """
    cfg = state.config
    if not cfg.enabled:
        return None
    a_mins, a_maxs, deltas, zs = [], [], [], []
    for name in sites:
        if name not in state.ranges:
            raise KeyError(f"QAT site {name!r} not registered; known: {sorted(state.ranges)[:8]}...")
        a_min, a_max = finalized(state.ranges[name])
        d, z = fxp.affine_params(a_min, a_max, cfg.n_bits)
        a_mins.append(a_min)
        a_maxs.append(a_max)
        deltas.append(d)
        zs.append(z.to(torch.float32))
    return FrozenQuant(
        a_mins=torch.stack(a_mins),
        a_maxs=torch.stack(a_maxs),
        deltas=torch.stack(deltas),
        zs=torch.stack(zs),
        quantized=bool(state.quantized_phase),
        n_bits=cfg.n_bits,
        fxp32_phase1=cfg.fxp32_phase1,
    )


def quantize_weights(params, enabled: bool = True):
    """Project every weight of a parameter tree (`repro_torch.tree`'s
    walk) onto the Q15.16 lattice (STE): FIXAR keeps weights fxp32 for the
    whole run."""
    if not enabled:
        return params
    return tree.tree_map(lambda t: fxp.fake_quant(t, fxp.FXP32), params)


def quantize_grads(grads, enabled: bool = True):
    """Gradients are fxp32 too (the gradient memory is 32-bit BRAM)."""
    return quantize_weights(grads, enabled)


__all__ = [
    "QATConfig",
    "QATState",
    "QATContext",
    "FrozenQuant",
    "freeze_quant",
    "quantize_weights",
    "quantize_grads",
]
