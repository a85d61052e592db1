"""Quantization-Aware Training state for DRL — FIXAR Algorithm 1, the
serving subset of `repro.core.qat`.

    for t = 1..T:
        if t < d:  activations fxp32, monitor A_min, A_max
        else:      activations quantized to n bits with the captured ranges

`QATState` carries the step counter and the per-site range monitors;
`freeze_quant` snapshots its finalized ranges into a `FrozenQuant`, the only
QAT object the serving path holds.  `FrozenQuant.quantized` is a plain
Python bool, so a serving call picks its one datapath on the host.
`QATContext` (in-graph monitoring during training) belongs to the training
slice.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import fixedpoint as fxp
from repro_torch.core.ranges import RangeStat, finalized, init_ranges
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


__all__ = ["QATConfig", "QATState", "FrozenQuant", "freeze_quant"]
