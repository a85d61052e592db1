"""Per-site activation range monitoring (Algorithm 1's A_min/A_max capture),
port of `repro.core.ranges`.

A `RangeStat` holds 0-d float32 tensors for the running extrema and a 0-d
int32 update count.  The fused MLP kernel hands back exact per-site
(min, max) scalars; `update_minmax_scalar` (the paper's running min/max) or
`update_ema_scalar` (the beyond-paper EMA option, `QATConfig.monitor="ema"`)
folds them in.  `update_minmax`/`update_ema` reduce a tensor first.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import DeviceLike, resolve_device

Tensor = torch.Tensor


@dataclasses.dataclass
class RangeStat:
    """Running activation range for one quantization site."""

    a_min: Tensor  # f32 scalar
    a_max: Tensor  # f32 scalar
    count: Tensor  # i32 scalar — number of updates folded in

    @staticmethod
    def init(device: DeviceLike = None) -> "RangeStat":
        dev = resolve_device(device)
        return RangeStat(
            a_min=torch.tensor(float("inf"), dtype=torch.float32, device=dev),
            a_max=torch.tensor(float("-inf"), dtype=torch.float32, device=dev),
            count=torch.tensor(0, dtype=torch.int32, device=dev),
        )

    def to(self, device) -> "RangeStat":
        return RangeStat(self.a_min.to(device), self.a_max.to(device), self.count.to(device))


def update_minmax_scalar(stat: RangeStat, mn: Tensor, mx: Tensor) -> RangeStat:
    """Fold pre-reduced extrema (e.g. from the fused MLP kernel's on-chip
    monitor) into the running min/max."""
    mn = torch.as_tensor(mn, dtype=torch.float32, device=stat.a_min.device)
    mx = torch.as_tensor(mx, dtype=torch.float32, device=stat.a_max.device)
    return RangeStat(
        a_min=torch.minimum(stat.a_min, mn),
        a_max=torch.maximum(stat.a_max, mx),
        count=stat.count + 1,
    )


def update_minmax(stat: RangeStat, x: Tensor) -> RangeStat:
    """Paper-faithful running min/max."""
    return update_minmax_scalar(stat, x.min(), x.max())


def update_ema_scalar(stat: RangeStat, mn: Tensor, mx: Tensor, momentum: float = 0.99) -> RangeStat:
    """EMA fold of pre-reduced extrema (see update_minmax_scalar); the first
    update takes the extrema as they are.  The `(1 - momentum)` complement
    is folded in Python double and cast, as the reference's weak-typed
    constant is."""
    mn = torch.as_tensor(mn, dtype=torch.float32, device=stat.a_min.device)
    mx = torch.as_tensor(mx, dtype=torch.float32, device=stat.a_max.device)
    first = stat.count == 0
    new_min = torch.where(first, mn, momentum * stat.a_min + (1 - momentum) * mn)
    new_max = torch.where(first, mx, momentum * stat.a_max + (1 - momentum) * mx)
    return RangeStat(new_min, new_max, stat.count + 1)


def update_ema(stat: RangeStat, x: Tensor, momentum: float = 0.99) -> RangeStat:
    """EMA variant (beyond-paper option, robust to outlier spikes)."""
    return update_ema_scalar(stat, x.min(), x.max(), momentum)


def finalized(stat: RangeStat) -> tuple[Tensor, Tensor]:
    """Ranges with the never-updated guard (degenerate -> [-1, 1]) and the
    span guard (a constant site widens by ±0.5)."""
    bad = stat.count == 0
    a_min = torch.where(bad, torch.full_like(stat.a_min, -1.0), stat.a_min)
    a_max = torch.where(bad, torch.full_like(stat.a_max, 1.0), stat.a_max)
    span_ok = (a_max - a_min) > 1e-6
    return (torch.where(span_ok, a_min, a_min - 0.5), torch.where(span_ok, a_max, a_max + 0.5))


def init_ranges(site_names: list[str], device: DeviceLike = None) -> dict[str, RangeStat]:
    dev = resolve_device(device)
    return {name: RangeStat.init(dev) for name in site_names}


__all__ = [
    "RangeStat",
    "update_minmax",
    "update_minmax_scalar",
    "update_ema",
    "update_ema_scalar",
    "finalized",
    "init_ranges",
]
