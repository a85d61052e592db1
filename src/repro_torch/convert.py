"""Carry weights and frozen quantizers across from the JAX reference.

Both functions take numpy arrays (convert on the JAX side with
`np.asarray`), so this module imports nothing from JAX or `repro`:

  * `actor_from_numpy` — the reference's actor params
    ``{"l0": {"w", "b"}, ...}`` → the port's params on `device`;
  * `frozen_from_numpy` — a reference `FrozenQuant`'s fields → the port's
    `FrozenQuant` on `device`.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.qat import FrozenQuant
from repro_torch.device import DeviceLike, resolve_device


def _tensor(a, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True)).to(dev)


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


__all__ = ["actor_from_numpy", "frozen_from_numpy"]
