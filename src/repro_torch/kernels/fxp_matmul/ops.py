"""Public wrapper for the dual-precision dense layer (port of
`repro.kernels.fxp_matmul.ops`).

`fxp_dense` flattens (..., K) to (M, K) and takes the plain version
(`ref.ref_fxp_dense`) for CPU tensors and kernel A (`kernel.fxp_dense_cuda`)
for CUDA tensors — by the device of the tensors it is given, never by what
the machine has.  No padding: the kernel masks ragged shapes itself.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.device import check_same_device
from repro_torch.kernels._compat import mlp_flops
from repro_torch.kernels.fxp_matmul.kernel import fxp_dense_cuda
from repro_torch.kernels.fxp_matmul.ref import ref_fxp_dense

Tensor = torch.Tensor


def fxp_dense(
    x: Tensor,
    w: Tensor,
    b: Optional[Tensor] = None,
    *,
    full_precision: bool = True,
    activation: str = "none",
) -> Tensor:
    """Dual-precision dense layer: act(x @ w + b).

    x: (..., K) — flattened to (M, K).  w: (K, N).  b: (N,) or None.
    full_precision=True  -> two-pass limb datapath (pre-delay, fxp32 regime)
    full_precision=False -> one pass (post-delay, quantized activations)
    """
    orig_shape = x.shape
    k = orig_shape[-1]
    n = w.shape[-1]
    x2 = x.reshape(-1, k).to(torch.float32)
    w = w.to(torch.float32)
    b = None if b is None else b.to(torch.float32)
    dev = check_same_device(x2, w, b)
    if dev.type == "cpu":
        y = ref_fxp_dense(x2, w, b, full_precision=full_precision, activation=activation)
    elif dev.type == "cuda":
        y = fxp_dense_cuda(
            x2.contiguous(),
            w.contiguous(),
            None if b is None else b.contiguous(),
            full_precision=full_precision,
            activation=activation,
        )
    else:
        raise ValueError(f"fxp_dense runs on 'cpu' or 'cuda' tensors, got {dev}")
    return y.reshape(*orig_shape[:-1], n)


def fxp_dense_chain(
    x: Tensor,
    weights,
    biases,
    *,
    activations,
    full_precision: bool = True,
    site_fn=None,
) -> Tensor:
    """Serving entry point: the per-layer kernel chain with a fixed
    precision phase — intra-layer parallelism, one launch per layer.
    `site_fn(i, x)`, when given, applies the frozen quantizer in front of
    layer `i` (see `core.qat.FrozenQuant.site`)."""
    for i, (w, b, act) in enumerate(zip(weights, biases, activations)):
        if site_fn is not None:
            x = site_fn(i, x)
        x = fxp_dense(x, w, b, full_precision=full_precision, activation=act)
    return x


def chain_cost_hint(dims, phase: str = "act") -> dict:
    """Dispatcher hook: launch/FLOP shape of the per-layer chain for an MLP
    with layer dims `dims`.  phase="train" keeps the dispatcher's phase axis
    total (the chain has no backward)."""
    if phase == "train":
        return {
            "launches": 2 * (len(dims) - 1),
            "flops_per_item": 3 * mlp_flops(dims),
            "parallelism": "intra_layer",
        }
    if phase != "act":
        raise ValueError(f"unknown cost phase {phase!r}; 'act' | 'train'")
    return {"launches": len(dims) - 1, "flops_per_item": mlp_flops(dims), "parallelism": "intra_layer"}


__all__ = ["fxp_dense", "fxp_dense_chain", "chain_cost_hint"]
