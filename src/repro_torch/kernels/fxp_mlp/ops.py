"""Public wrappers for the fused MLP forward (port of the forward half of
`repro.kernels.fxp_mlp.ops`).

`fxp_mlp_forward` runs the whole L-layer forward, QAT sites included, and
returns (y, site_mins, site_maxs) like the reference.  CPU tensors take the
plain version (`ref.ref_mlp_forward`); CUDA tensors take kernel B
(`kernel.fxp_mlp_fwd_cuda`, one launch), whose per-block monitor rows are
reduced here, as the reference wrapper reduces its (n_blocks, L) outputs.
No padding: the kernel masks ragged rows and columns itself, so padded
values never reach the range monitors.

The training faces (`fxp_mlp_train`, `fxp_mlp_train_step`) belong to the
training slice.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.device import check_same_device
from repro_torch.kernels._compat import mlp_flops
from repro_torch.kernels.fxp_mlp.kernel import fxp_mlp_fwd_cuda
from repro_torch.kernels.fxp_mlp.ref import ref_mlp_forward

Tensor = torch.Tensor


def _norm_quant_params(deltas, zs, n_layers: int, qat: bool, device):
    """(L,) float32 deltas/zs on `device`; (None, None) when qat is off,
    since neither version reads them then."""
    if not qat:
        return None, None
    if deltas is None or zs is None:
        raise ValueError(
            "qat=True requires both deltas and zs (the per-site affine "
            "operands of a FrozenQuant); pass qat=False for the site-free pipeline"
        )
    return (
        torch.as_tensor(deltas, dtype=torch.float32, device=device).reshape(n_layers),
        torch.as_tensor(zs, dtype=torch.float32, device=device).reshape(n_layers),
    )


def fxp_mlp_forward(
    x: Tensor,
    weights: Sequence[Tensor],
    biases: Sequence[Tensor],
    deltas: Optional[Tensor] = None,
    zs: Optional[Tensor] = None,
    *,
    activations: Sequence[str],
    quant_phase,
    n_bits: int = 16,
    qat: bool = True,
    fxp32_phase1: bool = True,
) -> tuple[Tensor, Tensor, Tensor]:
    """Fused L-layer MLP forward with inline QAT sites.

    x: (..., K0) f32.  weights[i]: (K_i, N_i), biases[i]: (N_i,).
    activations[i] in {"relu", "tanh", "none"}.  quant_phase: the
    Algorithm-1 phase flag (False = monitor/full precision, True =
    quantized/half precision), a bool or a 0-d tensor (read on the host).
    deltas/zs: (L,) per-site affine operands; ignored when qat=False.

    Returns (y, site_mins, site_maxs): y is (..., N_L); site_mins/maxs are
    the (L,) exact extrema of each layer's pre-quantization input.
    """
    n_layers = len(weights)
    if not n_layers == len(biases) == len(activations):
        raise ValueError(f"{n_layers} weights vs {len(biases)} biases vs {len(activations)} activations")
    orig_shape = x.shape
    if weights[0].shape[0] != orig_shape[-1]:
        raise ValueError(f"layer-0 input dim {weights[0].shape[0]} != x feature dim {orig_shape[-1]}")
    x2 = x.reshape(-1, orig_shape[-1]).to(torch.float32)
    ws = [w.to(torch.float32) for w in weights]
    bs = [b.to(torch.float32) for b in biases]
    dev = check_same_device(x2, *ws, *bs)
    deltas, zs = _norm_quant_params(deltas, zs, n_layers, qat, dev)
    quant = bool(quant_phase)
    if dev.type == "cpu":
        y, mins, maxs = ref_mlp_forward(
            x2, ws, bs, deltas, zs, activations=activations, quant=quant,
            n_bits=n_bits, qat=qat, fxp32_phase1=fxp32_phase1,
        )
    elif dev.type == "cuda":
        y, block_mins, block_maxs = fxp_mlp_fwd_cuda(
            x2.contiguous(), [w.contiguous() for w in ws], [b.contiguous() for b in bs],
            None if deltas is None else deltas.contiguous(),
            None if zs is None else zs.contiguous(), activations=activations, quant=quant,
            qat=qat, n_bits=n_bits, fxp32_phase1=fxp32_phase1,
        )
        mins, maxs = block_mins.amin(dim=0), block_maxs.amax(dim=0)
    else:
        raise ValueError(f"fxp_mlp_forward runs on 'cpu' or 'cuda' tensors, got {dev}")
    return y.reshape(*orig_shape[:-1], ws[-1].shape[-1]), mins, maxs


def fxp_mlp_infer(
    x: Tensor,
    weights: Sequence[Tensor],
    biases: Sequence[Tensor],
    deltas: Optional[Tensor] = None,
    zs: Optional[Tensor] = None,
    *,
    activations: Sequence[str],
    quant_phase,
    n_bits: int = 16,
    fxp32_phase1: bool = True,
) -> Tensor:
    """Serving entry point: the fused forward with the range monitors
    dropped, so nothing downstream can fold them into a live QAT state.
    Pass deltas/zs=None for the QAT-free pipeline."""
    qat = deltas is not None and zs is not None
    y, _, _ = fxp_mlp_forward(
        x, weights, biases, deltas, zs, activations=activations, quant_phase=quant_phase,
        n_bits=n_bits, qat=qat, fxp32_phase1=fxp32_phase1,
    )
    return y.detach()


def fused_cost_hint(dims: Sequence[int], phase: str = "act") -> dict:
    """Dispatcher hook: launch/FLOP shape of the fused path — the whole
    network in ONE launch, batch as the only grid axis.  phase="train" is a
    forward+backward step: 2 launches and ~3x the MACs."""
    if phase == "train":
        return {"launches": 2, "flops_per_item": 3 * mlp_flops(dims), "parallelism": "intra_batch"}
    if phase != "act":
        raise ValueError(f"unknown cost phase {phase!r}; 'act' | 'train'")
    return {"launches": 1, "flops_per_item": mlp_flops(dims), "parallelism": "intra_batch"}


__all__ = ["fxp_mlp_forward", "fxp_mlp_infer", "fused_cost_hint"]
