"""Public wrappers for the fused monitor + quantizer (port of
`repro.kernels.quantize.ops`) and the QAT site bookkeeping (kernel 7).

`monitor_quant` takes the plain version (`ref.ref_monitor_quant`) for a CPU
tensor and kernel 6 (`kernel.monitor_quant_cuda`) for a CUDA tensor — by
the device of the tensor it is given, never by what the machine has.  On
the card it reads nothing on the host: a Python range or phase becomes a
device fill, a tensor one is cast on the device, so a captured CUDA graph
can hold the call.

`qat_site_params` and `qat_fold` take `RangeStat`s: on CPU tensors the
plain ops (`ref.ref_qat_site_params`, `ref.ref_qat_fold`), on CUDA tensors
kernel 7, one launch a call, bit for bit the plain ops on the card.
"""

from __future__ import annotations

import torch

from repro_torch.core.ranges import RangeStat
from repro_torch.kernels.quantize.kernel import monitor_quant_cuda, qat_fold_cuda, qat_site_params_cuda
from repro_torch.kernels.quantize.ref import ref_monitor_quant, ref_qat_fold, ref_qat_site_params

Tensor = torch.Tensor


def _device_scalar(v, dtype, device) -> Tensor:
    if isinstance(v, Tensor):
        if v.device != device:
            raise ValueError(f"a range or phase tensor on {v.device}, data on {device}")
        return v.reshape(1).to(dtype)
    return torch.full((1,), v, dtype=dtype, device=device)


def monitor_quant(x: Tensor, a_min, a_max, quant_phase, *, n_bits: int = 16) -> tuple[Tensor, Tensor, Tensor]:
    """Fused Algorithm-1 activation stage.

    Returns (y, new_min, new_max): y is the phase-selected projection of x
    (Q15.16 while `quant_phase` is false, the n-bit affine grid of the
    incoming range once it is true); the ranges update only while
    `quant_phase` is false.  a_min, a_max: floats or 0-d tensors;
    quant_phase: a bool or a 0-d bool/int tensor (on x's device)."""
    dev = x.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"monitor_quant runs on 'cpu' or 'cuda' tensors, got {dev}")
    # an int32 flag, quant phase when > 0, as the reference's kernel reads it
    if isinstance(quant_phase, Tensor):
        phase = _device_scalar(quant_phase, torch.int32, dev)
    else:
        phase = _device_scalar(int(bool(quant_phase)), torch.int32, dev)
    if dev.type == "cpu":
        return ref_monitor_quant(x, a_min, a_max, phase > 0, n_bits)
    y, new_min, new_max = monitor_quant_cuda(
        x.to(torch.float32).reshape(-1).contiguous(),
        _device_scalar(a_min, torch.float32, dev),
        _device_scalar(a_max, torch.float32, dev),
        phase,
        n_bits=n_bits,
    )
    return y.reshape(x.shape), new_min, new_max


def qat_site_params(stats, n_bits: int = 16) -> tuple[Tensor, Tensor]:
    """(deltas (L,), zs (L,)), float32: the affine operands of each site's
    finalized range (`core.ranges.finalized`, `core.fixedpoint.affine_params`)
    — what the fused kernels read in their quant phase."""
    if stats[0].a_min.device.type != "cuda":
        return ref_qat_site_params(stats, n_bits)
    return qat_site_params_cuda([s.a_min for s in stats], [s.a_max for s in stats], [s.count for s in stats],
                                n_bits=n_bits)


def qat_fold(stats, step: Tensor, folds, *, delay: int, tick: bool = False) -> tuple[list, Tensor]:
    """Fold each (site index, mn, mx) of `folds` in order into `stats[site]`
    by the running min/max (count + 1), only while `step` is before `delay`
    (read on the device); returns the new `RangeStat`s and the step, plus one
    when `tick`."""
    if step.device.type != "cuda":
        return ref_qat_fold(stats, step, folds, delay=delay, tick=tick)
    a_mins, a_maxs, counts, new_step = qat_fold_cuda(
        [s.a_min for s in stats], [s.a_max for s in stats], [s.count for s in stats], step, folds, delay=delay,
        tick=tick)
    return [RangeStat(*leaves) for leaves in zip(a_mins, a_maxs, counts)], new_step


__all__ = ["monitor_quant", "qat_site_params", "qat_fold"]
