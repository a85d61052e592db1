"""Launch wrapper for kernel 6, the fused activation monitor + quantizer
(`csrc/fxp_monitor_quant.cu`; replaces `repro.kernels.quantize.kernel.
monitor_quant_pallas` → `_mq_kernel`).

`monitor_quant_cuda` takes the flat float32 tensor as it is — the TPU's
(R, 128) reshape, padding and valid-count mask are not carried over: the
kernel bounds its grid-stride loop by N.  The ranges and the phase are
device scalars the kernel reads, so a call needs no host read and a CUDA
graph can capture it.  Each call is one CUDA launch: the sweep (float4
where x and y are 16-byte aligned), then the last block to finish folds
the per-block extrema, in block order, into the incoming range;
deterministic.  The per-block extrema and the arrival ticket live in a
workspace kept per device and stream (`_workspace`), made by the first,
eager call on that stream: a call under CUDA-graph capture never
allocates.  `monitor_quant_cuda.launches` counts calls.  Bound: 8 bytes an
element (x read, y written) over device-memory bandwidth.  It never falls
back: an operand the kernel does not take, or a refused launch, raises.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

Tensor = torch.Tensor

LIB = "fxp_monitor_quant"


def _lib():
    lib = _build.load(LIB)
    fn = lib.fxp_monitor_quant_launch
    if fn.argtypes is None:
        # x, y, n, a_min, a_max, phase, workspace, new_min, new_max, n_bits, stream
        fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_longlong] + [ctypes.c_void_p] * 6 + [ctypes.c_int]
        fn.argtypes += [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.fxp_monitor_quant_workspace.argtypes = []
        lib.fxp_monitor_quant_workspace.restype = ctypes.c_longlong
    return lib, fn


_workspaces: dict = {}


def _workspace(lib, device: torch.device, stream: int) -> Tensor:
    """The kernel's workspace for calls on `stream` of `device`: the
    per-block extrema, then the ticket (zero bits, the last block resets it
    after each call).  Made once, by an eager call; raises under capture
    before one, since an allocation there would belong to the graph."""
    key = (device.index, stream)
    ws = _workspaces.get(key)
    if ws is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("monitor_quant_cuda: call it once eagerly on this stream before capturing it")
        ws = torch.zeros(lib.fxp_monitor_quant_workspace(), dtype=torch.float32, device=device)
        _workspaces[key] = ws
    return ws


def _check_scalar(t, name: str, dtype, device) -> None:
    if not isinstance(t, Tensor) or t.dtype != dtype or t.numel() != 1:
        raise ValueError(f"{name}: expected a one-element {dtype} tensor, got {getattr(t, 'shape', t)}")
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, data on {device}")


def monitor_quant_cuda(
    x: Tensor, a_min: Tensor, a_max: Tensor, phase: Tensor, *, n_bits: int = 16
) -> tuple[Tensor, Tensor, Tensor]:
    """Kernel 6 on a 1-d contiguous float32 CUDA tensor of N > 0 elements.
    a_min, a_max: one-element float32 tensors; phase: one-element int32
    (> 0: the quant phase); all on x's device.  Returns (y like x, new_min,
    new_max), the last two 0-d."""
    _build.check_operand(x, "x", 1)
    _check_scalar(a_min, "a_min", torch.float32, x.device)
    _check_scalar(a_max, "a_max", torch.float32, x.device)
    _check_scalar(phase, "phase", torch.int32, x.device)
    if not 1 <= n_bits <= 24:
        raise ValueError(f"n_bits {n_bits} outside 1..24")
    n = x.numel()
    if n == 0:
        raise ValueError("empty tensor: no range to monitor")
    lib, fn = _lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    ws = _workspace(lib, x.device, stream)
    y = torch.empty_like(x)
    out = torch.empty(2, dtype=torch.float32, device=x.device)
    rc = fn(
        x.data_ptr(),
        y.data_ptr(),
        n,
        a_min.data_ptr(),
        a_max.data_ptr(),
        phase.data_ptr(),
        ws.data_ptr(),
        out.data_ptr(),
        out.data_ptr() + out.element_size(),
        n_bits,
        stream,
    )
    _build.check_launch(lib, LIB, rc)
    monitor_quant_cuda.launches += 1
    return y, out[0], out[1]


monitor_quant_cuda.launches = 0


__all__ = ["monitor_quant_cuda"]
