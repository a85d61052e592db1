"""Launch wrapper for kernel A, the dual-precision dense layer
(`csrc/fxp_dense.cu`; replaces `repro.kernels.fxp_matmul.kernel.
fxp_dense_pallas`).

`fxp_dense_cuda` takes unpadded CUDA tensors — the kernel masks ragged M, K
and N itself — launches on PyTorch's current stream without synchronising,
and counts its launches in `fxp_dense_cuda.launches`.  It never falls back:
a tensor the kernel does not take, or a refused launch, raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

Tensor = torch.Tensor

LIB = "fxp_dense"
ACTIVATION_CODES = {"none": 0, "relu": 1, "tanh": 2}


def _launcher():
    lib = _build.load(LIB)
    fn = lib.fxp_dense_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib, fn


def fxp_dense_cuda(
    x: Tensor,
    w: Tensor,
    b: Optional[Tensor],
    *,
    full_precision: bool,
    activation: str,
) -> Tensor:
    """act(x @ w + b) through kernel A.  x: (M, K), w: (K, N), b: (N,) or
    None; contiguous float32 on the current CUDA device.  Returns (M, N)."""
    if activation not in ACTIVATION_CODES:
        raise ValueError(f"unknown activation {activation!r}; expected one of {list(ACTIVATION_CODES)}")
    _build.check_operand(x, "x", 2)
    _build.check_operand(w, "w", 2)
    m, k = x.shape
    k2, n = w.shape
    if k != k2:
        raise ValueError(f"x is (M, {k}) but w is ({k2}, N)")
    if b is not None:
        _build.check_operand(b, "b", 1)
        if b.shape[0] != n:
            raise ValueError(f"b has {b.shape[0]} entries, w has {n} columns")
    for t in (w, b):
        if t is not None and t.device != x.device:
            raise ValueError(f"operands on {x.device} and {t.device}")
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0 or n == 0:
        return y
    lib, fn = _launcher()
    rc = fn(
        x.data_ptr(),
        w.data_ptr(),
        None if b is None else b.data_ptr(),
        y.data_ptr(),
        m,
        k,
        n,
        int(bool(full_precision)),
        ACTIVATION_CODES[activation],
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check_launch(lib, LIB, rc)
    fxp_dense_cuda.launches += 1
    return y


fxp_dense_cuda.launches = 0


__all__ = ["fxp_dense_cuda", "ACTIVATION_CODES"]
