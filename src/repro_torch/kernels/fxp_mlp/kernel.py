"""Launch wrapper for kernel B, the fused whole-network MLP forward
(`csrc/fxp_mlp_fwd.cu`; replaces `repro.kernels.fxp_mlp.kernel.
fxp_mlp_pallas` → `_mlp_kernel`, forward without residuals).

`fxp_mlp_fwd_cuda` takes unpadded CUDA tensors, launches one block per row
block on PyTorch's current stream without synchronising, and counts its
launches in `fxp_mlp_fwd_cuda.launches`.  It returns the per-block range
monitor rows (n_blocks, L); `ops.fxp_mlp_forward` reduces them.  It never
falls back: a tensor the kernel does not take, or a refused launch, raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fxp_matmul.kernel import ACTIVATION_CODES

Tensor = torch.Tensor

LIB = "fxp_mlp_fwd"
MAX_LAYERS = 8  # csrc/fxp_mlp_fwd.cu MAX_LAYERS
MAX_SMEM = 232448  # bytes of shared memory a block may use on sm_90


def row_block(m: int) -> int:
    """Rows per block: 8, or 1 for a single row (the kernel's two
    instantiations)."""
    return 1 if m == 1 else 8


def _launcher():
    lib = _build.load(LIB)
    fn = lib.fxp_mlp_fwd_launch
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_void_p] * 5
            + [ctypes.c_int]
            + [ctypes.c_void_p] * 5
            + [ctypes.c_int] * 6
            + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    return lib, fn


def fxp_mlp_fwd_cuda(
    x: Tensor,
    weights: Sequence[Tensor],
    biases: Sequence[Tensor],
    deltas: Optional[Tensor],
    zs: Optional[Tensor],
    *,
    activations: Sequence[str],
    quant: bool,
    qat: bool,
    n_bits: int,
    fxp32_phase1: bool,
) -> tuple[Tensor, Tensor, Tensor]:
    """The whole forward through kernel B.

    x: (M, K0); weights[i]: (K_i, N_i); biases[i]: (N_i,); deltas/zs: (L,)
    per-site affine operands (read only when qat).  All contiguous float32
    on the current CUDA device.  Returns (y (M, N_L), mins, maxs), the last
    two (n_blocks, L) per-block site extrema.
    """
    n_layers = len(weights)
    if not 1 <= n_layers <= MAX_LAYERS:
        raise ValueError(f"kernel B takes 1..{MAX_LAYERS} layers, got {n_layers}")
    if len(biases) != n_layers or len(activations) != n_layers:
        raise ValueError(f"{n_layers} weights vs {len(biases)} biases vs {len(activations)} activations")
    if not 1 <= n_bits <= 24:
        raise ValueError(f"n_bits {n_bits} outside 1..24")
    _build.check_operand(x, "x", 2)
    dims = [int(x.shape[1])]
    for i, (w, b) in enumerate(zip(weights, biases)):
        _build.check_operand(w, f"weights[{i}]", 2)
        _build.check_operand(b, f"biases[{i}]", 1)
        if w.shape[0] != dims[-1] or b.shape[0] != w.shape[1]:
            raise ValueError(
                f"layer {i}: w {tuple(w.shape)}, b {tuple(b.shape)} after input width {dims[-1]}"
            )
        dims.append(int(w.shape[1]))
    if qat:
        for t, name in ((deltas, "deltas"), (zs, "zs")):
            _build.check_operand(t, name, 1)
            if t.shape[0] != n_layers:
                raise ValueError(f"{name} has {t.shape[0]} entries for {n_layers} layers")
    for t in (*weights, *biases, *((deltas, zs) if qat else ())):
        if t.device != x.device:
            raise ValueError(f"operands on {x.device} and {t.device}")
    unknown = [a for a in activations if a not in ACTIVATION_CODES]
    if unknown:
        raise ValueError(f"unknown activations {unknown}; expected one of {list(ACTIVATION_CODES)}")
    m = int(x.shape[0])
    if m == 0:
        raise ValueError("empty batch")
    bm = row_block(m)
    smem = 3 * bm * max(dims) * 4
    if smem > MAX_SMEM:
        raise ValueError(f"layer width {max(dims)} needs {smem} B of shared memory (> {MAX_SMEM})")
    n_blocks = -(-m // bm)
    y = torch.empty((m, dims[-1]), dtype=torch.float32, device=x.device)
    mins = torch.empty((n_blocks, n_layers), dtype=torch.float32, device=x.device)
    maxs = torch.empty((n_blocks, n_layers), dtype=torch.float32, device=x.device)
    w_ptrs = (ctypes.c_void_p * n_layers)(*[w.data_ptr() for w in weights])
    b_ptrs = (ctypes.c_void_p * n_layers)(*[b.data_ptr() for b in biases])
    c_dims = (ctypes.c_int * (n_layers + 1))(*dims)
    c_acts = (ctypes.c_int * n_layers)(*[ACTIVATION_CODES[a] for a in activations])
    lib, fn = _launcher()
    rc = fn(
        x.data_ptr(),
        w_ptrs,
        b_ptrs,
        c_dims,
        c_acts,
        n_layers,
        deltas.data_ptr() if qat else None,
        zs.data_ptr() if qat else None,
        y.data_ptr(),
        mins.data_ptr(),
        maxs.data_ptr(),
        m,
        bm,
        int(bool(quant)),
        int(bool(qat)),
        int(bool(fxp32_phase1)),
        n_bits,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check_launch(lib, LIB, rc)
    fxp_mlp_fwd_cuda.launches += 1
    return y, mins, maxs


fxp_mlp_fwd_cuda.launches = 0


__all__ = ["fxp_mlp_fwd_cuda", "row_block", "MAX_LAYERS"]
