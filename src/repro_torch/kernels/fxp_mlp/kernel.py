"""Launch wrappers for the fused whole-network MLP kernels.

* `fxp_mlp_fwd_cuda` — kernel B, the forward (`csrc/fxp_mlp_fwd.cu`;
  replaces `repro.kernels.fxp_mlp.kernel.fxp_mlp_pallas` → `_mlp_kernel`),
  with or without the training residuals.  One block per row block; it
  returns the per-block range monitor rows (n_blocks, L), which
  `ops.fxp_mlp_forward` reduces.
* `fxp_mlp_bwd_cuda` — kernel 3, the backward (`csrc/fxp_mlp_bwd.cu`;
  replaces `fxp_mlp_bwd_pallas` → `_mlp_bwd_kernel`): dx, dW and db from
  the forward's residuals, in two CUDA launches (the chain over row
  blocks, then the dW/db reduction over rows), both deterministic.

Both take unpadded CUDA tensors, launch on PyTorch's current stream without
synchronising, and count their calls in `<wrapper>.launches` (one per
call; the backward's call is two CUDA launches).  They never fall back: a
tensor the kernel does not take, or a refused launch, raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fxp_matmul.kernel import ACTIVATION_CODES

Tensor = torch.Tensor

LIB = "fxp_mlp_fwd"
LIB_BWD = "fxp_mlp_bwd"
MAX_LAYERS = 8  # csrc/fxp_mlp_{fwd,bwd}.cu MAX_LAYERS
MAX_SMEM = 232448  # bytes of shared memory a block may use on sm_90
BWD_ROWS = 8  # csrc/fxp_mlp_bwd.cu BM: rows per block of the chain pass


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
            + [ctypes.c_int] * 7
            + [ctypes.c_void_p] * 3
        )
        fn.restype = ctypes.c_int
    return lib, fn


def _bwd_launcher():
    lib = _build.load(LIB_BWD)
    fn = lib.fxp_mlp_bwd_launch
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_void_p] * 10
            + [ctypes.c_int]
            + [ctypes.c_void_p] * 3
            + [ctypes.c_int] * 5
            + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    return lib, fn


def _check_net(x, weights, deltas, zs, activations, qat: bool, n_bits: int, what: str) -> list[int]:
    """Validate the operands both kernels share; returns the layer dims."""
    n_layers = len(weights)
    if not 1 <= n_layers <= MAX_LAYERS:
        raise ValueError(f"{what} takes 1..{MAX_LAYERS} layers, got {n_layers}")
    if len(activations) != n_layers:
        raise ValueError(f"{n_layers} weights vs {len(activations)} activations")
    if not 1 <= n_bits <= 24:
        raise ValueError(f"n_bits {n_bits} outside 1..24")
    _build.check_operand(x, "x", 2)
    dims = [int(x.shape[1])]
    for i, w in enumerate(weights):
        _build.check_operand(w, f"weights[{i}]", 2)
        if w.shape[0] != dims[-1]:
            raise ValueError(f"layer {i}: w {tuple(w.shape)} after input width {dims[-1]}")
        dims.append(int(w.shape[1]))
    if qat:
        for t, name in ((deltas, "deltas"), (zs, "zs")):
            _build.check_operand(t, name, 1)
            if t.shape[0] != n_layers:
                raise ValueError(f"{name} has {t.shape[0]} entries for {n_layers} layers")
    for t in (*weights, *((deltas, zs) if qat else ())):
        if t.device != x.device:
            raise ValueError(f"operands on {x.device} and {t.device}")
    unknown = [a for a in activations if a not in ACTIVATION_CODES]
    if unknown:
        raise ValueError(f"unknown activations {unknown}; expected one of {list(ACTIVATION_CODES)}")
    if int(x.shape[0]) == 0:
        raise ValueError("empty batch")
    return dims


def _ptrs(tensors) -> ctypes.Array:
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


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
    save_residuals: bool = False,
):
    """The whole forward through kernel B.

    x: (M, K0); weights[i]: (K_i, N_i); biases[i]: (N_i,); deltas/zs: (L,)
    per-site affine operands (read only when qat).  All contiguous float32
    on the current CUDA device.  Returns (y (M, N_L), mins, maxs), the last
    two (n_blocks, L) per-block site extrema; with `save_residuals` also
    (qs, hs) as `ref.ref_mlp_forward` returns them (hs[L-1] is y).
    """
    if len(biases) != len(weights):
        raise ValueError(f"{len(weights)} weights vs {len(biases)} biases")
    dims = _check_net(x, weights, deltas, zs, activations, qat, n_bits, "kernel B")
    n_layers = len(weights)
    for i, b in enumerate(biases):
        _build.check_operand(b, f"biases[{i}]", 1)
        if b.shape[0] != dims[i + 1] or b.device != x.device:
            raise ValueError(f"layer {i}: b {tuple(b.shape)} on {b.device} for w {tuple(weights[i].shape)}")
    m = int(x.shape[0])
    bm = row_block(m)
    smem = 3 * bm * max(dims) * 4
    if smem > MAX_SMEM:
        raise ValueError(f"layer width {max(dims)} needs {smem} B of shared memory (> {MAX_SMEM})")
    n_blocks = -(-m // bm)
    y = torch.empty((m, dims[-1]), dtype=torch.float32, device=x.device)
    mins = torch.empty((n_blocks, n_layers), dtype=torch.float32, device=x.device)
    maxs = torch.empty((n_blocks, n_layers), dtype=torch.float32, device=x.device)
    qs = hs = []
    if save_residuals:
        qs = [torch.empty((m, k), dtype=torch.float32, device=x.device) for k in dims[:-1]]
        hs = [torch.empty((m, n), dtype=torch.float32, device=x.device) for n in dims[1:-1]]
    w_ptrs = _ptrs(weights)
    b_ptrs = _ptrs(biases)
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
        int(bool(save_residuals)),
        _ptrs(qs) if save_residuals else None,
        _ptrs(hs) if save_residuals and hs else None,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check_launch(lib, LIB, rc)
    fxp_mlp_fwd_cuda.launches += 1
    if save_residuals:
        return y, mins, maxs, qs, hs + [y]
    return y, mins, maxs


fxp_mlp_fwd_cuda.launches = 0


def fxp_mlp_bwd_cuda(
    g: Tensor,
    x0: Tensor,
    weights: Sequence[Tensor],
    qs: Sequence[Tensor],
    hs: Sequence[Tensor],
    deltas: Optional[Tensor],
    zs: Optional[Tensor],
    *,
    activations: Sequence[str],
    quant: bool,
    qat: bool,
    n_bits: int,
    fxp32_phase1: bool,
) -> tuple[Tensor, list, list]:
    """The whole backward through kernel 3.

    g: (M, N_L) cotangent of y; x0: (M, K0) the forward's input; weights,
    deltas/zs as for the forward; qs[l] (M, K_l) and hs[l] (M, N_l) the
    forward's residuals, hs[L-1] = y.  All contiguous float32 on the
    current CUDA device.  Returns (dx (M, K0), [dW_l (K_l, N_l)],
    [db_l (N_l,)]).
    """
    dims = _check_net(x0, weights, deltas, zs, activations, qat, n_bits, "kernel 3")
    n_layers = len(weights)
    m = int(x0.shape[0])
    if len(qs) != n_layers or len(hs) != n_layers:
        raise ValueError(f"{len(qs)} qs and {len(hs)} hs for {n_layers} layers")
    for name, t, shape in (
        ("g", g, (m, dims[-1])),
        *((f"qs[{i}]", q, (m, dims[i])) for i, q in enumerate(qs)),
        *((f"hs[{i}]", h, (m, dims[i + 1])) for i, h in enumerate(hs)),
    ):
        _build.check_operand(t, name, 2)
        if tuple(t.shape) != shape or t.device != x0.device:
            raise ValueError(f"{name}: shape {tuple(t.shape)} on {t.device}, expected {shape} on {x0.device}")
    smem = 2 * BWD_ROWS * max(dims) * 4
    if smem > MAX_SMEM:
        raise ValueError(f"layer width {max(dims)} needs {smem} B of shared memory (> {MAX_SMEM})")
    dev = x0.device
    dx = torch.empty((m, dims[0]), dtype=torch.float32, device=dev)
    dws = [torch.empty((k, n), dtype=torch.float32, device=dev) for k, n in zip(dims[:-1], dims[1:])]
    dbs = [torch.empty((n,), dtype=torch.float32, device=dev) for n in dims[1:]]
    scratch = [torch.empty((m, n), dtype=torch.float32, device=dev) for n in dims[1:]]
    c_dims = (ctypes.c_int * (n_layers + 1))(*dims)
    c_acts = (ctypes.c_int * n_layers)(*[ACTIVATION_CODES[a] for a in activations])
    lib, fn = _bwd_launcher()
    rc = fn(
        g.data_ptr(),
        x0.data_ptr(),
        _ptrs(weights),
        _ptrs(qs),
        _ptrs(hs),
        _ptrs(scratch),
        _ptrs(dws),
        _ptrs(dbs),
        c_dims,
        c_acts,
        n_layers,
        deltas.data_ptr() if qat else None,
        zs.data_ptr() if qat else None,
        dx.data_ptr(),
        m,
        int(bool(quant)),
        int(bool(qat)),
        int(bool(fxp32_phase1)),
        n_bits,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check_launch(lib, LIB_BWD, rc)
    fxp_mlp_bwd_cuda.launches += 1
    return dx, dws, dbs


fxp_mlp_bwd_cuda.launches = 0


__all__ = ["fxp_mlp_fwd_cuda", "fxp_mlp_bwd_cuda", "row_block", "MAX_LAYERS", "BWD_ROWS"]
