"""Launch wrapper for kernel A, the dual-precision dense layer
(`csrc/fxp_dense.cu`; replaces `repro.kernels.fxp_matmul.kernel.
fxp_dense_pallas`).

`fxp_dense_cuda` takes unpadded CUDA tensors — the kernel masks ragged M, K
and N itself — launches on PyTorch's current stream without synchronising,
and counts its launches in `fxp_dense_cuda.launches`.  It never falls back:
a tensor the kernel does not take, a refused launch, or a cluster shape the
card cannot schedule, raises.

`dense_plan(m, k, n)` is the launch plan, pure Python so the CPU tests can
hold it: which of the kernel's two bodies runs, its output tile, and the
split of K over a thread-block cluster (design in the source's header).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

Tensor = torch.Tensor

LIB = "fxp_dense"
ACTIVATION_CODES = {"none": 0, "relu": 1, "tanh": 2}

SMS = 132  # streaming multiprocessors of an H100 (and an H200): one wave of blocks
TILED_BMS = (64, 32)  # csrc/fxp_dense.cu: the tiled body's output rows per tile, widest first
TILED_BN = 64  # csrc/fxp_dense.cu T_BN
SMALL_BM = 8  # csrc/fxp_dense.cu S_BM: the small body's rows per tile
SMALL_BNS = (32, 16, 8)  # the small body's column tiles, widest first
SMALL_MAX_M = 32  # the tiled body takes M > 32 (and N > 32)
PORTABLE_CLUSTER = 8  # cluster sizes above this need the non-portable attribute
MAX_SPLIT = {"tiled": 8, "small": 16}
MIN_CHUNK = {"tiled": 32, "small": 16}  # no split of K leaves a block fewer k than this
SPLIT_TARGET = {"tiled": SMS, "small": SMS // 2}  # blocks a split of K aims at
THREADS = 256  # csrc/fxp_dense.cu THREADS
# static shared memory of each body (csrc/fxp_dense.cu; ptxas reports the same):
# tiled, the larger of the W ring with the x limb tiles and the two limbs'
# partial sums; small, the x limbs of 8 × 256 k, the groups' partial sums
# and the block's (8 × 32, two limbs each)
SMEM = {**{f"tiled{bm}": 4 * max(3 * 16 * 64 + 2 * 2 * 16 * (bm + 4), 2 * bm * 64) for bm in TILED_BMS},
        "small": 4 * (2 * 8 * 256 + 2 * 256 * 8 + 2 * 8 * 32)}


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _split(k: int, base: int, body: str, max_split: Optional[int] = None) -> int:
    """Chunks of K for `base` output tiles: toward the body's target of
    blocks, at most `max_split`, none shorter than the body's minimum, none
    empty."""
    cap = MAX_SPLIT[body] if max_split is None else max_split
    split = max(1, min(cap, k // MIN_CHUNK[body], _cdiv(SPLIT_TARGET[body], base)))
    return _cdiv(k, _cdiv(k, split)) if split > 1 else 1


def dense_plan(m: int, k: int, n: int) -> tuple[int, int, int, tuple[int, int, int]]:
    """Launch plan of kernel A for x (m, k) @ w (k, n): (bm, bn, split,
    grid).  bm × bn is the output tile: (64 or 32, 64) the tiled body (for
    m and n > 32), (8, 32 / 16 / 8) the small body; the first candidate in
    that order that launches at least half a wave of blocks, else the last.
    `split` chunks of ⌈k / split⌉ (the last one shorter, none empty) are
    summed by the `split` blocks of one cluster; grid = (row tiles × column
    tiles, 1, split)."""
    if m < 1 or n < 1 or k < 0:
        raise ValueError(f"no plan for ({m}, {k}) @ ({k}, {n})")
    candidates = []
    if m > SMALL_MAX_M and n > SMALL_MAX_M:
        candidates += [(bm, TILED_BN, "tiled") for bm in TILED_BMS]
    candidates += [(SMALL_BM, bn, "small") for bn in SMALL_BNS if bn <= max(SMALL_BNS[-1], _cdiv(n, 8) * 8)]
    for i, (bm, bn, body) in enumerate(candidates):
        tiles = _cdiv(m, bm) * _cdiv(n, bn)
        split = _split(k, tiles, body)
        if split > PORTABLE_CLUSTER and tiles * PORTABLE_CLUSTER >= SMS // 2:
            split = _split(k, tiles, body, PORTABLE_CLUSTER)  # portable clusters make half a wave
        if tiles * split >= SMS // 2 or i == len(candidates) - 1:
            return bm, bn, split, (tiles, 1, split)
    raise AssertionError("unreachable")


def _launcher():
    lib = _build.load(LIB)
    fn = lib.fxp_dense_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
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
    bm, bn, split, _ = dense_plan(m, k, n)
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
        bm,
        bn,
        split,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check_launch(lib, LIB, rc)
    fxp_dense_cuda.launches += 1
    return y


fxp_dense_cuda.launches = 0


__all__ = ["fxp_dense_cuda", "dense_plan", "ACTIVATION_CODES"]
