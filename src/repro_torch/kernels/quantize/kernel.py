"""Launch wrappers for kernel 6, the fused activation monitor + quantizer
(`csrc/fxp_monitor_quant.cu`; replaces `repro.kernels.quantize.kernel.
monitor_quant_pallas` → `_mq_kernel`), and kernel 7, the QAT site
bookkeeping (`csrc/fxp_qat_sites.cu`; no Pallas counterpart).

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

Kernel 7 takes the sites' 0-d leaves where they are, by address (an array
of pointers the C side packs into the struct it passes by value), so a
captured CUDA graph reads their values at replay.  `qat_site_params_cuda`
returns each site's affine operands (deltas, zs), `qat_fold_cuda` the
folded ranges and the (ticked) step as 0-d views of one packed output.
Each call is one CUDA launch of one warp; `.launches` counts calls.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

Tensor = torch.Tensor

LIB = "fxp_monitor_quant"
QAT_LIB = "fxp_qat_sites"


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


def _qat_lib():
    lib = _build.load(QAT_LIB)
    params, fold = lib.fxp_qat_site_params_launch, lib.fxp_qat_fold_launch
    if params.argtypes is None:
        ptrs = ctypes.POINTER(ctypes.c_void_p)
        # a_min, a_max, count, n_sites, n_bits, out, stream
        params.argtypes = [ptrs] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2
        params.restype = ctypes.c_int
        # a_min, a_max, count, n_sites, mn, mx, site, n_folds, step, delay, tick, out, stream
        fold.argtypes = [ptrs] * 3 + [ctypes.c_int] + [ptrs] * 2 + [ctypes.POINTER(ctypes.c_int), ctypes.c_int]
        fold.argtypes += [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        fold.restype = ctypes.c_int
    return lib, params, fold


# kernel 7's capacity (MAX_SITES, MAX_FOLDS in csrc/fxp_qat_sites.cu): a
# thread a site in one warp; the folds travel by value with the launch
QAT_MAX_SITES = 32
QAT_MAX_FOLDS = 64


def _addresses(tensors) -> "ctypes.Array":
    return (ctypes.c_void_p * max(len(tensors), 1))(*(t.data_ptr() for t in tensors))


def _check_sites(a_mins, a_maxs, counts, n_folds: int = 0) -> torch.device:
    """Raise unless kernel 7 takes these sites (and as many folds); returns
    their CUDA device."""
    n = len(a_mins)
    if not 1 <= n <= QAT_MAX_SITES or len(a_maxs) != n or len(counts) != n:
        raise ValueError(f"kernel 7 takes 1..{QAT_MAX_SITES} sites with a_min, a_max and count each, got "
                         f"{len(a_mins)}, {len(a_maxs)}, {len(counts)}")
    if n_folds > QAT_MAX_FOLDS:
        raise ValueError(f"kernel 7 takes at most {QAT_MAX_FOLDS} folds, got {n_folds}")
    dev = getattr(a_mins[0], "device", None)
    if dev is None or dev.type != "cuda":
        raise ValueError(f"kernel 7 takes CUDA tensors, got a_min[0] on {dev}")
    for i in range(n):
        _check_scalar(a_mins[i], f"a_min[{i}]", torch.float32, dev)
        _check_scalar(a_maxs[i], f"a_max[{i}]", torch.float32, dev)
        _check_scalar(counts[i], f"count[{i}]", torch.int32, dev)
    return dev


def qat_site_params_cuda(a_mins, a_maxs, counts, *, n_bits: int = 16) -> tuple[Tensor, Tensor]:
    """Kernel 7's `qat_site_params`: sites i of the one-element float32
    a_mins[i], a_maxs[i] and int32 counts[i] (on one CUDA device), their
    finalized ranges' affine operands.  Returns (deltas (L,), zs (L,)),
    float32, rows of one (2, L) tensor."""
    dev = _check_sites(a_mins, a_maxs, counts)
    if not 1 <= n_bits <= 24:
        raise ValueError(f"n_bits {n_bits} outside 1..24")
    lib, fn, _ = _qat_lib()
    n = len(a_mins)
    out = torch.empty((2, n), dtype=torch.float32, device=dev)
    rc = fn(_addresses(a_mins), _addresses(a_maxs), _addresses(counts), n, n_bits, out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch(lib, QAT_LIB, rc)
    qat_site_params_cuda.launches += 1
    return out[0], out[1]


qat_site_params_cuda.launches = 0


def qat_fold_cuda(a_mins, a_maxs, counts, step: Tensor, folds, *, delay: int, tick: bool
                  ) -> tuple[list[Tensor], list[Tensor], list[Tensor], Tensor]:
    """Kernel 7's `qat_fold`: each fold (site index, mn, mx) — one-element
    float32 extrema — in order into its site's range (sites as for
    `qat_site_params_cuda`), unless the int32 `step` is at or past `delay`;
    then the step plus `tick`.  Returns (a_mins, a_maxs, counts) per site
    and the step, each a 0-d view of one packed output."""
    dev = _check_sites(a_mins, a_maxs, counts, len(folds))
    _check_scalar(step, "step", torch.int32, dev)
    n, n_folds = len(a_mins), len(folds)
    for f, (site, mn, mx) in enumerate(folds):
        if not 0 <= site < n:
            raise ValueError(f"fold {f} into site {site} of {n}")
        _check_scalar(mn, f"fold {f} min", torch.float32, dev)
        _check_scalar(mx, f"fold {f} max", torch.float32, dev)
    lib, _, fn = _qat_lib()
    out = torch.empty(3 * n + 1, dtype=torch.float32, device=dev)
    sites = (ctypes.c_int * max(n_folds, 1))(*(site for site, _, _ in folds))
    rc = fn(_addresses(a_mins), _addresses(a_maxs), _addresses(counts), n,
            _addresses([mn for _, mn, _ in folds]), _addresses([mx for _, _, mx in folds]), sites, n_folds,
            step.data_ptr(), int(delay), int(bool(tick)), out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch(lib, QAT_LIB, rc)
    qat_fold_cuda.launches += 1
    ints = out[2 * n:].view(torch.int32)
    return list(out[:n].unbind()), list(out[n:2 * n].unbind()), list(ints[:n].unbind()), ints[n]


qat_fold_cuda.launches = 0


__all__ = ["monitor_quant_cuda", "qat_site_params_cuda", "qat_fold_cuda"]
