"""Build and load the port's CUDA kernels.

Each `src/repro_torch/csrc/<name>.cu` is compiled by `nvcc` for `sm_90a`
into `build/kernels/lib<name>.so` (a plain C interface, no PyTorch headers,
so a build takes seconds) and loaded with `ctypes` at first use.  A library
is rebuilt when it is missing or older than any source in `csrc/`.
`build()` starts one `nvcc` per source, all at once, and waits for them.

No `--use_fast_math`: the kernels need IEEE division and the precise
`tanhf`, as the plain versions compute them.  `-Xptxas -v` writes each
kernel's registers, shared memory and spills to `build/kernels/<name>.log`.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import shutil
import subprocess
import threading
import time

import torch

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of the CUDA compiler: `$CUDA_HOME/bin/nvcc`, else `nvcc` on
    PATH, else the toolkit's default install location."""
    home = os.environ.get("CUDA_HOME")
    candidates = [pathlib.Path(home) / "bin" / "nvcc"] if home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(pathlib.Path(found))
    candidates.append(pathlib.Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put the CUDA toolkit's nvcc on PATH")


def lib_path(name: str) -> pathlib.Path:
    return BUILD_DIR / f"lib{name}.so"


def log_path(name: str) -> pathlib.Path:
    return BUILD_DIR / f"{name}.log"


def _up_to_date(name: str) -> bool:
    out = lib_path(name)
    if not out.exists():
        return False
    newest = max(p.stat().st_mtime for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))
    return out.stat().st_mtime >= newest


def build(names) -> dict[str, float]:
    """Compile every stale library in `names` in parallel; returns the
    seconds each took (0.0 when it was up to date).  Raises with the
    compiler's output when a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    stale = []
    for name in names:
        if not (CSRC / f"{name}.cu").is_file():
            raise FileNotFoundError(CSRC / f"{name}.cu")
        if not _up_to_date(name):
            stale.append(name)
    seconds = {name: 0.0 for name in names}
    failed = []
    procs = {}
    t0 = time.perf_counter()
    try:
        for name in stale:
            tmp = BUILD_DIR / f"lib{name}.so.{os.getpid()}.tmp"
            cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            with open(log_path(name), "w") as log:
                procs[name] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT), tmp)
        for name, (proc, tmp) in procs.items():
            rc = proc.wait()
            seconds[name] = time.perf_counter() - t0
            if rc != 0:
                failed.append(f"{name} (nvcc exit {rc}):\n{log_path(name).read_text()[-4000:]}")
            else:
                os.replace(tmp, lib_path(name))
    finally:
        for proc, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, built first if stale.  Its
    `<name>_error_string` gets its ctypes signature here; the caller sets
    the launch function's."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(lib_path(name)))
            err = getattr(lib, f"{name}_error_string")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def check_operand(t, name: str, ndim: int) -> None:
    """Raise unless `t` is what a kernel takes: a contiguous float32 CUDA
    tensor of `ndim` dimensions on the current device."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor, got {type(t).__name__}")
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got one on {t.device}")
    if t.device.index not in (None, torch.cuda.current_device()):
        raise ValueError(f"{name}: tensor on {t.device}, current device is cuda:{torch.cuda.current_device()}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dimensions, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def check_launch(lib: ctypes.CDLL, name: str, rc: int) -> None:
    """Raise when a launch function returned a CUDA error code."""
    if rc != 0:
        msg = getattr(lib, f"{name}_error_string")(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc} ({msg})")


__all__ = [
    "build",
    "load",
    "check_operand",
    "check_launch",
    "nvcc",
    "lib_path",
    "log_path",
    "CSRC",
    "BUILD_DIR",
    "NVCC_FLAGS",
]
