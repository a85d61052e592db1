"""The card the benchmark runs on: its name and power limit, and its energy
over a window, read from NVML through ctypes (the driver's own library;
no Python package needed), else from `nvidia-smi`.

Energy: the card's own cumulative counter (`nvmlDeviceGetTotalEnergyConsumption`,
mJ) where the card has one; otherwise its power draw sampled every 100 ms
beside the window and integrated by the trapezoid rule.
"""

from __future__ import annotations

import ctypes
import subprocess
import threading
import time
from typing import Optional


def _smi(query: str) -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else None


class Card:
    """NVML's handle of CUDA device 0 (matched by UUID, else NVML's index 0)."""

    def __init__(self):
        self.lib = self.handle = None
        try:
            lib = ctypes.CDLL("libnvidia-ml.so.1")
        except OSError:
            return
        handle_p = ctypes.POINTER(ctypes.c_void_p)
        for fn, args in (("nvmlInit_v2", []), ("nvmlDeviceGetHandleByUUID", [ctypes.c_char_p, handle_p]),
                         ("nvmlDeviceGetHandleByIndex_v2", [ctypes.c_uint, handle_p]),
                         ("nvmlDeviceGetTotalEnergyConsumption", [ctypes.c_void_p, ctypes.POINTER(ctypes.c_ulonglong)]),
                         ("nvmlDeviceGetPowerUsage", [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint)]),
                         ("nvmlDeviceGetEnforcedPowerLimit", [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint)])):
            getattr(lib, fn).argtypes, getattr(lib, fn).restype = args, ctypes.c_int
        if lib.nvmlInit_v2() != 0:
            return
        handle = ctypes.c_void_p()
        uuid = self._uuid()
        found = uuid is not None and lib.nvmlDeviceGetHandleByUUID(uuid, ctypes.byref(handle)) == 0
        if not found and lib.nvmlDeviceGetHandleByIndex_v2(ctypes.c_uint(0), ctypes.byref(handle)) != 0:
            return
        self.lib, self.handle = lib, handle

    @staticmethod
    def _uuid() -> Optional[bytes]:
        import torch

        u = getattr(torch.cuda.get_device_properties(0), "uuid", None)
        return None if u is None else f"GPU-{u}".encode()

    def _read(self, fn: str, ctype):
        if self.lib is None:
            return None
        val = ctype()
        return val.value if getattr(self.lib, fn)(self.handle, ctypes.byref(val)) == 0 else None

    def energy_mj(self) -> Optional[int]:
        return self._read("nvmlDeviceGetTotalEnergyConsumption", ctypes.c_ulonglong)

    def power_w(self) -> Optional[float]:
        mw = self._read("nvmlDeviceGetPowerUsage", ctypes.c_uint)
        if mw is not None:
            return mw / 1e3
        s = _smi("power.draw")
        return float(s) if s not in (None, "[N/A]") else None

    def power_limit_w(self) -> Optional[float]:
        mw = self._read("nvmlDeviceGetEnforcedPowerLimit", ctypes.c_uint)
        if mw is not None:
            return mw / 1e3
        s = _smi("power.limit")
        return float(s) if s not in (None, "[N/A]") else None


class EnergyMeter:
    """Joules the card used between `start()` and `stop()`."""

    def __init__(self, card: Card, period_s: float = 0.1):
        self.card, self.period = card, period_s
        self.source = "nvml_energy_counter" if card.energy_mj() is not None else "power_draw_sampled"
        self._samples: list[tuple[float, float]] = []
        self._stop = threading.Event()
        self._thread = None

    def _sample(self) -> None:
        while not self._stop.is_set():
            p = self.card.power_w()
            if p is not None:
                self._samples.append((time.perf_counter(), p))
            self._stop.wait(self.period)

    def start(self) -> None:
        if self.source == "nvml_energy_counter":
            self._e0 = self.card.energy_mj()
        else:
            self._thread = threading.Thread(target=self._sample, daemon=True)
            self._thread.start()

    def stop(self) -> Optional[float]:
        if self.source == "nvml_energy_counter":
            return (self.card.energy_mj() - self._e0) / 1e3
        self._stop.set()
        self._thread.join()
        s = self._samples
        if len(s) < 2:
            return None
        return sum((t1 - t0) * (p0 + p1) / 2 for (t0, p0), (t1, p1) in zip(s, s[1:]))
