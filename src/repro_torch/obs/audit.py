"""Dispatch audit: the cost model's predictions checked against reality.

A copy of `repro.obs.audit` for the port.

The adaptive dispatcher (`serve/policy/dispatch.CostModel`) picks a kernel
dataflow per micro-batch from an affine latency model fitted offline from
`BENCH_fused_mlp.json`.  Nothing used to check those predictions against
the wall time the engines actually measure — calibration drift (new
hardware, changed kernels, a stale bench artifact) was silent until the
next recalibration.  `DispatchAudit` closes the loop: every engine batch
records ``(phase, mode, bucket) -> (predicted_us, measured_us)`` pairs,
and the audit exposes

  * a per-(phase, mode, bucket) table — predicted vs mean measured
    latency and their ratio (the raw Fig.-8-style comparison), and
  * one **drift statistic**: ``drift_factor = exp(weighted mean
    |ln(measured / predicted)|)`` — the average multiplicative error of
    the model, 1.0 when perfectly calibrated, weighted by batch count.
    ``stale`` flips true once the factor crosses ``threshold`` (default
    3.0: mode latencies typically differ by 2-5x, so a model off by 3x on
    average can no longer be trusted to rank them) — the signal to re-run
    `benchmarks/kernel_bench` and refit via `CostModel.from_bench`.
"""

from __future__ import annotations

import math
import threading
from typing import Sequence

_EPS_US = 1e-3  # 1 ns floor: keeps log ratios finite on degenerate clocks


class DispatchAudit:
    """Accumulates predicted-vs-measured latency per (phase, mode, bucket).

    Thread-safe; O(#distinct (phase, mode, bucket) keys) memory — for an
    engine that is #phases x #modes x #buckets, single digits.
    """

    def __init__(
        self,
        cost_model,
        dims: Sequence[int],
        *,
        threshold: float = 3.0,
        registry=None,
        prefix: str = "dispatch_audit",
    ):
        self.cost_model = cost_model
        self.dims = list(dims)
        self.threshold = float(threshold)
        self._lock = threading.Lock()
        # (phase, mode, bucket) -> [n, sum_measured_us, sum_log_ratio,
        #                           predicted_us]
        self._cells: dict[tuple[str, str, int], list] = {}
        # optional registry mirror: the drift verdict as gauges, so fleet
        # aggregation and SLO rules (`*.dispatch_audit.stale`) see which
        # HOST's calibration went bad without asking each engine directly
        self._g_drift = self._g_stale = None
        if registry is not None:
            self._g_drift = registry.gauge(f"{prefix}.drift_factor")
            self._g_stale = registry.gauge(f"{prefix}.stale")
            self._g_stale.set(0.0)

    def record(self, phase: str, mode: str, bucket: int, measured_s: float) -> None:
        predicted_us = self.cost_model.estimate_us(mode, bucket, self.dims, phase)
        measured_us = measured_s * 1e6
        log_ratio = math.log(max(measured_us, _EPS_US) / max(predicted_us, _EPS_US))
        key = (phase, mode, int(bucket))
        with self._lock:
            cell = self._cells.get(key)
            if cell is None:
                cell = self._cells[key] = [0, 0.0, 0.0, predicted_us]
            cell[0] += 1
            cell[1] += measured_us
            cell[2] += log_ratio
            cell[3] = predicted_us
        if self._g_drift is not None:
            d = self.drift()  # O(#cells): single digits per engine
            self._g_drift.set(d["drift_factor"])
            self._g_stale.set(1.0 if d["stale"] else 0.0)

    def table(self) -> dict:
        """``{phase: {mode: {bucket: {n, predicted_us, measured_us,
        ratio}}}}`` — measured is the mean; ratio = measured / predicted."""
        with self._lock:
            cells = {k: list(v) for k, v in self._cells.items()}
        out: dict = {}
        for (phase, mode, bucket), (n, meas_sum, _, pred) in sorted(cells.items()):
            mean_us = meas_sum / n
            out.setdefault(phase, {}).setdefault(mode, {})[str(bucket)] = {
                "n": n,
                "predicted_us": pred,
                "measured_us": mean_us,
                "ratio": mean_us / max(pred, _EPS_US),
            }
        return out

    def drift(self) -> dict:
        """The headline calibration-health stat (see module docstring)."""
        with self._lock:
            cells = [list(v) for v in self._cells.values()]
        total = sum(c[0] for c in cells)
        if total == 0:
            return {"drift_factor": None, "stale": False, "threshold": self.threshold, "batches": 0}
        # per-cell mean log-ratio first (so a hot cell doesn't let noise
        # from its individual batches masquerade as calibration error),
        # then weight cells by batch count
        weighted = sum(c[0] * abs(c[2] / c[0]) for c in cells) / total
        factor = math.exp(weighted)
        return {
            "drift_factor": factor,
            "stale": factor > self.threshold,
            "threshold": self.threshold,
            "batches": total,
        }

    def snapshot(self) -> dict:
        """drift() + table() in one dict — the engines' `stats()` section
        and the bench JSONs' `dispatch_audit` shape."""
        out = self.drift()
        out["table"] = self.table()
        return out

    def reset(self) -> None:
        with self._lock:
            self._cells.clear()
        if self._g_drift is not None:
            self._g_drift.reset()
            self._g_stale.set(0.0)


__all__ = ["DispatchAudit"]
