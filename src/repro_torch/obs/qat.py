"""QAT range/saturation telemetry — Algorithm 1's signals made observable
(port of `repro.obs.qat` against the port's `core.ranges`).

  * `ranges_snapshot(qat_state)` — host-side floats of every site's running
    range (finalized a_min/a_max, the raw observed extrema when finite, and
    the update count);
  * `QATTelemetry` — the registry-backed per-site store the engines fold
    into: frozen/finalized ranges as gauges, probe results (observed
    activation extrema + saturation rate: the fraction of activations at or
    beyond the quantization clip boundary) as gauges + a streaming
    histogram per site.

The probe itself lives in `rl/ddpg.actor_site_telemetry`; this module only
aggregates.
"""

from __future__ import annotations

import math
from typing import Optional

from repro_torch.core.ranges import finalized


def _finite(v: float) -> Optional[float]:
    """inf/-inf (a never-updated RangeStat's raw extrema) -> None, so
    snapshots stay strict-JSON-serializable."""
    return v if math.isfinite(v) else None


def ranges_snapshot(qat_state) -> dict[str, dict]:
    """Per-site host-side summary of a `QATState`'s range monitors:
    ``{site: {a_min, a_max, raw_min, raw_max, count}}``; `{}` when QAT is
    disabled."""
    if qat_state is None or not qat_state.config.enabled:
        return {}
    out = {}
    for site, stat in sorted(qat_state.ranges.items()):
        a_min, a_max = finalized(stat)
        out[site] = {
            "a_min": float(a_min),
            "a_max": float(a_max),
            "raw_min": _finite(float(stat.a_min)),
            "raw_max": _finite(float(stat.a_max)),
            "count": int(stat.count),
        }
    return out


class QATTelemetry:
    """Registry-backed per-site QAT telemetry (see module docstring).

    One instance per engine; every metric lives under ``<prefix>.<site>.*``
    in the shared registry, and `stats()` re-assembles the per-site view
    the engines expose.
    """

    def __init__(self, registry, prefix: str = "qat"):
        self.registry = registry
        self.prefix = prefix
        self._sites: dict[str, dict] = {}  # site -> metric handles

    def _handles(self, site: str) -> dict:
        h = self._sites.get(site)
        if h is None:
            p = f"{self.prefix}.{site}"
            h = self._sites[site] = {
                "a_min": self.registry.gauge(f"{p}.a_min"),
                "a_max": self.registry.gauge(f"{p}.a_max"),
                "count": self.registry.gauge(f"{p}.count"),
                "act_min": self.registry.gauge(f"{p}.act_min"),
                "act_max": self.registry.gauge(f"{p}.act_max"),
                # saturation rates live in [0, 1]: lo=1e-6 keeps the log
                # buckets meaningful, exact zeros land in the underflow
                # bucket and quantile-clamp back to 0.0
                "saturation": self.registry.histogram(f"{p}.saturation", lo=1e-6, hi=2.0, growth=1.25),
            }
        return h

    def record_range(self, site: str, a_min: float, a_max: float, count: Optional[int] = None) -> None:
        """Install a site's (frozen or finalized) quantization range."""
        h = self._handles(site)
        h["a_min"].set(float(a_min))
        h["a_max"].set(float(a_max))
        if count is not None:
            h["count"].set(int(count))

    def record_probe(self, site: str, act_min: float, act_max: float, saturation: float) -> None:
        """Fold one probe's observed extrema + saturation rate for a site
        (latest extrema win; saturation streams into the histogram)."""
        h = self._handles(site)
        h["act_min"].set(float(act_min))
        h["act_max"].set(float(act_max))
        h["saturation"].observe(float(saturation))

    def record_state(self, qat_state) -> dict[str, dict]:
        """Snapshot a live `QATState`'s ranges into the registry; returns
        the snapshot."""
        snap = ranges_snapshot(qat_state)
        for site, s in snap.items():
            self.record_range(site, s["a_min"], s["a_max"], s["count"])
        return snap

    def stats(self) -> dict[str, dict]:
        """Per-site view: quantization range, latest observed activation
        extrema, and the saturation-rate digest (mean + p99 across probes).
        `{}` until something was recorded."""
        out = {}
        for site, h in sorted(self._sites.items()):
            sat = h["saturation"].summary()
            entry = {
                "a_min": h["a_min"].value,
                "a_max": h["a_max"].value,
                "act_min": h["act_min"].value,
                "act_max": h["act_max"].value,
                "saturation": sat["mean"],
                "saturation_p99": sat["p99"],
                "probes": sat["count"],
            }
            if h["count"].value is not None:
                entry["count"] = h["count"].value
            out[site] = entry
        return out

    def reset(self) -> None:
        for h in self._sites.values():
            for m in h.values():
                m.reset()


__all__ = ["QATTelemetry", "ranges_snapshot"]
