"""Declarative SLO rules + watchdog over (aggregated) registry snapshots.

A copy of `repro.obs.slo` (stdlib only) for the port.

The last fleet-telemetry layer: given a registry — one host's, or the
merged fleet registry out of `obs/aggregate.FleetAggregator` — evaluate a
set of declarative rules and emit structured alert events when they
breach.  Rules are small dataclasses over metric-name patterns
(`fnmatch`-style), so one rule covers every engine and every host that
publishes under the same naming discipline:

  * `HistogramCeiling` — a quantile (or mean) of any matching streaming
    histogram must stay under a ceiling: request-latency p99 SLOs
    (``serve.latency_s``), QAT clip-saturation budgets
    (``*.qat.*.saturation``);
  * `GaugeCeiling` — any matching gauge must stay at/below a ceiling:
    dispatch-calibration staleness (``*.dispatch_audit.stale`` flips to
    1.0 when a host's cost model drifts past threshold — rerun the bench,
    refit via `CostModel.from_bench`);
  * `CounterCeiling` — lifetime counters that should stay at/below a
    budget (e.g. ``ft.failures``);
  * `HeartbeatGap` — per-host snapshot age from the aggregator's
    liveness view must stay under a gap (a host that stopped shipping
    snapshots is unhealthy even if nothing it last reported was).

`SLOWatchdog.evaluate` returns the alert list and feeds two sinks: the
registry (``slo.<rule>.firing`` gauges, ``slo.<rule>.breaches`` counters —
alerts are themselves metrics, exportable and aggregatable like any
other) and the tracer (one instant event per alert, so breaches land on
the Perfetto timeline next to the spans that caused them).
"""

from __future__ import annotations

import dataclasses
import fnmatch
import time
from typing import Optional, Sequence

from repro_torch.obs.metrics import Counter, Gauge, Histogram, MetricsRegistry
from repro_torch.obs.trace import NULL_TRACER


@dataclasses.dataclass(frozen=True)
class SLOView:
    """What one evaluation sees: the registry under test, the per-host
    liveness map (from `FleetAggregator.hosts()`; empty for single-host
    checks), the evaluation wall clock, and — for fleets — the per-host
    gauge breakdown (gauges merge last-write-wins, so without it one
    healthy host's 0.0 could mask another's breached 1.0)."""

    registry: MetricsRegistry
    hosts: dict
    now: float
    gauges_by_host: dict = dataclasses.field(default_factory=dict)

    def matching(self, pattern: str, kind) -> list[tuple[str, object]]:
        out = []
        for name in self.registry.names():
            if fnmatch.fnmatchcase(name, pattern):
                m = self.registry.get(name)
                if isinstance(m, kind):
                    out.append((name, m))
        return out


def _alert(rule: "SLORule", view: SLOView, metric: str, value, threshold, message: str) -> dict:
    return {
        "rule": rule.name,
        "severity": rule.severity,
        "metric": metric,
        "value": value,
        "threshold": threshold,
        "message": message,
        "ts": view.now,
    }


@dataclasses.dataclass(frozen=True)
class SLORule:
    """Base rule: `name` keys the watchdog's per-rule metrics, `severity`
    rides on every alert (informational — routing is the consumer's
    job)."""

    name: str
    severity: str = "warning"

    def evaluate(self, view: SLOView) -> list[dict]:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class HistogramCeiling(SLORule):
    """``stat(histogram)`` must stay <= `ceiling` for every histogram
    matching `pattern`.  `stat` is ``"mean"`` or a quantile like
    ``"p99"``/``"p50"``; histograms with fewer than `min_count`
    observations are skipped (no alerting off one noisy sample)."""

    pattern: str = "*"
    stat: str = "p99"
    ceiling: float = 0.0
    min_count: int = 1

    def _stat(self, h: Histogram) -> Optional[float]:
        if self.stat == "mean":
            s = h.summary()
            return s["mean"]
        if self.stat.startswith("p"):
            return h.quantile(float(self.stat[1:]) / 100.0)
        raise ValueError(f"unknown stat {self.stat!r}; 'mean' or 'pNN'")

    def evaluate(self, view: SLOView) -> list[dict]:
        out = []
        for name, h in view.matching(self.pattern, Histogram):
            if h.count < self.min_count:
                continue
            v = self._stat(h)
            if v is not None and v > self.ceiling:
                msg = (
                    f"{name} {self.stat}={v:.6g} exceeds ceiling "
                    f"{self.ceiling:.6g} over {h.count} observations"
                )
                out.append(_alert(self, view, name, v, self.ceiling, msg))
        return out


@dataclasses.dataclass(frozen=True)
class GaugeCeiling(SLORule):
    """Every gauge matching `pattern` must stay <= `ceiling` (unset
    gauges pass).  With ceiling 0.0 this is a boolean-flag rule: any
    ``*.stale``-style gauge set to 1.0 fires.

    Against a fleet view the rule checks the per-host breakdown instead
    of the last-write-wins merged value: a breach on ANY host fires (and
    the alert names the host), whichever host's snapshot arrived last."""

    pattern: str = "*"
    ceiling: float = 0.0

    def evaluate(self, view: SLOView) -> list[dict]:
        out = []
        for name, g in view.matching(self.pattern, Gauge):
            per = view.gauges_by_host.get(name)
            if per:
                for host, v in sorted(per.items()):
                    if v is not None and v > self.ceiling:
                        msg = f"{name}={v:.6g} on host {host} exceeds ceiling {self.ceiling:.6g}"
                        out.append(_alert(self, view, f"{name}@{host}", v, self.ceiling, msg))
                continue
            v = g.value
            if v is not None and v > self.ceiling:
                msg = f"{name}={v:.6g} exceeds ceiling {self.ceiling:.6g}"
                out.append(_alert(self, view, name, v, self.ceiling, msg))
        return out


@dataclasses.dataclass(frozen=True)
class CounterCeiling(SLORule):
    """Every counter matching `pattern` must stay <= `ceiling` (a
    lifetime budget, e.g. ``ft.failures`` <= 0)."""

    pattern: str = "*"
    ceiling: float = 0.0

    def evaluate(self, view: SLOView) -> list[dict]:
        out = []
        for name, c in view.matching(self.pattern, Counter):
            v = c.value
            if v > self.ceiling:
                msg = f"{name}={v:.6g} exceeds budget {self.ceiling:.6g}"
                out.append(_alert(self, view, name, v, self.ceiling, msg))
        return out


@dataclasses.dataclass(frozen=True)
class HeartbeatGap(SLORule):
    """Every host in the aggregator's liveness view must have shipped a
    snapshot within `max_gap_s` (by the snapshot's own wall-clock stamp).
    Dead hosts (heartbeat timeout) always fire."""

    max_gap_s: float = 10.0

    def evaluate(self, view: SLOView) -> list[dict]:
        out = []
        for host, h in sorted(view.hosts.items()):
            gap = h.get("snapshot_age_s")
            if not h.get("alive", True):
                msg = f"host {host} is dead (no snapshot ingested within the heartbeat timeout)"
                out.append(_alert(self, view, f"hosts.{host}", gap, self.max_gap_s, msg))
            elif gap is not None and gap > self.max_gap_s:
                msg = (
                    f"host {host} last snapshot {gap:.1f}s ago "
                    f"exceeds max gap {self.max_gap_s:.1f}s"
                )
                out.append(_alert(self, view, f"hosts.{host}", gap, self.max_gap_s, msg))
        return out


def default_rules(
    *,
    latency_p99_s: float = 0.25,
    saturation_mean_max: float = 0.05,
    heartbeat_gap_s: float = 10.0,
) -> list[SLORule]:
    """The standard fleet rule set: serve/learner latency p99 ceilings,
    dispatch-calibration staleness, QAT clip-saturation budget, host
    failure budget, and the heartbeat gap."""
    return [
        HistogramCeiling(
            name="serve-latency-p99",
            pattern="serve.latency_s",
            stat="p99",
            ceiling=latency_p99_s,
            severity="critical",
        ),
        HistogramCeiling(
            name="learner-latency-p99",
            pattern="learner.latency_s",
            stat="p99",
            ceiling=latency_p99_s,
        ),
        GaugeCeiling(
            name="dispatch-calibration-stale",
            pattern="*.dispatch_audit.stale",
            ceiling=0.0,
        ),
        HistogramCeiling(
            name="qat-clip-saturation",
            pattern="*.qat.*.saturation",
            stat="mean",
            ceiling=saturation_mean_max,
        ),
        CounterCeiling(
            name="host-failures",
            pattern="*ft.failures",
            ceiling=0.0,
            severity="critical",
        ),
        HeartbeatGap(
            name="heartbeat-gap",
            max_gap_s=heartbeat_gap_s,
            severity="critical",
        ),
    ]


class SLOWatchdog:
    """Evaluates a rule set against snapshots; alerts are metrics too.

    `registry` (optional) receives the watchdog's own telemetry under
    ``slo.*``; `tracer` (optional) gets one instant event per alert.
    `evaluate` accepts a `FleetAggregator`, a `MetricsRegistry`, or a wire
    dict — rules run identically against a fleet or one process.
    """

    def __init__(
        self,
        rules: Optional[Sequence[SLORule]] = None,
        *,
        registry: Optional[MetricsRegistry] = None,
        tracer=None,
        clock=time.time,
        max_alerts: int = 1000,
    ):
        self.rules = list(default_rules() if rules is None else rules)
        names = [r.name for r in self.rules]
        dupes = {n for n in names if names.count(n) > 1}
        if dupes:
            raise ValueError(f"duplicate rule names: {sorted(dupes)}")
        self.registry = registry if registry is not None else MetricsRegistry()
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self._clock = clock
        self.max_alerts = max_alerts
        self.alerts: list[dict] = []

    def _view(self, source, hosts: Optional[dict]) -> SLOView:
        # late import to keep slo importable without the aggregate module
        from repro_torch.obs.aggregate import FleetAggregator

        if isinstance(source, FleetAggregator):
            return SLOView(
                source.merged(),
                hosts if hosts is not None else source.hosts(),
                self._clock(),
                source.gauges_by_host(),
            )
        if isinstance(source, MetricsRegistry):
            return SLOView(source, hosts or {}, self._clock())
        if isinstance(source, dict):
            return SLOView(MetricsRegistry.from_wire(source), hosts or {}, self._clock())
        raise TypeError(f"cannot evaluate SLOs against {type(source).__name__}")

    def evaluate(self, source, hosts: Optional[dict] = None) -> list[dict]:
        """Run every rule; returns this evaluation's alerts (empty when
        all SLOs hold) and updates the ``slo.*`` telemetry."""
        view = self._view(source, hosts)
        self.registry.counter("slo.evaluations").inc()
        all_alerts: list[dict] = []
        for rule in self.rules:
            alerts = rule.evaluate(view)
            self.registry.gauge(f"slo.{rule.name}.firing").set(1.0 if alerts else 0.0)
            if alerts:
                self.registry.counter(f"slo.{rule.name}.breaches").inc(len(alerts))
                for a in alerts:
                    self.tracer.instant("slo.breach", cat="slo", **a)
            all_alerts.extend(alerts)
        if all_alerts:
            self.registry.counter("slo.breaches").inc(len(all_alerts))
        self.alerts.extend(all_alerts)
        del self.alerts[: -self.max_alerts]
        return all_alerts

    def firing(self) -> list[str]:
        """Rule names whose last evaluation breached."""
        return [
            r.name for r in self.rules if self.registry.gauge(f"slo.{r.name}.firing").value == 1.0
        ]

    def health(self) -> dict:
        """A `/healthz`-compatible health source: ok iff nothing fires."""
        firing = self.firing()
        return {
            "ok": not firing,
            "firing": firing,
            "evaluations": self.registry.counter("slo.evaluations").value,
        }


__all__ = [
    "SLORule",
    "HistogramCeiling",
    "GaugeCeiling",
    "CounterCeiling",
    "HeartbeatGap",
    "SLOView",
    "SLOWatchdog",
    "default_rules",
]
