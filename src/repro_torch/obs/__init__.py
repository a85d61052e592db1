"""repro_torch.obs — the port's process-wide observability subsystem, a
copy of `repro.obs` (every module stdlib or numpy only; `obs/qat` is
ported against `repro_torch.core.ranges`).

Layered from in-process to fleet-wide, all wired through both engines and
the RL loop:

  1. **Metrics registry** (`obs/metrics`): thread-safe counters, gauges,
     and O(1)-memory log-bucket streaming histograms with mergeable
     p50/p99 — the shared store replacing the per-engine hand-rolled
     totals/deque bookkeeping (`obs/engine.EngineMetrics` is the common
     engine surface).  Snapshots carry a host/pid/timestamp/seq `meta`
     stamp; `to_wire`/`from_wire` are the lossless cross-process format.
  2. **Span tracing** (`obs/trace`): zero-overhead-when-disabled spans
     over the request lifecycle, exported as Chrome trace-event JSONL
     (opens in Perfetto).  A tracer built with a `path` self-flushes on
     `close()`/`__exit__`, so aborted runs keep their traces.
  3. **Domain telemetry**: QAT range/saturation snapshots (`obs/qat`) and
     the dispatch predicted-vs-measured audit with its calibration-drift
     flag (`obs/audit`), mirrored into the registry as
     ``*.dispatch_audit.{drift_factor,stale}`` gauges.
  4. **Fleet layer**: wire/Prometheus/JSONL exporters (`obs/export`), the
     per-host HTTP endpoint serving ``/metrics`` + ``/snapshot`` +
     ``/healthz`` (`obs/server`), cross-process snapshot aggregation with
     liveness/staleness (`obs/aggregate.FleetAggregator`), and the
     declarative SLO watchdog (`obs/slo`).

`Observability` is the bundle the engines take; `serve_http=port` turns on
the host's HTTP endpoint (port 0 binds an ephemeral one — read it back
from ``obs.server.port``), and engines register their health sources
(dispatch drift, serving liveness) on it automatically.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from repro_torch.obs.aggregate import FleetAggregator
from repro_torch.obs.audit import DispatchAudit
from repro_torch.obs.engine import EngineMetrics
from repro_torch.obs.export import (
    as_wire,
    read_snapshot_jsonl,
    render_jsonl,
    render_prometheus,
    write_snapshot_jsonl,
)
from repro_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    default_host_id,
)
from repro_torch.obs.qat import QATTelemetry, ranges_snapshot
from repro_torch.obs.server import ObsServer
from repro_torch.obs.slo import (
    CounterCeiling,
    GaugeCeiling,
    HeartbeatGap,
    HistogramCeiling,
    SLORule,
    SLOWatchdog,
    default_rules,
)
from repro_torch.obs.trace import NULL_TRACER, Tracer, read_jsonl


@dataclasses.dataclass
class Observability:
    """Per-engine observability configuration + shared sinks.

    * `registry` — the metrics store; pass one instance to several
      engines (and `runtime/ft.HeartbeatRegistry`) to get a single
      process-wide export surface.  Defaults to a fresh private registry.
    * `tracer` — span sink; defaults to the shared disabled tracer
      (`NULL_TRACER`), which makes every span site a no-op.
    * `audit_threshold` — drift factor above which the dispatch audit
      flags the cost model stale (see `obs/audit.DispatchAudit`).
    * `qat_probe_every` — run the QAT activation-saturation probe every
      N engine calls (0 = only when `record_qat_telemetry` is called
      explicitly).  The probe is one extra jitted forward per sampled
      batch, so keep N >> 1 under load.
    * `serve_http` — when not None, `ensure_server()` (which the engines
      call at construction) starts an `ObsServer` on this port (0 =
      ephemeral) serving the registry's ``/metrics``, ``/snapshot``, and
      ``/healthz``; `http_host` picks the bind address.

    The bundle is a context manager: `close()` flushes the tracer (to its
    configured path, if any) and stops the HTTP server.
    """

    registry: MetricsRegistry = dataclasses.field(default_factory=MetricsRegistry)
    tracer: Tracer = dataclasses.field(default_factory=lambda: NULL_TRACER)
    audit_threshold: float = 3.0
    qat_probe_every: int = 0
    serve_http: Optional[int] = None
    http_host: str = "127.0.0.1"
    server: Optional[ObsServer] = dataclasses.field(default=None, init=False, repr=False)
    _health: dict = dataclasses.field(default_factory=dict, init=False, repr=False)

    @classmethod
    def tracing(cls, trace_path=None, **kwargs) -> "Observability":
        """An enabled-tracer bundle (convenience for examples/benches).
        `trace_path` makes the tracer self-flushing: `flush()`/`close()`
        (and the engines' `close()`) write the trace there, so an aborted
        run still lands it on disk."""
        return cls(tracer=Tracer(path=trace_path), **kwargs)

    # ------------------------------------------------------------------ #
    # HTTP endpoint + health
    # ------------------------------------------------------------------ #

    def ensure_server(self) -> Optional[ObsServer]:
        """Start the HTTP endpoint once `serve_http` is configured
        (idempotent; returns the running server or None)."""
        if self.serve_http is None:
            return None
        if self.server is None:
            self.server = ObsServer(
                self.registry,
                host=self.http_host,
                port=self.serve_http,
                health_sources=dict(self._health),
            ).start()
        return self.server

    def register_health(self, name: str, source: Callable[[], dict]) -> None:
        """Attach a `/healthz` check (engines register theirs on
        construction); kept on the bundle so a later `ensure_server`
        still sees sources registered before the server existed."""
        self._health[name] = source
        if self.server is not None:
            self.server.register_health(name, source)

    # ------------------------------------------------------------------ #
    # lifecycle
    # ------------------------------------------------------------------ #

    def flush(self) -> None:
        """Flush the tracer to its configured path (no-op otherwise)."""
        self.tracer.flush()

    def close(self) -> None:
        """Flush the tracer and stop the HTTP server (idempotent)."""
        self.flush()
        if self.server is not None:
            self.server.stop()
            self.server = None

    def __enter__(self) -> "Observability":
        self.ensure_server()
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False


__all__ = [
    "Observability",
    "MetricsRegistry",
    "Counter",
    "Gauge",
    "Histogram",
    "EngineMetrics",
    "Tracer",
    "NULL_TRACER",
    "read_jsonl",
    "DispatchAudit",
    "QATTelemetry",
    "ranges_snapshot",
    "FleetAggregator",
    "ObsServer",
    "SLOWatchdog",
    "SLORule",
    "HistogramCeiling",
    "GaugeCeiling",
    "CounterCeiling",
    "HeartbeatGap",
    "default_rules",
    "render_prometheus",
    "render_jsonl",
    "write_snapshot_jsonl",
    "read_snapshot_jsonl",
    "as_wire",
    "default_host_id",
]
