"""repro_torch.obs — the port's observability subsystem (subset of
`repro.obs`).

  1. Metrics registry (`obs/metrics`, a copy): thread-safe counters,
     gauges and mergeable log-bucket streaming histograms.
  2. Span tracing (`obs/trace`, a copy): zero-overhead-when-disabled spans,
     exported as Chrome trace-event JSONL.
  3. Domain telemetry: the shared engine surface (`obs/engine`, a copy),
     the dispatch predicted-vs-measured audit (`obs/audit`, a copy) and QAT
     range/saturation telemetry (`obs/qat`, ported against
     `repro_torch.core.ranges`).

The fleet layer of the reference — exporters, the per-host HTTP endpoint
(`serve_http`), aggregation and SLO rules — is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.obs.audit import DispatchAudit
from repro_torch.obs.engine import EngineMetrics
from repro_torch.obs.metrics import Counter, Gauge, Histogram, MetricsRegistry, default_host_id
from repro_torch.obs.qat import QATTelemetry, ranges_snapshot
from repro_torch.obs.trace import NULL_TRACER, Tracer, read_jsonl


@dataclasses.dataclass
class Observability:
    """Per-engine observability configuration + shared sinks.

    * `registry` — the metrics store; pass one instance to several engines
      to get a single process-wide surface.  Defaults to a fresh registry.
    * `tracer` — span sink; defaults to the shared disabled tracer
      (`NULL_TRACER`), which makes every span site a no-op.
    * `audit_threshold` — drift factor above which the dispatch audit flags
      the cost model stale (see `obs/audit.DispatchAudit`).
    * `qat_probe_every` — run the QAT activation-saturation probe every N
      engine calls (0 = only when `record_qat_telemetry` is called).

    The bundle is a context manager: `close()` flushes the tracer.
    """

    registry: MetricsRegistry = dataclasses.field(default_factory=MetricsRegistry)
    tracer: Tracer = dataclasses.field(default_factory=lambda: NULL_TRACER)
    audit_threshold: float = 3.0
    qat_probe_every: int = 0
    _health: dict = dataclasses.field(default_factory=dict, init=False, repr=False)

    @classmethod
    def tracing(cls, trace_path=None, **kwargs) -> "Observability":
        """An enabled-tracer bundle; `trace_path` makes the tracer
        self-flushing on `flush()`/`close()`."""
        return cls(tracer=Tracer(path=trace_path), **kwargs)

    def register_health(self, name: str, source: Callable[[], dict]) -> None:
        """Attach a health check (engines register theirs on construction)."""
        self._health[name] = source

    def flush(self) -> None:
        """Flush the tracer to its configured path (no-op otherwise)."""
        self.tracer.flush()

    def close(self) -> None:
        self.flush()

    def __enter__(self) -> "Observability":
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
    "default_host_id",
]
