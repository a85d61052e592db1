"""Registry exporters: wire JSON, Prometheus text exposition, JSONL logs.

A copy of `repro.obs.export` (stdlib only) for the port.

The metrics registry is mergeable precisely so a fleet of
engine hosts could be read from one place; this module is the shipping
layer that makes it happen:

  * **Wire form** — `MetricsRegistry.to_wire()` / `from_wire()` (in
    `obs/metrics`) are the lossless round-trip; `as_wire` here normalizes
    "registry or already-wire dict" inputs for every renderer below.
  * **Prometheus text exposition** — `render_prometheus` renders a
    registry (or wire snapshot) in the text format Prometheus scrapes:
    counters and gauges as single samples, streaming histograms as
    cumulative ``_bucket{le=...}`` series plus ``_sum``/``_count``.  The
    log-bucket layout ships only its occupied buckets (plus ``+Inf``), so
    a ~190-bucket histogram costs a handful of lines in practice.
  * **JSONL snapshot log** — `write_snapshot_jsonl` appends one compact
    wire snapshot per line (a poor-man's TSDB: replayable, mergeable,
    greppable); `read_snapshot_jsonl` parses it back.

`obs/server.ObsServer` serves `render_prometheus` under ``/metrics`` and
the wire form under ``/snapshot``; `obs/aggregate.FleetAggregator` ingests
the wire form from N hosts and re-exports the merged registry through the
same renderers — one code path from a single process to a fleet.
"""

from __future__ import annotations

import json
import math
import re
from typing import Optional

from repro_torch.obs.metrics import MetricsRegistry

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def as_wire(source) -> dict:
    """Normalize a `MetricsRegistry` or an already-wire dict to wire form."""
    if isinstance(source, MetricsRegistry):
        return source.to_wire()
    if isinstance(source, dict):
        return source
    raise TypeError(f"expected MetricsRegistry or wire dict, got {type(source).__name__}")


def prom_name(name: str) -> str:
    """A registry metric name as a valid Prometheus metric name
    (dots/dashes -> underscores; leading digits get an underscore)."""
    out = _NAME_RE.sub("_", name)
    if out and out[0].isdigit():
        out = "_" + out
    return out


def _escape(v) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"')


def _labels_str(labels: Optional[dict], extra: Optional[dict] = None) -> str:
    merged = dict(labels or {})
    if extra:
        merged.update(extra)
    if not merged:
        return ""
    body = ",".join(f'{k}="{_escape(v)}"' for k, v in sorted(merged.items()))
    return "{" + body + "}"


def _num(v) -> str:
    if v is None or (isinstance(v, float) and not math.isfinite(v)):
        return "NaN"
    return repr(float(v)) if isinstance(v, float) else str(v)


def render_prometheus(source, labels: Optional[dict] = None) -> str:
    """Render a registry (or wire snapshot) as Prometheus text exposition.

    `labels` (optional) attach to every sample — a fleet aggregator uses
    ``{"host": ...}`` to keep per-host series apart in one scrape.  Unset
    gauges are skipped (Prometheus has no "no value yet" sample); the
    snapshot `meta` stamp ships as ``obs_snapshot_ts`` / ``obs_snapshot_seq``
    gauges so scrapers can alert on stale exporters.
    """
    wire = as_wire(source)
    lines: list[str] = []

    def sample(name, kind, value, extra=None):
        lines.append(f"# TYPE {name} {kind}")
        lines.append(f"{name}{_labels_str(labels, extra)} {_num(value)}")

    meta = wire.get("meta", {})
    if meta:
        sample("obs_snapshot_ts", "gauge", meta.get("snapshot_ts"))
        sample("obs_snapshot_seq", "gauge", meta.get("seq"))
    for name, v in sorted(wire.get("counters", {}).items()):
        sample(prom_name(name), "counter", v)
    for name, v in sorted(wire.get("gauges", {}).items()):
        if v is not None:
            sample(prom_name(name), "gauge", v)
    for name, h in sorted(wire.get("histograms", {}).items()):
        pname = prom_name(name)
        lines.append(f"# TYPE {pname} histogram")
        counts = h["counts"]
        lo, growth = h["lo"], h["growth"]
        n = len(counts) - 2
        cum = 0
        # cumulative occupied buckets only: the log layout's upper edge for
        # bucket i (1-based) is lo*growth^i; the underflow bucket's is lo
        for i, c in enumerate(counts[:-1]):
            if c == 0:
                continue
            cum += c
            le = lo if i == 0 else lo * growth ** min(i, n)
            lines.append(f"{pname}_bucket" f"{_labels_str(labels, {'le': f'{le:.6g}'})} {cum}")
        lines.append(f"{pname}_bucket" f"{_labels_str(labels, {'le': '+Inf'})} {h['count']}")
        lines.append(f"{pname}_sum{_labels_str(labels)} {_num(h['sum'])}")
        lines.append(f"{pname}_count{_labels_str(labels)} {h['count']}")
    return "\n".join(lines) + "\n"


def render_jsonl(source) -> str:
    """One compact JSON line for a registry (or wire) snapshot."""
    return json.dumps(as_wire(source), separators=(",", ":"), sort_keys=True)


def write_snapshot_jsonl(path, source, append: bool = True) -> str:
    """Append (default) or overwrite one wire snapshot line at `path`."""
    with open(path, "a" if append else "w") as fh:
        fh.write(render_jsonl(source) + "\n")
    return str(path)


def read_snapshot_jsonl(path) -> list[dict]:
    """Parse a snapshot JSONL log back to wire dicts."""
    out = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


__all__ = [
    "as_wire",
    "prom_name",
    "render_prometheus",
    "render_jsonl",
    "write_snapshot_jsonl",
    "read_snapshot_jsonl",
]
