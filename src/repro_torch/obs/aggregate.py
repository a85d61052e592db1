"""Fleet aggregation: N per-host registry snapshots merged into one view.

A copy of `repro.obs.aggregate` (stdlib only) for the port.

A SEED/IMPALA-shape actor–learner fleet needs one answer to "is the
fleet healthy" without shipping raw samples anywhere: the registry's
histograms are bucket-wise mergeable for exactly this moment.
`FleetAggregator` ingests the lossless wire snapshots hosts export
(`MetricsRegistry.to_wire`, served under `obs/server`'s ``/snapshot``) and
maintains:

  * a **merged registry** — counters summed across hosts, histograms
    bucket-merged (fleet p50/p99 carry the same ≤ growth-1 relative error
    bound as any single host's; merging is exact on bucket counts, so a
    fleet quantile is bit-for-bit the quantile of one registry that saw
    every observation), gauges last-write-wins by snapshot timestamp with
    a per-host breakdown preserved;
  * **per-host liveness/staleness** — every ingest beats a
    `runtime/ft.HeartbeatRegistry` (dynamic membership via `ensure_host`),
    so a host whose snapshots stop arriving flips dead after
    ``staleness_s``; snapshot wall-clock age is reported separately so a
    live host shipping stale data is still visible.

Out-of-order delivery is handled at ingest: a snapshot older (by per-host
monotonic ``seq``, then wall clock) than the one already held for that
host is dropped, not merged backwards.

The merged registry is a real `MetricsRegistry`, so everything downstream
— `export.render_prometheus`, `slo.SLOWatchdog`, another aggregation tier
— runs unchanged against a fleet or a single process.
"""

from __future__ import annotations

import time
from typing import Optional

from repro_torch.obs.export import as_wire
from repro_torch.obs.metrics import Histogram, MetricsRegistry
from repro_torch.runtime.ft import HeartbeatRegistry


class FleetAggregator:
    """Merges host wire snapshots; tracks who is alive and how fresh.

    `staleness_s` is both the heartbeat timeout (no snapshot ingested for
    that long -> host dead) and the snapshot-age threshold reported per
    host.  `metrics` (optional) mirrors fleet health under ``fleet.*`` in
    a registry of the aggregator's own.
    """

    def __init__(
        self,
        *,
        staleness_s: float = 10.0,
        clock=time.time,
        metrics: Optional[MetricsRegistry] = None,
    ):
        self.staleness_s = float(staleness_s)
        self._clock = clock
        self._hosts: dict[str, dict] = {}  # host -> latest wire + ingest_ts
        self.heartbeats = HeartbeatRegistry(
            0, timeout_s=staleness_s, clock=clock, metrics=metrics, prefix="fleet.ft"
        )

    # ------------------------------------------------------------------ #
    # ingest
    # ------------------------------------------------------------------ #

    def ingest(self, source) -> Optional[str]:
        """Fold one host snapshot (registry or wire dict) into the fleet.

        Returns the host id, or None when the snapshot was dropped as
        out-of-order (older seq/timestamp than the one already held).
        """
        wire = as_wire(source)
        meta = wire.get("meta", {})
        host = meta.get("host")
        if not host:
            raise ValueError(
                "snapshot has no meta.host identity; build registries via "
                "obs.MetricsRegistry (its snapshots are stamped automatically)"
            )
        seq = int(meta.get("seq", 0))
        ts = float(meta.get("snapshot_ts", 0.0))
        held = self._hosts.get(host)
        if held is not None and (seq, ts) <= (held["seq"], held["ts"]):
            return None
        self._hosts[host] = {"wire": wire, "seq": seq, "ts": ts, "ingest_ts": self._clock()}
        self.heartbeats.ensure_host(host)
        self.heartbeats.beat(host)
        return host

    # ------------------------------------------------------------------ #
    # liveness / staleness
    # ------------------------------------------------------------------ #

    def hosts(self) -> dict[str, dict]:
        """Per-host health: ``{host: {alive, seq, snapshot_ts,
        snapshot_age_s, ingest_age_s, stale}}``.  `alive` is heartbeat
        liveness (snapshots still arriving); `stale` flags a snapshot
        whose own wall-clock stamp has aged past ``staleness_s`` even if
        ingest is recent (e.g. a replaying or clock-skewed host)."""
        now = self._clock()
        dead = set(self.heartbeats.detect_failures())
        out = {}
        for host, held in sorted(self._hosts.items()):
            snap_age = now - held["ts"]
            out[host] = {
                "alive": host not in dead,
                "seq": held["seq"],
                "snapshot_ts": held["ts"],
                "snapshot_age_s": snap_age,
                "ingest_age_s": now - held["ingest_ts"],
                "stale": snap_age > self.staleness_s,
            }
        return out

    # ------------------------------------------------------------------ #
    # merge
    # ------------------------------------------------------------------ #

    def merged(self) -> MetricsRegistry:
        """One registry holding the whole fleet: counters summed,
        histograms bucket-merged, gauges last-write-wins by snapshot
        timestamp.  Raises ValueError if two hosts export one histogram
        name with different bucket layouts (a config error aggregation
        must not paper over)."""
        reg = MetricsRegistry(host="fleet")
        # oldest-first so a later snapshot's gauges overwrite earlier ones
        for host, held in sorted(self._hosts.items(), key=lambda kv: (kv[1]["ts"], kv[0])):
            wire = held["wire"]
            for name, v in wire.get("counters", {}).items():
                reg.counter(name).inc(v)
            for name, v in wire.get("gauges", {}).items():
                if v is not None:
                    reg.gauge(name).set(v)
                else:
                    reg.gauge(name)
            for name, d in wire.get("histograms", {}).items():
                h = Histogram.from_dict(d)
                have = reg.get(name)
                if have is None:
                    reg.install_histogram(name, h)
                elif isinstance(have, Histogram):
                    try:
                        have.merge(h)
                    except ValueError as err:
                        raise ValueError(
                            f"host {host!r} exports histogram {name!r} "
                            f"with a different bucket layout: {err}"
                        ) from err
                else:
                    raise ValueError(
                        f"host {host!r} exports {name!r} as a histogram "
                        f"but another host exported a {type(have).__name__}"
                    )
        return reg

    def gauges_by_host(self) -> dict[str, dict[str, object]]:
        """Per-gauge per-host breakdown: ``{gauge: {host: value}}`` — the
        detail last-write-wins merging intentionally drops."""
        out: dict[str, dict] = {}
        for host, held in sorted(self._hosts.items()):
            for name, v in held["wire"].get("gauges", {}).items():
                out.setdefault(name, {})[host] = v
        return out

    def snapshot(self) -> dict:
        """The fleet view in one JSON-serializable dict: the merged
        registry's snapshot plus per-host liveness and the per-host gauge
        breakdown."""
        snap = self.merged().snapshot()
        snap["hosts"] = self.hosts()
        snap["gauges_by_host"] = self.gauges_by_host()
        return snap


__all__ = ["FleetAggregator"]
