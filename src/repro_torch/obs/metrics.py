"""Process-wide metrics registry: counters, gauges, streaming histograms.

A copy of `repro.obs.metrics` (stdlib-only) for the port.  This is the
first layer of the observability subsystem (`repro_torch.obs`) — the
shared store both engines (`serve/policy`, `train/learner`) report through,
replacing the hand-rolled `_totals` dict + latency deque + `np.percentile`
bookkeeping that used to be copy-pasted between them.

Design constraints, in order:

  * **Thread-safe.**  Engines mutate metrics from drain loops while any
    number of client threads call `stats()`/`snapshot()`; every metric
    guards its state with its own lock (no global registry lock on the hot
    path — creating a metric takes the registry lock once, updating it
    never does).
  * **O(1) memory.**  `Histogram` is a fixed-bucket log-scale streaming
    histogram: ~190 integer buckets cover [1e-7, 1e4) with <= `growth`-1
    relative resolution, so p50/p99 stay accurate at
    millions-of-requests scale without retaining samples (the old deque
    kept the last 100k latencies and re-sorted them on every `stats()`).
  * **Mergeable.**  Two histograms with the same bucket layout add
    bucket-wise (`merge`) — the property the ROADMAP's distributed
    actor–learner fleet needs to aggregate per-host registries into one
    fleet view without shipping samples.
  * **stdlib-only.**  No numpy/jax: `runtime/ft` and future multi-process
    exporters import this module from contexts where neither is welcome.
"""

from __future__ import annotations

import math
import os
import socket
import threading
import time
from typing import Optional, Union

Number = Union[int, float]

WIRE_VERSION = 1


def default_host_id() -> str:
    """`hostname:pid` — the per-process identity snapshots are stamped
    with so a fleet aggregator can tell N processes on one box apart."""
    return f"{socket.gethostname()}:{os.getpid()}"


class Counter:
    """Monotonic counter (int or float increments)."""

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value: Number = 0

    def inc(self, n: Number = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> Number:
        with self._lock:
            return self._value

    def reset(self) -> None:
        with self._lock:
            self._value = 0


class Gauge:
    """Last-write-wins scalar (None until first `set`)."""

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value: Optional[Number] = None

    def set(self, v: Number) -> None:
        with self._lock:
            self._value = v

    def set_once(self, v: Number) -> None:
        """Set only if never set (e.g. first-submit timestamps)."""
        with self._lock:
            if self._value is None:
                self._value = v

    @property
    def value(self) -> Optional[Number]:
        with self._lock:
            return self._value

    def reset(self) -> None:
        with self._lock:
            self._value = None


class Histogram:
    """Fixed-bucket log-scale streaming histogram with mergeable quantiles.

    Bucket ``i`` (1-based) covers ``[lo * growth**(i-1), lo * growth**i)``;
    bucket 0 catches values below ``lo`` (including zeros/negatives — e.g.
    saturation rates of exactly 0.0) and the last bucket everything at or
    above ``hi``.  Quantiles interpolate geometrically inside a bucket and
    clamp to the exact observed [min, max], so the relative error of any
    in-range quantile is bounded by ``growth - 1`` (15% at the default) —
    tests/obs/test_metrics.py pins this against ``np.percentile``.
    """

    __slots__ = (
        "lo",
        "hi",
        "growth",
        "_log_growth",
        "_n",
        "_lock",
        "_counts",
        "_count",
        "_sum",
        "_min",
        "_max",
    )

    def __init__(self, lo: float = 1e-7, hi: float = 1e4, growth: float = 1.15):
        if not (0 < lo < hi) or growth <= 1.0:
            raise ValueError(
                f"need 0 < lo < hi and growth > 1; got lo={lo}, hi={hi}, growth={growth}"
            )
        self.lo, self.hi, self.growth = lo, hi, growth
        self._log_growth = math.log(growth)
        self._n = int(math.ceil(math.log(hi / lo) / self._log_growth))
        self._lock = threading.Lock()
        self._counts = [0] * (self._n + 2)  # [under, b1..bn, over]
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf

    def _index(self, v: float) -> int:
        if v < self.lo:
            return 0
        i = int(math.log(v / self.lo) / self._log_growth) + 1
        return min(i, self._n + 1)

    def observe(self, v: Number) -> None:
        v = float(v)
        i = self._index(v)
        with self._lock:
            self._counts[i] += 1
            self._count += 1
            self._sum += v
            self._min = min(self._min, v)
            self._max = max(self._max, v)

    def merge(self, other: "Histogram") -> None:
        """Fold another histogram (same bucket layout) into this one."""
        if (other.lo, other.hi, other.growth) != (self.lo, self.hi, self.growth):
            raise ValueError(
                f"bucket layouts differ: ({self.lo}, {self.hi}, {self.growth}) "
                f"vs ({other.lo}, {other.hi}, {other.growth})"
            )
        with other._lock:
            counts = list(other._counts)
            count, total = other._count, other._sum
            mn, mx = other._min, other._max
        with self._lock:
            for i, c in enumerate(counts):
                self._counts[i] += c
            self._count += count
            self._sum += total
            self._min = min(self._min, mn)
            self._max = max(self._max, mx)

    def quantile(self, q: float) -> Optional[float]:
        """The q-quantile (q in [0, 1]); None when empty."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile {q} outside [0, 1]")
        with self._lock:
            if self._count == 0:
                return None
            counts = list(self._counts)
            count, mn, mx = self._count, self._min, self._max
        rank = q * count
        cum = 0.0
        for i, c in enumerate(counts):
            if c == 0:
                continue
            if cum + c >= rank:
                if i == 0:
                    return mn  # underflow: exact floor
                if i == self._n + 1:
                    return mx  # overflow: exact ceiling
                # geometric interpolation inside [lo*g^(i-1), lo*g^i)
                frac = (rank - cum) / c
                v = self.lo * math.exp((i - 1 + frac) * self._log_growth)
                return min(max(v, mn), mx)
            cum += c
        return mx

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    def summary(self) -> dict:
        """Scalar digest: count/mean/min/max plus p50/p99."""
        with self._lock:
            if self._count == 0:
                return {
                    "count": 0,
                    "mean": None,
                    "min": None,
                    "max": None,
                    "p50": None,
                    "p99": None,
                }
            count, total = self._count, self._sum
            mn, mx = self._min, self._max
        return {
            "count": count,
            "mean": total / count,
            "min": mn,
            "max": mx,
            "p50": self.quantile(0.50),
            "p99": self.quantile(0.99),
        }

    def reset(self) -> None:
        with self._lock:
            self._counts = [0] * (self._n + 2)
            self._count = 0
            self._sum = 0.0
            self._min = math.inf
            self._max = -math.inf

    # ------------------------------------------------------------------ #
    # wire round-trip (strict-JSON-safe, lossless)
    # ------------------------------------------------------------------ #

    def to_dict(self) -> dict:
        """The full histogram state as plain JSON-serializable values.

        Lossless: `from_dict(h.to_dict())` reproduces the exact bucket
        counts, count/sum, and observed extrema, so the reconstruction's
        quantiles are bit-for-bit the original's.  Empty histograms encode
        their +/-inf extrema as None (strict JSON has no Infinity).
        """
        with self._lock:
            return {
                "lo": self.lo,
                "hi": self.hi,
                "growth": self.growth,
                "counts": list(self._counts),
                "count": self._count,
                "sum": self._sum,
                "min": self._min if self._count else None,
                "max": self._max if self._count else None,
            }

    @classmethod
    def from_dict(cls, d: dict) -> "Histogram":
        """Reconstruct a histogram from `to_dict` output (wire inverse)."""
        h = cls(lo=d["lo"], hi=d["hi"], growth=d["growth"])
        counts = list(d["counts"])
        if len(counts) != len(h._counts):
            raise ValueError(
                f"wire counts length {len(counts)} does not match the "
                f"layout's {len(h._counts)} buckets"
            )
        h._counts = counts
        h._count = int(d["count"])
        h._sum = float(d["sum"])
        h._min = math.inf if d["min"] is None else float(d["min"])
        h._max = -math.inf if d["max"] is None else float(d["max"])
        return h


class MetricsRegistry:
    """Named get-or-create store of counters/gauges/histograms.

    `counter("a.b")` et al. are idempotent — the first call creates, later
    calls return the same object (a `TypeError` if the name is already a
    different kind).  `snapshot()` renders everything to plain
    JSON-serializable python values; `reset()` zeroes every metric in
    place (holders' cached handles stay valid).

    Every snapshot (and wire export) carries a `meta` stamp — host/process
    identity (`host`, default `hostname:pid`), a wall-clock `snapshot_ts`,
    and a per-registry monotonic `seq` — so a fleet aggregator can order a
    host's snapshots and measure their staleness without any caller-side
    bookkeeping.
    """

    def __init__(self, host: Optional[str] = None):
        self._lock = threading.Lock()
        self._metrics: dict[str, object] = {}
        self.host = host if host is not None else default_host_id()
        self._seq = 0

    def _get_or_create(self, name: str, kind, factory):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = factory()
                self._metrics[name] = m
            elif not isinstance(m, kind):
                raise TypeError(f"metric {name!r} is a {type(m).__name__}, not a {kind.__name__}")
            return m

    def counter(self, name: str) -> Counter:
        return self._get_or_create(name, Counter, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get_or_create(name, Gauge, Gauge)

    def histogram(
        self, name: str, lo: float = 1e-7, hi: float = 1e4, growth: float = 1.15
    ) -> Histogram:
        return self._get_or_create(name, Histogram, lambda: Histogram(lo, hi, growth))

    def install_histogram(self, name: str, hist: Histogram) -> Histogram:
        """Install a reconstructed histogram under `name` (the wire /
        fleet-merge path, where bucket state arrives whole instead of
        streaming in).  TypeError if the name already holds a different
        kind; an existing histogram is replaced."""
        with self._lock:
            have = self._metrics.get(name)
            if have is not None and not isinstance(have, Histogram):
                raise TypeError(f"metric {name!r} is a {type(have).__name__}, not a Histogram")
            self._metrics[name] = hist
            return hist

    def get(self, name: str):
        with self._lock:
            return self._metrics.get(name)

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._metrics)

    def _meta(self) -> dict:
        """One snapshot stamp: identity + wall clock + monotonic seq."""
        with self._lock:
            self._seq += 1
            seq = self._seq
        return {"host": self.host, "pid": os.getpid(), "snapshot_ts": time.time(), "seq": seq}

    def snapshot(self) -> dict:
        """All metrics rendered to plain values, grouped by kind, plus the
        `meta` identity/timestamp stamp.  Always `json.dumps`-able."""
        with self._lock:
            items = list(self._metrics.items())
        out: dict[str, dict] = {
            "meta": self._meta(),
            "counters": {},
            "gauges": {},
            "histograms": {},
        }
        for name, m in sorted(items):
            if isinstance(m, Counter):
                out["counters"][name] = m.value
            elif isinstance(m, Gauge):
                out["gauges"][name] = m.value
            elif isinstance(m, Histogram):
                out["histograms"][name] = m.summary()
        return out

    def to_wire(self) -> dict:
        """The whole registry as a lossless, strict-JSON-safe wire dict.

        Unlike `snapshot()` (whose histograms are scalar digests), the
        wire form carries full histogram bucket state via
        `Histogram.to_dict`, so `from_wire` reconstructs a registry whose
        merged quantiles are bit-for-bit the original's — the shipping
        format `obs/aggregate.FleetAggregator` ingests.
        """
        with self._lock:
            items = list(self._metrics.items())
        out: dict = {
            "version": WIRE_VERSION,
            "meta": self._meta(),
            "counters": {},
            "gauges": {},
            "histograms": {},
        }
        for name, m in sorted(items):
            if isinstance(m, Counter):
                out["counters"][name] = m.value
            elif isinstance(m, Gauge):
                out["gauges"][name] = m.value
            elif isinstance(m, Histogram):
                out["histograms"][name] = m.to_dict()
        return out

    @classmethod
    def from_wire(cls, wire: dict) -> "MetricsRegistry":
        """Reconstruct a registry from `to_wire` output (wire inverse).

        The reconstruction keeps the sender's host identity, so an
        aggregator can ingest it without separate bookkeeping.
        """
        version = wire.get("version")
        if version != WIRE_VERSION:
            raise ValueError(f"unsupported wire version {version!r}; expected {WIRE_VERSION}")
        reg = cls(host=wire.get("meta", {}).get("host"))
        for name, v in wire.get("counters", {}).items():
            reg.counter(name).inc(v)
        for name, v in wire.get("gauges", {}).items():
            if v is not None:
                reg.gauge(name).set(v)
            else:
                reg.gauge(name)
        for name, d in wire.get("histograms", {}).items():
            reg.install_histogram(name, Histogram.from_dict(d))
        return reg

    def reset(self) -> None:
        with self._lock:
            items = list(self._metrics.values())
        for m in items:
            m.reset()


__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "WIRE_VERSION", "default_host_id"]
