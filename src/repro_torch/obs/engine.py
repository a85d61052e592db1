"""Shared engine metrics surface — ONE implementation of the bookkeeping
that `serve/policy/engine` and `train/learner/engine` used to hand-roll
separately (`_totals` dict + 100k-sample latency deque + `np.percentile`
per `stats()` call + ad-hoc mode histogram).

A copy of `repro.obs.engine` for the port.

`EngineMetrics` owns the registry handles and the recording discipline;
the engines keep only their `stats()` key names.  Differences between the
two engines are pure naming (`actions` vs `transitions`, `batches` vs
`updates`) and the dispatch phase (`act` vs `train`), so both are
constructor parameters.  The mode histogram is **phase-keyed for both
engines** (``{"act": {mode: n}}`` / ``{"train": {mode: n}}``) — the serve
engine used to emit a flat map while the learner phase-keyed its bench
copy; one key shape means fleet aggregation can merge them blindly.
"""

from __future__ import annotations

import time
from typing import Iterable, Optional

from repro_torch.obs.metrics import MetricsRegistry


class EngineMetrics:
    """Registry-backed request/call telemetry for a streaming engine.

    Everything lives under ``<prefix>.*`` in the shared registry:
    counters (`requests`, items, calls, `device_s`, `occupancy_sum`),
    the request-latency histogram (`latency_s`), first/last activity
    gauges, and one counter per ``dispatch.<phase>.<mode>``.
    """

    def __init__(
        self,
        registry: MetricsRegistry,
        *,
        prefix: str,
        phase: str,
        items_name: str,
        calls_name: str,
    ):
        self.registry = registry
        self.prefix = prefix
        self.phase = phase
        self.items_name = items_name
        self.calls_name = calls_name
        p = prefix
        self._requests = registry.counter(f"{p}.requests")
        self._items = registry.counter(f"{p}.{items_name}")
        self._calls = registry.counter(f"{p}.{calls_name}")
        self._device_s = registry.counter(f"{p}.device_s")
        self._occupancy = registry.counter(f"{p}.occupancy_sum")
        self._latency = registry.histogram(f"{p}.latency_s")
        self._t_first = registry.gauge(f"{p}.t_first")
        self._t_last = registry.gauge(f"{p}.t_last")
        self._modes: dict[str, object] = {}

    # ------------------------------------------------------------------ #
    # recording
    # ------------------------------------------------------------------ #

    def mark_submit(self) -> None:
        """First-submit wall-clock anchor (idempotent)."""
        self._t_first.set_once(time.perf_counter())

    def record_call(self, items: int, bucket: int, mode: str, device_s: float) -> None:
        """One dispatched device call: `items` real rows padded to
        `bucket`, served by `mode` in `device_s` seconds."""
        self._items.inc(items)
        self._calls.inc()
        self._device_s.inc(device_s)
        self._occupancy.inc(items / bucket)
        c = self._modes.get(mode)
        if c is None:
            c = self._modes[mode] = self.registry.counter(
                f"{self.prefix}.dispatch.{self.phase}.{mode}"
            )
        c.inc()

    def record_replies(
        self, n: int, latencies_s: Iterable[float], t_done: Optional[float] = None
    ) -> None:
        """`n` requests resolved; their submit->reply latencies stream
        into the histogram."""
        self._requests.inc(n)
        for lat in latencies_s:
            self._latency.observe(lat)
        self._t_last.set(t_done if t_done is not None else time.perf_counter())

    # ------------------------------------------------------------------ #
    # reading
    # ------------------------------------------------------------------ #

    @property
    def requests(self) -> int:
        return self._requests.value

    @property
    def items(self):
        return self._items.value

    @property
    def calls(self) -> int:
        return self._calls.value

    @property
    def device_s(self) -> float:
        return self._device_s.value

    def wall_s(self) -> Optional[float]:
        t0, t1 = self._t_first.value, self._t_last.value
        return t1 - t0 if t0 is not None and t1 is not None else None

    def occupancy(self) -> Optional[float]:
        calls = self.calls
        return self._occupancy.value / calls if calls else None

    def latency_ms(self, q: float) -> Optional[float]:
        v = self._latency.quantile(q)
        return v * 1e3 if v is not None else None

    def mode_histogram(self) -> dict[str, dict[str, int]]:
        """Phase-keyed dispatch histogram: ``{phase: {mode: n}}``."""
        return {self.phase: {mode: c.value for mode, c in sorted(self._modes.items()) if c.value}}

    def reset(self) -> None:
        for m in (
            self._requests,
            self._items,
            self._calls,
            self._device_s,
            self._occupancy,
            self._latency,
            self._t_first,
            self._t_last,
            *self._modes.values(),
        ):
            m.reset()


__all__ = ["EngineMetrics"]
