"""Fault-tolerance control plane: heartbeats, straggler detection, elastic
re-meshing.  (Host-side logic — exercised against a simulated cluster in
the tests; on a real deployment the heartbeat transport is the
coordination service, everything else is unchanged.)

A copy of `repro.runtime.ft` (stdlib only) for the port.  The port's
`checkpoint.ckpt.restore` takes a `device=`, not a sharding tree: step 4's
sharded restore waits for the port's mesh (`core/parallelism`).

Recovery story:
  1. every host ticks `HeartbeatRegistry` each step;
  2. `detect_failures` marks hosts silent for > timeout as dead;
  3. `plan_elastic_mesh` picks the largest valid (data, model) mesh that fits
     the survivors (model axis preserved — TP degree is baked into layouts;
     data axis shrinks), keeping global batch via more grad accumulation;
  4. the runner rebuilds shardings and `checkpoint.restore(...,
     shardings=new)` resharding the last checkpoint;
  5. `DataSkipAhead` replays the synthetic-data cursor to the restored step.

Straggler mitigation: per-host step-time EMA; hosts slower than
`threshold ×  median` get flagged; the runner either rebalances shard sizes
(`rebalance_weights`) or excludes the host at the next elastic step.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional


@dataclasses.dataclass
class HostState:
    host_id: "int | str"
    last_beat: float = 0.0
    step_time_ema: float = 0.0
    beats: int = 0


class HeartbeatRegistry:
    """Per-host liveness + step-time tracking.

    `metrics` (optional) is an `obs.metrics.MetricsRegistry` — the same
    process-wide registry the engines use (`obs/metrics` is stdlib-only,
    so the control plane can depend on it).  When given, every beat
    mirrors into it under ``<prefix>.*``: a per-host ``last_beat`` gauge
    and ``beats`` counter, one step-time histogram across hosts, and
    counters for detected stragglers and removed (failed) hosts — the
    fleet-health section of a registry snapshot.
    """

    def __init__(self, n_hosts: int, timeout_s: float = 60.0,
                 clock: Callable[[], float] = time.monotonic, *,
                 metrics=None, prefix: str = "ft"):
        self.hosts = {i: HostState(i) for i in range(n_hosts)}
        self.timeout_s = timeout_s
        self.clock = clock
        self._metrics = metrics
        self._prefix = prefix
        if metrics is not None:
            # step times run seconds-scale: the default histogram layout
            # (1e-7 .. 1e4 s) covers μs-fast sim hosts to hours-stuck ones
            self._m_step = metrics.histogram(f"{prefix}.step_time_s")
            self._m_stragglers = metrics.counter(f"{prefix}.stragglers")
            self._m_failures = metrics.counter(f"{prefix}.failures")
            self._m_alive = metrics.gauge(f"{prefix}.hosts_alive")
            self._m_alive.set(len(self.hosts))

    def ensure_host(self, host_id) -> HostState:
        """Register a host on first sight (fleet membership is dynamic:
        `obs/aggregate.FleetAggregator` learns hosts from the snapshots
        they ship, not from a static count).  Idempotent; host ids may be
        ints (the simulated-cluster form) or strings (`hostname:pid`)."""
        h = self.hosts.get(host_id)
        if h is None:
            h = self.hosts[host_id] = HostState(host_id)
            if self._metrics is not None:
                self._m_alive.set(len(self.hosts))
        return h

    def beat(self, host_id, step_time_s: Optional[float] = None):
        h = self.hosts[host_id]
        h.last_beat = self.clock()
        h.beats += 1
        if step_time_s is not None:
            m = 0.9 if h.step_time_ema else 0.0
            h.step_time_ema = m * h.step_time_ema + (1 - m) * step_time_s
        if self._metrics is not None:
            p = f"{self._prefix}.host{host_id}"
            self._metrics.gauge(f"{p}.last_beat").set(h.last_beat)
            self._metrics.counter(f"{p}.beats").inc()
            if step_time_s is not None:
                self._m_step.observe(step_time_s)

    def detect_failures(self) -> list[int]:
        now = self.clock()
        return [i for i, h in self.hosts.items()
                if h.beats > 0 and now - h.last_beat > self.timeout_s]

    def detect_stragglers(self, threshold: float = 2.0) -> list[int]:
        times = sorted(h.step_time_ema for h in self.hosts.values()
                       if h.step_time_ema > 0)
        if not times:
            return []
        median = times[len(times) // 2]
        out = [i for i, h in self.hosts.items()
               if h.step_time_ema > threshold * median]
        if self._metrics is not None and out:
            self._m_stragglers.inc(len(out))
        return out

    def remove(self, host_ids: list[int]):
        for i in host_ids:
            if self.hosts.pop(i, None) is not None \
                    and self._metrics is not None:
                self._m_failures.inc()
        if self._metrics is not None:
            self._m_alive.set(len(self.hosts))


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    data: int
    model: int
    n_devices: int
    grad_accum_factor: int   # extra microbatching to keep global batch


def plan_elastic_mesh(surviving_devices: int, *, model_parallel: int = 16,
                      original_data: int = 16) -> ElasticPlan:
    """Largest (data, model_parallel) mesh fitting the survivors.

    The model axis is preserved (changing TP degree would re-layout every
    weight); the data axis shrinks to the largest power of two that fits,
    and gradient accumulation scales up to hold the global batch constant.
    """
    if surviving_devices < model_parallel:
        raise ValueError(
            f"cannot keep model_parallel={model_parallel} with "
            f"{surviving_devices} devices")
    max_data = surviving_devices // model_parallel
    data = 1 << (max_data.bit_length() - 1)          # floor pow2
    accum = max(1, original_data // data)
    return ElasticPlan(data=data, model=model_parallel,
                       n_devices=data * model_parallel,
                       grad_accum_factor=accum)


def rebalance_weights(step_times: dict[int, float]) -> dict[int, float]:
    """Work-share weights inversely proportional to measured step time
    (slow host gets a smaller data shard).  Normalized to sum to 1."""
    inv = {i: 1.0 / max(t, 1e-6) for i, t in step_times.items()}
    z = sum(inv.values())
    return {i: v / z for i, v in inv.items()}


@dataclasses.dataclass
class DataSkipAhead:
    """Deterministic data-cursor restore: the synthetic pipeline is a pure
    function of (seed, step), so skipping ahead is O(1) — no replayed or
    dropped batches across restarts."""

    seed: int
    step: int = 0

    def restore_to(self, step: int) -> "DataSkipAhead":
        return dataclasses.replace(self, step=step)

    def next_batch_key(self) -> tuple[int, int]:
        key = (self.seed, self.step)
        self.step += 1
        return key


class TrainingSupervisor:
    """Orchestrates the detect -> plan -> restore loop (pure logic; the
    runner wires in real meshes/checkpoints; tests simulate failures)."""

    def __init__(self, n_hosts: int, devices_per_host: int,
                 model_parallel: int = 16, timeout_s: float = 60.0,
                 clock: Callable[[], float] = time.monotonic, *,
                 metrics=None):
        self.registry = HeartbeatRegistry(n_hosts, timeout_s, clock,
                                          metrics=metrics)
        self.devices_per_host = devices_per_host
        self.model_parallel = model_parallel
        self.events: list[dict] = []

    def step_report(self, host_id: int, step_time_s: float):
        self.registry.beat(host_id, step_time_s)

    def check(self) -> Optional[ElasticPlan]:
        dead = self.registry.detect_failures()
        if not dead:
            return None
        self.registry.remove(dead)
        surviving = len(self.registry.hosts) * self.devices_per_host
        plan = plan_elastic_mesh(surviving,
                                 model_parallel=self.model_parallel)
        self.events.append({"type": "elastic_rescale", "dead_hosts": dead,
                            "plan": dataclasses.asdict(plan)})
        return plan
