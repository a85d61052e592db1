"""`StreamEngine` — the shared request-lifecycle core of every engine.

A copy of `repro.runtime.engine.base` for the port, with its imports
rewritten.  One implementation of the machinery `serve/policy` and `train/learner`
used to carry separately (and `serve/lm` would have re-derived a third
time):

  * observability wiring — `EngineMetrics` (registry-backed totals,
    latency histogram, occupancy, phase-keyed mode histogram), the
    optional `DispatchAudit` (predicted-vs-measured, when the engine has
    a cost model), `QATTelemetry`, and health registration;
  * the adaptive dispatch hook — `choose_mode(bucket)` over the engine's
    phase axis, with `force_mode` pinning;
  * the serve-thread lifecycle — `start` / `stop` (close-before-drain:
    sustained client traffic cannot livelock the shutdown, and any
    request that races past the close is failed loudly, never left
    unresolved) / `close` (stop + tracer flush) / context manager;
  * the drain loop — `_serve_loop` ticks `_tick(timeout)`; the default
    tick coalesces one micro-batch (`queue.next_batch`), runs the
    subclass's `_process(reqs)`, relays errors to every caller, and
    replies with full span coverage (`<prefix>.coalesce` → … →
    `<prefix>.reply` + per-request `<prefix>.request` completes).

Subclasses provide a `CoalescingQueue` (their typed submit surface), a
`_process(reqs) -> results` (micro-batching engines), or override
`_tick` entirely (continuous batching, where admission and eviction
replace coalescing — see `serve/lm`).  Client-visible strings (error
messages, health keys, thread names) are class attributes so the
pre-refactor public surfaces stay byte-identical.
"""

from __future__ import annotations

import threading
import time
from typing import Optional, Sequence

from repro_torch.obs import DispatchAudit, EngineMetrics, Observability, QATTelemetry
from repro_torch.runtime.engine.queue import CoalescingQueue


class StreamEngine:
    """Threaded request-streaming engine over a `CoalescingQueue`.

    Synchronous use is subclass-defined (`run_batch` / `run_update` /
    `generate_batch`); threaded use is uniform: `start()`, submit via the
    subclass surface, `stop()` to drain and join, `close()` for good.
    """

    # client-visible strings — subclasses override to keep their
    # pre-refactor public surface (pinned by the engine test suites)
    not_running_msg = "engine not running; call start() first"
    already_started_msg = "engine already started"
    stopped_msg = "engine stopped before serving this request"
    health_running_key = "running"
    thread_name = "stream-engine"

    def __init__(
        self,
        *,
        prefix: str,
        phase: str,
        items_name: str,
        calls_name: str,
        queue: CoalescingQueue,
        modes: Sequence[str],
        dims: Sequence[int] = (),
        cost_model=None,
        force_mode: Optional[str] = None,
        obs: Optional[Observability] = None,
        audit: bool = True,
        health_name: Optional[str] = None,
    ):
        self.prefix = prefix
        self.phase = phase
        self.cost_model = cost_model
        self.modes = tuple(modes)
        self.force_mode = force_mode
        if force_mode is not None and force_mode not in self.modes:
            raise ValueError(f"force_mode {force_mode!r} not in enabled modes {self.modes}")
        self.dims = list(dims)
        # ---- observability: every stat lives in the shared registry
        # (the subclass stats() is a view over it); the audit checks the
        # cost model's predictions against measured wall time; the tracer
        # is a no-op unless the caller passed an enabled one
        self.obs = obs if obs is not None else Observability()
        self._metrics = EngineMetrics(
            self.obs.registry,
            prefix=prefix,
            phase=phase,
            items_name=items_name,
            calls_name=calls_name,
        )
        self._audit = (
            DispatchAudit(
                cost_model,
                self.dims,
                threshold=self.obs.audit_threshold,
                registry=self.obs.registry,
                prefix=f"{prefix}.dispatch_audit",
            )
            if audit and cost_model is not None
            else None
        )
        self._qat = QATTelemetry(self.obs.registry, prefix=f"{prefix}.qat")
        self._batcher = queue
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.obs.register_health(health_name or prefix, self.health)
        self.obs.ensure_server()

    # ------------------------------------------------------------------ #
    # dispatch + call accounting
    # ------------------------------------------------------------------ #

    def choose_mode(self, bucket: int) -> str:
        if self.force_mode is not None:
            return self.force_mode
        return self.cost_model.choose(bucket, self.dims, self.modes, phase=self.phase)

    def _finish_call(self, items: int, bucket: int, mode: str, device_s: float) -> bool:
        """Account one dispatched device call (audit + metrics); returns
        True when the `qat_probe_every` cadence says the subclass should
        run its QAT telemetry probe now."""
        if self._audit is not None:
            self._audit.record(self.phase, mode, bucket, device_s)
        self._metrics.record_call(items, bucket, mode, device_s)
        every = self.obs.qat_probe_every
        return bool(every) and self._metrics.calls % every == 0

    # ------------------------------------------------------------------ #
    # thread lifecycle
    # ------------------------------------------------------------------ #

    def _require_running(self) -> None:
        """Submit guard: raises once the engine is stopped (never leaves
        a future dangling in a queue nothing drains)."""
        if self._thread is None:
            raise RuntimeError(self.not_running_msg)
        self._metrics.mark_submit()

    def start(self):
        if self._thread is not None:
            raise RuntimeError(self.already_started_msg)
        self._stop.clear()
        self._batcher.reopen()
        self._thread = threading.Thread(
            target=self._serve_loop,
            name=self.thread_name,
            daemon=True,
        )
        self._thread.start()
        return self

    def _pending(self) -> int:
        """Work the serve loop still has to finish before a stop may join
        (continuous-batching engines add their in-flight lanes)."""
        return len(self._batcher)

    def stop(self) -> None:
        """Stop accepting requests, serve what's queued (and in flight),
        join the loop.

        Close-before-drain: sustained client traffic cannot livelock the
        shutdown, and any request that raced past the close is failed
        loudly, never left unresolved."""
        if self._thread is None:
            return
        self._batcher.close()               # no new submits from here on
        while self._pending():              # let queued/in-flight work finish
            time.sleep(0.005)
        self._stop.set()
        self._thread.join()
        self._thread = None
        for r in self._batcher.drain():     # safety net; normally empty
            r.future.set_exception(RuntimeError(self.stopped_msg))

    def close(self) -> None:
        """Shut the engine down for good: stop the serve loop and flush
        the tracer (to its configured path, if any) so a run that died
        mid-serve still leaves its trace on disk.  The observability
        bundle itself (HTTP server) stays up — it may be shared with
        other engines; `Observability.close()` owns that."""
        self.stop()
        self.obs.flush()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    def health(self) -> dict:
        """`/healthz` source: ok while the dispatch calibration holds
        (always ok for engines without a cost model).  Includes enough
        context (drift factor, serving state, lifetime calls) for an
        operator to act on a 503 without shelling in."""
        out = {
            "ok": True,
            self.health_running_key: self._thread is not None,
        }
        if self._audit is not None:
            drift = self._audit.drift()
            out["ok"] = not drift["stale"]
            out["drift_factor"] = drift["drift_factor"]
            out["drift_threshold"] = drift["threshold"]
        out[self._metrics.calls_name] = self._metrics.calls
        return out

    # ------------------------------------------------------------------ #
    # serve loop
    # ------------------------------------------------------------------ #

    def _serve_loop(self) -> None:
        while not self._stop.is_set():
            self._tick(0.02)

    def _tick(self, timeout: float) -> None:
        """One scheduling step: the default coalesces a micro-batch and
        runs `_process`; continuous-batching engines override this with
        their admit/decode/evict cycle."""
        tracer = self.obs.tracer
        t_poll = time.perf_counter() if tracer.enabled else 0.0
        reqs = self._batcher.next_batch(timeout=timeout)
        if not reqs:
            return
        if tracer.enabled:
            # only record the coalesce window when a batch actually
            # drained — idle polls would otherwise spam the trace
            tracer.complete(
                f"{self.prefix}.coalesce",
                t_poll,
                time.perf_counter(),
                cat="batcher",
                requests=len(reqs),
            )
        try:
            results = self._process(reqs)
        except BaseException as err:  # noqa: BLE001 — relay to callers
            for r in reqs:
                r.future.set_exception(err)
            return
        self._reply(reqs, results)

    def _process(self, reqs: list) -> list:
        """Serve one drained micro-batch; returns per-request results in
        request order.  Micro-batching subclasses implement this."""
        raise NotImplementedError

    def _reply(self, reqs: list, results: list) -> None:
        """Resolve futures + record reply metrics/spans for served
        requests (also used by continuous-batching ticks on eviction)."""
        tracer = self.obs.tracer
        with tracer.span(f"{self.prefix}.reply", requests=len(reqs)):
            t_done = time.perf_counter()
            for r, res in zip(reqs, results):
                r.future.set_result(res)
        if tracer.enabled:
            for r in reqs:
                tracer.complete(f"{self.prefix}.request", r.t_submit, t_done, cat="request")
        self._metrics.record_replies(len(reqs), (t_done - r.t_submit for r in reqs), t_done)

    # ------------------------------------------------------------------ #
    # metrics
    # ------------------------------------------------------------------ #

    def reset_stats(self) -> None:
        self._metrics.reset()
        if self._audit is not None:
            self._audit.reset()
        self._qat.reset()


__all__ = ["StreamEngine"]
