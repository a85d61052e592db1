"""Request-lifecycle span tracing — Chrome trace-event JSONL export.

A copy of `repro.obs.trace` for the port.

The second observability layer: zero-overhead-when-disabled spans over the
full engine request lifecycle (enqueue → bucket/coalesce → dispatch
decision → pallas/jnp launch → block_until_ready → reply), plus the RL
loop's per-step segments.  A run's trace opens directly in Perfetto
(ui.perfetto.dev) or chrome://tracing:

    tracer = Tracer()
    engine = PolicyEngine.from_ddpg(state, obs=Observability(tracer=tracer))
    ... serve traffic ...
    tracer.write("trace_serve.jsonl")

Every emitted event is a *complete* event (``"ph": "X"`` with ``ts`` +
``dur``), so a written trace cannot contain an unclosed span by
construction — tests/obs/test_trace.py pins well-formedness (one JSON
object per line, non-negative durations, events orderable by ``ts``).

Disabled tracing costs one attribute check and a shared no-op context
manager per span site — no event dicts, no timestamps, no lock traffic —
which is what lets the engines keep their spans inline on the hot path.
"""

from __future__ import annotations

import json
import os
import threading
import time


class _NullSpan:
    """Shared no-op span for disabled tracers."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **args) -> None:
        pass


_NULL_SPAN = _NullSpan()


class _Span:
    """Context manager recording one complete event on exit."""

    __slots__ = ("_tracer", "name", "cat", "args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, cat: str, args: dict):
        self._tracer = tracer
        self.name, self.cat, self.args = name, cat, args
        self._t0 = 0.0

    def __enter__(self) -> "_Span":
        self._t0 = self._tracer._clock()
        return self

    def __exit__(self, *exc) -> bool:
        self._tracer._record(self.name, self.cat, self._t0, self._tracer._clock(), self.args)
        return False

    def set(self, **args) -> None:
        """Attach args discovered mid-span (e.g. the dispatched mode)."""
        self.args.update(args)


class Tracer:
    """In-memory trace-event collector (thread-safe, bounded).

    `span(name)` returns a context manager; `complete(name, t0, t1)`
    records a span whose start predates the call (how engines emit one
    request-lifetime span at reply time from the queued `t_submit`).
    Timestamps are `time.perf_counter` seconds converted to microseconds
    relative to tracer construction — the Chrome trace `ts` clock.

    `max_events` caps memory (oldest-first drop is wrong for traces, so we
    drop *new* events once full and count them in `dropped`); the default
    holds hours of engine traffic.

    `path` (optional) makes the tracer self-flushing: `flush()` (and
    therefore `close()`, `__exit__`, and every engine's `close()`) writes
    the collected events there, so an aborted run still lands its trace on
    disk instead of losing it to the exception.  Use the tracer as a
    context manager around the traced workload::

        with Tracer(path="trace.jsonl") as tracer:
            ... traced work; may raise ...
        # trace.jsonl written either way
    """

    def __init__(
        self,
        enabled: bool = True,
        max_events: int = 1_000_000,
        clock=time.perf_counter,
        path=None,
    ):
        self.enabled = enabled
        self.max_events = max_events
        self.path = path
        self._clock = clock
        self._t0 = clock()
        self._pid = os.getpid()
        self._lock = threading.Lock()
        self._events: list[dict] = []
        self.dropped = 0

    def span(self, name: str, cat: str = "engine", **args):
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, cat, args)

    def complete(
        self, name: str, t_start: float, t_end: float, cat: str = "engine", **args
    ) -> None:
        """Record a span from explicit perf_counter endpoints."""
        if not self.enabled:
            return
        self._record(name, cat, t_start, t_end, args)

    def instant(self, name: str, cat: str = "engine", **args) -> None:
        if not self.enabled:
            return
        now = self._clock()
        ev = {
            "name": name,
            "cat": cat,
            "ph": "i",
            "s": "t",
            "ts": round((now - self._t0) * 1e6, 3),
            "pid": self._pid,
            "tid": threading.get_ident(),
        }
        if args:
            ev["args"] = args
        self._append(ev)

    def _record(self, name: str, cat: str, t0: float, t1: float, args: dict) -> None:
        ev = {
            "name": name,
            "cat": cat,
            "ph": "X",
            "ts": round((t0 - self._t0) * 1e6, 3),
            "dur": round(max(t1 - t0, 0.0) * 1e6, 3),
            "pid": self._pid,
            "tid": threading.get_ident(),
        }
        if args:
            ev["args"] = args
        self._append(ev)

    def _append(self, ev: dict) -> None:
        with self._lock:
            if len(self._events) >= self.max_events:
                self.dropped += 1
                return
            self._events.append(ev)

    def events(self) -> list[dict]:
        with self._lock:
            return list(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self.dropped = 0

    def write(self, path) -> str:
        """Write the trace as Chrome trace-event JSONL (one event per
        line, sorted by ts so consumers can stream it) and return the
        path."""
        events = sorted(self.events(), key=lambda e: e["ts"])
        with open(path, "w") as fh:
            for ev in events:
                fh.write(json.dumps(ev) + "\n")
        return str(path)

    def flush(self) -> "str | None":
        """Write to the construction-time `path` (None when no path was
        configured or the tracer is disabled).  Idempotent — safe to call
        from several shutdown paths (engine close, bundle close, finally
        blocks); each call rewrites the full trace."""
        if self.path is None or not self.enabled:
            return None
        return self.write(self.path)

    def close(self) -> None:
        """Flush (when a path is configured) and stop accepting events."""
        self.flush()
        self.enabled = False

    def __enter__(self) -> "Tracer":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False


# the one shared disabled tracer — engines default to it, so untraced
# serving never allocates per-span state
NULL_TRACER = Tracer(enabled=False)


def read_jsonl(path) -> list[dict]:
    """Parse a trace-event JSONL file back to events (test/tooling aid)."""
    out = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


__all__ = ["Tracer", "NULL_TRACER", "read_jsonl"]
