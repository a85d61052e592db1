"""Request queue + coalescing batcher shared by every streaming engine.

A copy of `repro.runtime.engine.queue` for the port (stdlib + numpy only).

Concurrent callers submit requests; an engine's drain loop pulls them out
either as one micro-batch per device call (`next_batch`, deadline-or-full)
or immediately as admission candidates (`pop`, continuous batching).
Three knobs bound the micro-batching tradeoff (throughput vs tail
latency):

  * `buckets` — padded batch sizes.  Every drained batch is padded up to
    the smallest bucket that holds it, so an engine compiles one
    executable per (bucket, mode) instead of one per request count.
  * `max_batch` — hard cap per device call (the largest bucket).
  * `max_wait_ms` — flush deadline: once the oldest queued request has
    waited this long, the batch goes out however full it is.  A full
    `max_batch` flushes immediately.

The batching unit is abstract: `_rows(req)` says how many device-batch
rows one queued request occupies (1 by default; `train/learner` queues
whole replay batches per request).  Subclasses add their own typed
`submit` and enqueue via `_enqueue`.

Thread-safety: submission may happen from any number of client threads;
`next_batch`/`pop` are intended for a single drain thread (the engine's
serve loop), though nothing breaks with several.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Optional

import numpy as np


class RequestFuture:
    """Minimal future for one in-flight engine request (stdlib-only)."""

    def __init__(self):
        self._event = threading.Event()
        self._value = None
        self._error: Optional[BaseException] = None

    def set_result(self, value) -> None:
        self._value = value
        self._event.set()

    def set_exception(self, err: BaseException) -> None:
        self._error = err
        self._event.set()

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None):
        if not self._event.wait(timeout):
            raise TimeoutError("engine request timed out")
        if self._error is not None:
            raise self._error
        return self._value


@dataclasses.dataclass
class PendingRequest:
    """The canonical single-row request (one observation per row)."""

    obs: np.ndarray            # (obs_dim,)
    future: RequestFuture
    t_submit: float            # perf_counter at enqueue


@dataclasses.dataclass(frozen=True)
class BatcherConfig:
    buckets: tuple[int, ...] = (1, 8, 32, 128, 512)
    max_wait_ms: float = 2.0

    def __post_init__(self):
        object.__setattr__(self, "buckets", tuple(self.buckets))
        # strictly increasing: duplicates like (8, 8, 32) pass a plain
        # sorted() check but would compile a redundant executable per
        # (bucket, mode) — reject them too
        if (
            not self.buckets
            or self.buckets[0] < 1
            or any(a >= b for a, b in zip(self.buckets, self.buckets[1:]))
        ):
            raise ValueError(
                "buckets must be a non-empty strictly "
                f"increasing tuple of sizes >= 1: {self.buckets}"
            )

    @property
    def max_batch(self) -> int:
        return self.buckets[-1]

    def bucket_for(self, n: int) -> int:
        """Smallest padding bucket holding n requests (n <= max_batch)."""
        for b in self.buckets:
            if n <= b:
                return b
        raise ValueError(f"batch of {n} exceeds max bucket {self.max_batch}")


class CoalescingQueue:
    """FIFO request queue with deadline-or-full draining (see module
    docstring).  Subclasses define the request payload via their own
    `submit` (calling `_enqueue`) and row accounting via `_rows`."""

    def __init__(
        self,
        config: BatcherConfig = BatcherConfig(),
        *,
        registry=None,
        prefix: str = "batcher",
    ):
        self.config = config
        self._queue: deque = deque()
        self._queued_rows = 0
        self._lock = threading.Lock()
        self._nonempty = threading.Condition(self._lock)
        self._closed = False
        # optional queue telemetry (an obs.metrics.MetricsRegistry): submit
        # counter, queue-depth gauge, and the per-request queue-wait
        # histogram.  None (the default) keeps the queue metrics-free.
        if registry is not None:
            self._m_submitted = registry.counter(f"{prefix}.submitted")
            self._m_depth = registry.gauge(f"{prefix}.queue_depth")
            self._m_wait = registry.histogram(f"{prefix}.queue_wait_s")
        else:
            self._m_submitted = self._m_depth = self._m_wait = None

    def __len__(self) -> int:
        with self._lock:
            return len(self._queue)

    @staticmethod
    def _rows(req) -> int:
        """Device-batch rows one queued request occupies (1 here)."""
        return 1

    def _enqueue(self, req) -> RequestFuture:
        with self._nonempty:
            if self._closed:
                raise RuntimeError("batcher closed; engine stopped")
            self._queue.append(req)
            self._queued_rows += self._rows(req)
            depth = len(self._queue)
            self._nonempty.notify()
        if self._m_submitted is not None:
            self._m_submitted.inc()
            self._m_depth.set(depth)
        return req.future

    def close(self) -> None:
        """Reject all future submits (engine shutdown step 1).  Already-
        queued requests stay put for the serve loop to finish; the closed
        check shares the submit lock, so no request can slip past it."""
        with self._lock:
            self._closed = True

    def drain(self) -> list:
        """Empty the queue (engine shutdown step 2, after the loop exits:
        the caller must resolve every returned future, e.g. with an
        exception)."""
        with self._lock:
            out = list(self._queue)
            self._queue.clear()
            self._queued_rows = 0
            return out

    def reopen(self) -> None:
        with self._lock:
            self._closed = False

    def _record_drained(self, out: list) -> None:
        if self._m_wait is not None:
            now = time.perf_counter()
            for r in out:
                self._m_wait.observe(now - r.t_submit)
            self._m_depth.set(len(self._queue))

    def next_batch(self, timeout: Optional[float] = None) -> list:
        """Block until a batch is ready, then drain up to `max_batch` rows.

        Ready means: the queue holds `max_batch` rows, OR the oldest
        request has aged past `max_wait_ms`.  Requests drain whole and in
        FIFO order — a multi-row request that would overflow the cap stays
        queued for the next drain (the head request always goes, so
        progress is guaranteed).  Returns [] if `timeout` elapses with an
        empty queue (lets the engine's serve loop poll its stop flag).
        """
        deadline = None if timeout is None else time.perf_counter() + timeout
        max_wait = self.config.max_wait_ms * 1e-3
        with self._nonempty:
            while True:
                if self._queue:
                    age = time.perf_counter() - self._queue[0].t_submit
                    if self._queued_rows >= self.config.max_batch or age >= max_wait:
                        out = [self._queue.popleft()]
                        rows = self._rows(out[0])
                        while (
                            self._queue
                            and rows + self._rows(self._queue[0]) <= self.config.max_batch
                        ):
                            req = self._queue.popleft()
                            out.append(req)
                            rows += self._rows(req)
                        self._queued_rows -= rows
                        self._record_drained(out)
                        return out
                    # wake when the oldest request hits the flush deadline
                    wait = max_wait - age
                else:
                    wait = None
                if deadline is not None:
                    remaining = deadline - time.perf_counter()
                    if remaining <= 0:
                        return []
                    wait = remaining if wait is None else min(wait, remaining)
                self._nonempty.wait(wait)

    def pop(self, max_requests: int, timeout: Optional[float] = None) -> list:
        """Drain up to `max_requests` whole requests IMMEDIATELY, ignoring
        the coalescing deadline — the admission path for continuous
        batching, where a free decode lane should never idle waiting for
        the flush window.  Blocks up to `timeout` only while the queue is
        empty (None = return [] at once)."""
        if max_requests < 1:
            return []
        deadline = None if timeout is None else time.perf_counter() + timeout
        with self._nonempty:
            while not self._queue:
                if deadline is None:
                    return []
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    return []
                self._nonempty.wait(remaining)
            out = []
            while self._queue and len(out) < max_requests:
                req = self._queue.popleft()
                self._queued_rows -= self._rows(req)
                out.append(req)
            self._record_drained(out)
            return out


__all__ = ["RequestFuture", "PendingRequest", "BatcherConfig", "CoalescingQueue"]
