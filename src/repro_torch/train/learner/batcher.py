"""Update-stream request queue for the learner engine (port of
`repro.train.learner.batcher`, stdlib + numpy only).

Builds on the shared `repro_torch.runtime.engine.queue` machinery (FIFO queue,
deadline-or-full draining, futures) with one twist: a queued request is a
whole *transition batch* — a replay sample or a trajectory chunk — not a
single observation, so drain accounting runs in rows (`_rows`), and one
drained micro-batch is the row-wise concatenation of several requests.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

import numpy as np

from repro_torch.runtime.engine.queue import BatcherConfig, CoalescingQueue, RequestFuture

# the transition rows every update request must carry; "mask" is reserved
# for the engine's bucket padding
TRANSITION_KEYS = ("obs", "action", "reward", "next_obs", "done")


@dataclasses.dataclass
class UpdateRequest:
    batch: dict[str, np.ndarray]  # TRANSITION_KEYS, leading dim = rows
    rows: int
    future: RequestFuture
    t_submit: float  # perf_counter at enqueue


def as_transition_batch(
    batch, required: Optional[Sequence[str]] = None
) -> tuple[dict[str, np.ndarray], int]:
    """Normalize one update request to host arrays and validate its shape:
    every row present (the `required` keys when given — DDPG streams pass
    TRANSITION_KEYS; generic update families any non-empty dict), all with
    one consistent leading dim."""
    if required:
        missing = [k for k in required if k not in batch]
        if missing:
            raise ValueError(f"update request missing {missing}; needs {tuple(required)}")
    if not batch:
        raise ValueError("empty update request")
    out = {k: np.asarray(v) for k, v in batch.items()}
    rows = {k: v.shape[0] if v.ndim else -1 for k, v in out.items()}
    if len(set(rows.values())) != 1 or -1 in rows.values():
        raise ValueError(f"inconsistent leading dims in update request: {rows}")
    return out, next(iter(rows.values()))


def concat_batches(batches: Sequence[dict[str, np.ndarray]]) -> dict[str, np.ndarray]:
    """Row-wise concatenation of several requests into one micro-batch."""
    if len(batches) == 1:
        return dict(batches[0])
    return {k: np.concatenate([b[k] for b in batches]) for k in batches[0]}


def merge_chunk_metrics(parts: Sequence[tuple[dict, int]]) -> dict:
    """Row-weighted mean of per-chunk update metrics — the ONE place the
    merge semantics live (both the synchronous chunk loop and JoinedFuture
    use it).  Non-numeric bookkeeping keys: per-chunk `rows` is dropped,
    `mode` collapses to the common mode or "mixed"."""
    merged: dict[str, float] = {}
    total, modes = 0, []
    for metrics, rows in parts:
        m = dict(metrics)
        total += rows
        m.pop("rows", None)
        mode = m.pop("mode", None)
        if mode is not None:
            modes.append(mode)
        for k, v in m.items():
            merged[k] = merged.get(k, 0.0) + float(v) * rows
    out = {k: v / total for k, v in merged.items()}
    if modes:
        out["mode"] = modes[-1] if len(set(modes)) == 1 else "mixed"
    out["chunks"] = len(parts)
    return out


class JoinedFuture:
    """Aggregate future over an oversized request's chunks: resolves when
    every chunk has, with row-weighted mean metrics (errors propagate from
    the first failed chunk)."""

    def __init__(self, parts: Sequence[tuple[RequestFuture, int]]):
        self._parts = list(parts)

    def done(self) -> bool:
        return all(f.done() for f, _ in self._parts)

    def result(self, timeout: Optional[float] = None) -> dict:
        return merge_chunk_metrics([(f.result(timeout), rows) for f, rows in self._parts])


class UpdateBatcher(CoalescingQueue):
    """FIFO queue of multi-row update requests (see module docstring).

    `max_batch` (the top bucket) bounds the *rows* per drained micro-batch;
    a single request may not exceed it (the engine chunks oversized
    trajectory submissions before they reach the queue).
    """

    def __init__(
        self,
        config: Optional[BatcherConfig] = None,
        *,
        required_keys: Optional[Sequence[str]] = None,
        registry=None,
        prefix: str = "batcher",
    ):
        super().__init__(config or BatcherConfig(), registry=registry, prefix=prefix)
        self.required_keys = required_keys

    @staticmethod
    def _rows(req: UpdateRequest) -> int:
        return req.rows

    def submit(self, batch) -> RequestFuture:
        arrs, rows = as_transition_batch(batch, self.required_keys)
        if rows > self.config.max_batch:
            raise ValueError(
                f"update request of {rows} rows exceeds the top bucket "
                f"{self.config.max_batch}; chunk it (LearnerEngine.submit "
                "does this automatically)"
            )
        req = UpdateRequest(
            batch=arrs, rows=rows, future=RequestFuture(), t_submit=time.perf_counter()
        )
        return self._enqueue(req)


__all__ = [
    "TRANSITION_KEYS",
    "UpdateRequest",
    "UpdateBatcher",
    "JoinedFuture",
    "BatcherConfig",
    "as_transition_batch",
    "concat_batches",
    "merge_chunk_metrics",
]
