"""Policy-serving micro-batcher (port of `repro.serve.policy.batcher`).

`MicroBatcher` is the shared `CoalescingQueue` plus `submit(obs)` coercing a
single observation to a float32 row; `PolicyFuture` is the shared
`RequestFuture` under its serving name.
"""

from __future__ import annotations

import time

import numpy as np

from repro_torch.runtime.engine.queue import BatcherConfig, CoalescingQueue, PendingRequest, RequestFuture

PolicyFuture = RequestFuture


class MicroBatcher(CoalescingQueue):
    """Coalescing queue of single-observation act requests."""

    def submit(self, obs) -> PolicyFuture:
        """Queue one observation; the returned future resolves to the
        action row once the serve loop dispatches its micro-batch."""
        req = PendingRequest(obs=np.asarray(obs, np.float32), future=PolicyFuture(), t_submit=time.perf_counter())
        return self._enqueue(req)


__all__ = ["PolicyFuture", "PendingRequest", "BatcherConfig", "MicroBatcher"]
