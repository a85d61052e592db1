"""repro_torch.runtime.engine — the shared streaming-engine runtime (copy of
`repro.runtime.engine`).

  queue.py — `RequestFuture`, `PendingRequest`, `BatcherConfig`,
             `CoalescingQueue` (deadline-or-full `next_batch`, immediate
             `pop`)
  base.py  — `StreamEngine`: observability wiring, dispatch hook,
             start/stop/close lifecycle, and the serve loop
"""

from repro_torch.runtime.engine.base import StreamEngine
from repro_torch.runtime.engine.queue import BatcherConfig, CoalescingQueue, PendingRequest, RequestFuture

__all__ = ["BatcherConfig", "CoalescingQueue", "PendingRequest", "RequestFuture", "StreamEngine"]
