"""Adaptive-parallelism batched policy serving (port of `repro.serve.policy`).

Public API:
  PolicyEngine      — queue + micro-batch + adaptive dispatch + metrics
  CostModel / MODES — the per-batch fused/layer/jnp dispatch cost model
  BatcherConfig     — padding buckets, flush deadline, batch cap
"""

from repro_torch.serve.policy.batcher import BatcherConfig, MicroBatcher, PolicyFuture
from repro_torch.serve.policy.dispatch import MODES, CostModel
from repro_torch.serve.policy.engine import PolicyEngine

__all__ = ["PolicyEngine", "CostModel", "MODES", "BatcherConfig", "MicroBatcher", "PolicyFuture"]
