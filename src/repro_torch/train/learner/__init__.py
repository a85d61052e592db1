"""Batched fixed-point learner engine — `serve/policy`'s training-side twin
(port of `repro.train.learner`).

FIXAR's headline number is *training* throughput: 25293.3 IPS on its FPGA,
delivered by intra-batch parallelism on the adaptive array (Fig. 8).
`serve/policy` serves the acting path; this package does the same for the
update path:

    producers ──submit(replay batch / trajectory chunk)──▶ UpdateBatcher
                                  │  coalesce FIFO requests to ≤ max rows,
                                  │  pad to a bucket (+ zero-weight mask)
                                  ▼
                     train-phase adaptive dispatcher
                     (serve/policy/dispatch.CostModel, phase="train")
                                  │  fused_step / fused / jnp
                                  ▼
                     ONE ddpg.update per micro-batch
                     (sequential: the learner owns the DDPGState)
                                  │
                 futures resolve ◀── per-request metrics

On the card the three modes are the hand-written kernels and plain
PyTorch: "fused_step" runs the whole update in kernels 4 + 5
(`csrc/fxp_ddpg_step.cu`), "fused" runs every forward in kernel B with its
residuals and every backward in kernel 3 (`csrc/fxp_mlp_fwd.cu`,
`csrc/fxp_mlp_bwd.cu`), "jnp" is plain PyTorch autodiff (the name is the
reference's dispatch mode).  On CPU tensors the kernels' plain versions
run.

Design decisions, as the reference's:

  * **One state, sequential updates.**  Training mutates a single
    `DDPGState`.  The engine owns it; micro-batches apply in FIFO order on
    one drain thread (or under a lock for synchronous `run_update`), so a
    streamed run is a deterministic sequence of `ddpg.update` calls.
  * **Coalescing, not splitting.**  The throughput win is combining many
    small update requests (per-actor replay batches, trajectory chunks)
    into one bucket-padded batch for ONE fused update — intra-batch
    parallelism, the paper's training dataflow.  Oversized requests are
    chunked to the top bucket at submit time.
  * **Bit-exact streaming.**  A request whose row count hits a bucket
    exactly runs the same `ddpg.update` on the same tensors a direct call
    would: results are bitwise equal (`tests/test_torch_learner.py`).
    Padded batches carry a zero-weight `mask` row (`ddpg.update`'s
    weighted-loss contract), so pad rows contribute exactly zero gradient.
  * **Phase-plumbed dispatch.**  Mode choice goes through
    `CostModel.choose(..., phase="train")` over `TRAIN_MODES`.  Its
    default costs are still the reference's hand-set values; nothing here
    calibrates them for the card.
  * **Generic update family.**  The engine drives any
    `update_fn(state, batch) -> (state, metrics)` keyed by mode;
    `LearnerEngine.from_ddpg` builds the DDPG family.

Left out of the port: `benchmarks/learner_bench.py` (the reference's
`BENCH_learner.json` writer) and `train/step.learner_update_fns` (the LM
train step's adapter, part of the LM zoo).

Public API:
  LearnerEngine   — queue + micro-batch + train-phase dispatch + metrics
  UpdateBatcher   — multi-row request queue (the shared runtime queue)
  TRAIN_BACKENDS  — dispatch mode -> trainable ddpg backend
"""

from repro_torch.train.learner.batcher import UpdateBatcher, UpdateRequest
from repro_torch.train.learner.engine import TRAIN_BACKENDS, LearnerEngine

__all__ = ["LearnerEngine", "UpdateBatcher", "UpdateRequest", "TRAIN_BACKENDS"]
