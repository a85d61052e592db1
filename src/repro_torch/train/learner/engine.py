"""Batched learner engine (port of `repro.train.learner.engine`; the
tentpole of train/learner — see __init__).

`LearnerEngine` owns one training state and streams update requests
through it: coalesce → pad to bucket → train-phase adaptive dispatch →
ONE `update_fn` call per micro-batch, applied sequentially.

The queue, serve thread, dispatch hook, and observability wiring are the
shared `repro_torch.runtime.engine.StreamEngine`; this module keeps only
the learner-specific parts: sequential state mutation under `_ulock`, the
mask/exact pad policy, oversized-request chunking, and the live-QAT
telemetry probe.

Device: the engine computes on the device of the state it holds (its
tensors must agree, `device.check_same_device`; a `cuda` state without a
card raises, `device.resolve_device`).  Requests are host numpy arrays;
`_apply` copies the padded batch to that device inside the timed window
(the reference's "PCIe import") and synchronizes the device before it
reads `device_s`.  A state on the CPU stays there: nothing moves between
devices on its own.  A generic update family whose state holds no tensor
gets the host batch as it is.

Observability runs through `repro_torch.obs` (pass an `Observability`
bundle): the shared registry carries updates/sec, trained samples/sec
(train IPS), p50/p99 request latency, batch occupancy, the phase-keyed
dispatch histogram, the dispatch audit and the per-site QAT telemetry.  An
enabled tracer gets per-update spans under the reference's names
(`learner.dispatch` → `learner.launch` → `learner.block_until_ready`,
the last now a device synchronize).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from functools import partial
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch import tree as tree_util
from repro_torch.device import check_same_device, resolve_device
from repro_torch.obs import Observability
from repro_torch.rl import ddpg
from repro_torch.runtime.engine import BatcherConfig, StreamEngine
from repro_torch.serve.policy.dispatch import TRAIN_MODES, CostModel
from repro_torch.train.learner.batcher import (
    TRANSITION_KEYS,
    JoinedFuture,
    UpdateBatcher,
    as_transition_batch,
    concat_batches,
    merge_chunk_metrics,
)

# dispatch mode -> the ddpg backend that can actually train through it
# (the per-layer chain has no backward, hence no "layer" entry);
# fused_step is the whole update in kernels 4 + 5
TRAIN_BACKENDS = {"fused_step": "pallas_fused_step", "fused": "pallas", "jnp": "jnp"}

# learner-shaped default buckets: update batches are replay-sized (tens to
# hundreds of rows), never single observations
DEFAULT_BUCKETS = (8, 32, 128)

UpdateFn = Callable[[Any, dict], tuple[Any, dict]]


def _state_device(state) -> Optional[torch.device]:
    """The device of `state`'s tensors (None when it holds none)."""
    tensors = [leaf for leaf in tree_util.leaves(state) if isinstance(leaf, torch.Tensor)]
    return resolve_device(check_same_device(*tensors)) if tensors else None


class LearnerEngine(StreamEngine):
    """Streams batched updates through an adaptive train-phase dispatcher.

    Synchronous use: `run_update(batch)` — one (or, for oversized batches,
    a chunked sequence of) padded, dispatched, sequentially applied
    update(s).  Threaded use: `start()`, then `submit(batch).result()`
    from any number of producer threads; `stop()` to drain and join.

    The engine is generic over the update family: `update_fns` maps each
    dispatch mode to an `update_fn(state, batch) -> (new_state, metrics)`.
    `from_ddpg` builds the DDPG family (kernels 4 + 5, kernels B + 3, plain
    PyTorch autodiff).

    `pad_policy`:
      * "mask"  — pad short batches to the bucket with zero rows plus a
        zero-weight `batch["mask"]` (the `ddpg.update` weighted-loss
        contract: pad rows contribute exactly zero gradient);
      * "exact" — reject row counts that miss every bucket (for update
        families without a mask contract).
    """

    not_running_msg = "learner not streaming; call start() first (or use run_update for synchronous updates)"
    already_started_msg = "learner already started"
    stopped_msg = "learner stopped before applying this update"
    health_running_key = "training"
    thread_name = "learner"

    def __init__(
        self,
        state,
        update_fns: dict[str, UpdateFn],
        *,
        dims: Sequence[int],
        cost_model: Optional[CostModel] = None,
        batcher: Optional[BatcherConfig] = None,
        force_mode: Optional[str] = None,
        pad_policy: str = "mask",
        required_keys: Optional[Sequence[str]] = None,
        warmup_template: Optional[Callable[[int], dict]] = None,
        obs: Optional[Observability] = None,
    ):
        self._state = state
        self.device = _state_device(state)
        self._update_fns = dict(update_fns)
        self.batcher_config = batcher or BatcherConfig(buckets=DEFAULT_BUCKETS)
        if pad_policy not in ("mask", "exact"):
            raise ValueError(f"pad_policy {pad_policy!r}; 'mask' | 'exact'")
        self.pad_policy = pad_policy
        self.required_keys = required_keys
        self.warmup_template = warmup_template
        # one lock serializes state mutation (sync callers + drain thread):
        # updates are sequential by construction
        self._ulock = threading.Lock()
        obs = obs if obs is not None else Observability()
        super().__init__(
            prefix="learner",
            phase="train",
            items_name="transitions",
            calls_name="updates",
            queue=UpdateBatcher(
                self.batcher_config,
                required_keys=required_keys,
                registry=obs.registry,
                prefix="learner.batcher",
            ),
            modes=tuple(self._update_fns),
            dims=dims,
            cost_model=cost_model or CostModel.default(),
            force_mode=force_mode,
            obs=obs,
        )

    @classmethod
    def from_ddpg(
        cls,
        state: "ddpg.DDPGState",
        cfg: "ddpg.DDPGConfig",
        *,
        modes: Sequence[str] = TRAIN_MODES,
        **kwargs,
    ) -> "LearnerEngine":
        """The DDPG learner: one `ddpg.update` per trainable dispatch mode,
        its backend `TRAIN_BACKENDS[mode]`.  A bucket-sized stream and a
        direct call run the same function on the same tensors, so their
        results are bitwise equal."""
        unknown = [m for m in modes if m not in TRAIN_BACKENDS]
        if unknown:
            raise ValueError(f"modes {unknown} cannot train; trainable dispatch modes: {sorted(TRAIN_BACKENDS)}")
        fns = {m: partial(ddpg.update, cfg=dataclasses.replace(cfg, backend=TRAIN_BACKENDS[m])) for m in modes}
        n = len(ddpg.ACTOR_ACTS)
        dims = [int(state.actor["l0"]["w"].shape[0])] + [int(state.actor[f"l{i}"]["w"].shape[1]) for i in range(n)]

        def transitions(rows: int) -> dict:
            return {
                "obs": np.zeros((rows, dims[0]), np.float32),
                "action": np.zeros((rows, dims[-1]), np.float32),
                "reward": np.zeros((rows,), np.float32),
                "next_obs": np.zeros((rows, dims[0]), np.float32),
                "done": np.zeros((rows,), bool),
            }

        kwargs.setdefault("required_keys", TRANSITION_KEYS)
        kwargs.setdefault("warmup_template", transitions)
        return cls(state, fns, dims=dims, **kwargs)

    # ------------------------------------------------------------------ #
    # state
    # ------------------------------------------------------------------ #

    @property
    def state(self):
        return self._state

    def load_state(self, state) -> None:
        """Install a (fresh or checkpointed) training state; subsequent
        updates stream onto it, on its device."""
        device = _state_device(state)
        with self._ulock:
            self._state = state
            self.device = device

    # ------------------------------------------------------------------ #
    # dispatch + device call
    # ------------------------------------------------------------------ #

    def _pad(self, batch: dict[str, np.ndarray], rows: int, bucket: int) -> dict[str, np.ndarray]:
        """Pad `rows` transitions up to `bucket` (zero rows + zero-weight
        mask).  Exact fits pass through untouched — no mask key, so the
        call is exactly the direct call."""
        if rows == bucket:
            return batch
        if self.pad_policy == "exact":
            raise ValueError(
                f"pad_policy='exact': batch of {rows} rows must hit a bucket exactly ({self.batcher_config.buckets})"
            )
        pad = bucket - rows
        out = {k: np.concatenate([v, np.zeros((pad,) + v.shape[1:], v.dtype)]) for k, v in batch.items()}
        out["mask"] = np.concatenate([np.ones(rows, np.float32), np.zeros(pad, np.float32)])
        return out

    def _to_device(self, batch: dict[str, np.ndarray]) -> dict:
        """The host batch on the state's device (float64 narrowed to
        float32, as the reference's arrays are); as it is without one."""
        if self.device is None:
            return batch
        return {k: torch.from_numpy(np.ascontiguousarray(v, np.float32 if v.dtype == np.float64 else v.dtype))
                .to(self.device) for k, v in batch.items()}

    def _synchronize(self) -> None:
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warmup(
        self,
        buckets: Optional[Sequence[int]] = None,
        modes: Optional[Sequence[str]] = None,
        padded: bool = False,
    ) -> int:
        """Run every (bucket, mode) update once ahead of traffic (building
        the kernels and setting their launch attributes) without advancing
        the training state: each result is discarded.  `padded=True` also
        warms the masked variants (bucket-1 rows).  Returns the number of
        calls warmed.

        Dummy batches come from the engine's `warmup_template` (a
        `rows -> batch` callable; `from_ddpg` installs the DDPG transition
        shape).  Generic engines must pass one at construction to warm up.
        """
        if self.warmup_template is None:
            raise RuntimeError(
                "no warmup_template: this engine's update family has no "
                "known batch shape — pass warmup_template=rows->batch at "
                "construction (from_ddpg installs the DDPG one)"
            )
        n = 0
        for bucket in buckets or self.batcher_config.buckets:
            rows_list = [bucket] + ([bucket - 1] if padded and bucket > 1 else [])
            for mode in modes or ([self.force_mode] if self.force_mode else self.modes):
                for rows in rows_list:
                    batch = self._pad(self.warmup_template(rows), rows, bucket)
                    with self._ulock:
                        self._update_fns[mode](self._state, self._to_device(batch))
                        self._synchronize()
                    n += 1
        return n

    def _apply(self, batch: dict[str, np.ndarray], rows: int) -> dict[str, float]:
        """One micro-batch through the dispatcher and onto the state."""
        tracer = self.obs.tracer
        bucket = self.batcher_config.bucket_for(rows)
        with tracer.span("learner.dispatch", bucket=bucket, rows=rows) as sp:
            mode = self.choose_mode(bucket)
            sp.set(mode=mode)
        padded = self._pad(batch, rows, bucket)
        with self._ulock:
            t0 = time.perf_counter()
            with tracer.span("learner.launch", bucket=bucket, mode=mode):
                new_state, metrics = self._update_fns[mode](self._state, self._to_device(padded))
            with tracer.span("learner.block_until_ready", bucket=bucket, mode=mode):
                self._synchronize()
            device_s = time.perf_counter() - t0
            self._state = new_state
        if self._finish_call(rows, bucket, mode, device_s):
            self.record_qat_telemetry(batch)
        out = {k: float(v) for k, v in metrics.items()}
        out["mode"] = mode
        return out

    def _chunks(self, arrs: dict[str, np.ndarray], rows: int):
        """Top-bucket-sized (chunk, rows) slices of an oversized request
        — key-agnostic (the update family defines the batch schema)."""
        cap = self.batcher_config.max_batch
        for lo in range(0, rows, cap):
            yield ({k: v[lo : lo + cap] for k, v in arrs.items()}, min(cap, rows - lo))

    def run_update(self, batch) -> dict[str, float]:
        """Synchronously stream one update request: chunk to the top
        bucket if oversized, pad, dispatch, apply sequentially.  Returns
        the update metrics (row-weighted means across chunks)."""
        arrs, rows = as_transition_batch(batch, self.required_keys)
        if rows <= self.batcher_config.max_batch:
            return self._apply(arrs, rows)
        return merge_chunk_metrics([(self._apply(part, n), n) for part, n in self._chunks(arrs, rows)])

    # ------------------------------------------------------------------ #
    # threaded streaming
    # ------------------------------------------------------------------ #

    def submit(self, batch):
        """Enqueue one update request (replay batch or trajectory chunk);
        resolve via `.result()` to the update metrics.  Oversized requests
        split into top-bucket chunks behind one aggregate future."""
        self._require_running()
        arrs, rows = as_transition_batch(batch, self.required_keys)
        if rows <= self.batcher_config.max_batch:
            return self._batcher.submit(arrs)
        return JoinedFuture([(self._batcher.submit(part), n) for part, n in self._chunks(arrs, rows)])

    def _process(self, reqs: list) -> list:
        rows = sum(r.rows for r in reqs)
        metrics = self._apply(concat_batches([r.batch for r in reqs]), rows)
        # coalesced requests share one update: metrics are joint
        return [dict(metrics, rows=r.rows) for r in reqs]

    # ------------------------------------------------------------------ #
    # telemetry
    # ------------------------------------------------------------------ #

    def record_qat_telemetry(self, batch: Optional[dict] = None) -> dict:
        """Snapshot the live `QATState`'s per-site ranges into the
        registry, and — when `batch` carries observations — probe per-site
        activation extrema + saturation against a frozen snapshot of the
        current quant params.  No-op (returns the current view) for
        non-DDPG states or QAT-off training.  Returns the per-site
        `qat_telemetry` stats view.
        """
        qat = getattr(self._state, "qat", None)
        if qat is None or not qat.config.enabled:
            return self._qat.stats()
        self._qat.record_state(qat)
        if batch is not None and "obs" in batch:
            frozen = ddpg.freeze_actor_quant(self._state)
            obs = torch.from_numpy(np.ascontiguousarray(batch["obs"], np.float32)).to(self.device)
            mns, mxs, sats = (t.cpu().numpy() for t in ddpg.actor_site_telemetry(self._state.actor, obs, frozen))
            for i in range(mns.shape[0]):
                self._qat.record_probe(f"act{i}", float(mns[i]), float(mxs[i]), float(sats[i]))
        return self._qat.stats()

    # ------------------------------------------------------------------ #
    # metrics
    # ------------------------------------------------------------------ #

    def stats(self) -> dict:
        """Training-throughput metrics so far, read off the shared
        registry (the reference's keys): exact lifetime totals,
        streaming-histogram latency quantiles, the phase-keyed dispatch
        histogram, and the two audit sections."""
        m = self._metrics
        device_s = m.device_s
        wall = m.wall_s()
        return {
            "requests": m.requests,
            "updates": m.calls,
            "transitions": m.items,
            "updates_per_s_device": (m.calls / device_s if device_s > 0 else None),
            "updates_per_s_wall": (m.calls / wall if wall else None),
            "train_ips_device": (m.items / device_s if device_s > 0 else None),
            "train_ips_wall": (m.items / wall if wall else None),
            "p50_ms": m.latency_ms(0.50),
            "p99_ms": m.latency_ms(0.99),
            "batch_occupancy": m.occupancy(),
            "mode_histogram": m.mode_histogram(),
            "cost_model": self.cost_model.source,
            "dispatch_audit": self._audit.snapshot(),
            "qat_telemetry": self._qat.stats(),
        }


__all__ = ["LearnerEngine", "TRAIN_BACKENDS", "DEFAULT_BUCKETS"]
