"""Batched fixed-point policy-serving engine (port of
`repro.serve.policy.engine`).

Request lifecycle::

    client threads ──submit(obs)──▶ MicroBatcher (queue, flush deadline)
                                        │ drain: ≤ max_batch, pad → bucket
                                        ▼
                                  adaptive dispatcher (dispatch.CostModel)
                                        │ fused / layer / jnp per batch
                                        ▼
                                  ONE device call (ddpg.act_batch)
                                        │ stream synchronize
                                        ▼
                    futures resolve ◀── scatter rows back to requests

The queue, serve thread, dispatch hook and observability wiring are the
shared `repro_torch.runtime.engine.StreamEngine`; this module keeps the
policy-specific parts: the actor device call, bucket padding, and the QAT
saturation probe.

The engine is frozen-QAT by construction: it holds only the actor params and
a `core.qat.FrozenQuant` snapshot, so no range-monitor write can happen.
Trace span names (`serve.dispatch`, `serve.launch`,
`serve.block_until_ready`) and `stats()` keys are the reference's.

Differences from the reference: `device=` picks the card (default) or the
CPU; `jax.block_until_ready` becomes a stream synchronize.  `mesh=` (a
`core.parallelism.Mesh` with a `data` axis, `launch.mesh.make_serve_mesh`)
splits a padded bucket whose rows divide by the mesh's size into one chunk
per slice of the data axis, runs each chunk against a replica of the actor
on the slice's first device, and concatenates the results in order — the
reference's batch sharding over "data" with the weights and every other
axis replicated, spelled out (a replica axis's other devices would compute
the same rows, so they are not asked to).  On one card the split is one
chunk: the same code, a no-op.
"""

from __future__ import annotations

import time
from typing import Any, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.parallelism import Mesh
from repro_torch.core.qat import FrozenQuant
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.obs import Observability
from repro_torch.rl import ddpg
from repro_torch.runtime.engine import StreamEngine
from repro_torch.serve.policy.batcher import BatcherConfig, MicroBatcher, PolicyFuture
from repro_torch.serve.policy.dispatch import MODES, CostModel

Params = dict[str, Any]


class PolicyEngine(StreamEngine):
    """Drains concurrent act requests into batched device calls.

    Synchronous use: `run_batch(obs)` — one padded, dispatched device call.
    Threaded use: `start()`, then `submit(obs).result()` from any number of
    client threads; `stop()` to drain and join.
    """

    not_running_msg = "engine not serving; call start() first (or use run_batch for synchronous batches)"
    already_started_msg = "engine already started"
    stopped_msg = "policy engine stopped before serving this request"
    health_running_key = "serving"
    thread_name = "policy-serve"

    def __init__(
        self,
        actor: Params,
        frozen: Optional[FrozenQuant] = None,
        *,
        device: DeviceLike = None,
        cost_model: Optional[CostModel] = None,
        batcher: BatcherConfig = BatcherConfig(),
        modes: Sequence[str] = MODES,
        force_mode: Optional[str] = None,
        mesh: Optional[Mesh] = None,
        obs: Optional[Observability] = None,
    ):
        self.device = resolve_device(device)
        self.actor = _actor_on(actor, self.device)
        self.frozen = frozen.to(self.device) if frozen is not None else None
        self.mesh = mesh
        self._replicas = None
        if mesh is not None:
            if mesh.devices is None:
                raise ValueError(f"{mesh!r} is a layout only: serving needs a mesh of devices")
            if "data" not in mesh.shape:
                raise ValueError(f"{mesh!r} has no 'data' axis to split the batch over")
            # one actor replica per slice of the data axis (the engine's own
            # on its device), on the slice's first device: every other axis
            # replicates, and its devices would compute the same rows
            self._replicas = [
                (dev, self.actor, self.frozen) if _same_device(dev, self.device)
                else (dev, _actor_on(self.actor, dev), self.frozen.to(dev) if self.frozen is not None else None)
                for dev in _data_slice_devices(mesh)
            ]
        self.batcher_config = batcher
        n = len(ddpg.ACTOR_ACTS)
        dims = [int(self.actor["l0"]["w"].shape[0])]
        dims += [int(self.actor[f"l{i}"]["w"].shape[1]) for i in range(n)]
        for mode in modes:
            if mode not in MODES:
                raise ValueError(f"unknown serve mode {mode!r}; expected one of {MODES}")
        self._qat_ranges_recorded = False
        obs = obs if obs is not None else Observability()
        super().__init__(
            prefix="serve",
            phase="act",
            items_name="actions",
            calls_name="batches",
            queue=MicroBatcher(batcher, registry=obs.registry, prefix="serve.batcher"),
            modes=modes,
            dims=dims,
            cost_model=cost_model or CostModel.default(),
            force_mode=force_mode,
            obs=obs,
        )

    @classmethod
    def from_ddpg(cls, state: "ddpg.DDPGState", **kwargs) -> "PolicyEngine":
        """Snapshot a trained DDPG state into a serving engine (freezes the
        actor's site quant params; QAT-off states serve unquantized)."""
        return cls(state.actor, ddpg.freeze_actor_quant(state), **kwargs)

    # ------------------------------------------------------------------ #
    # dispatch + device call
    # ------------------------------------------------------------------ #

    def warmup(self, buckets: Optional[Sequence[int]] = None, modes: Optional[Sequence[str]] = None) -> int:
        """Build the kernels and run every (bucket, mode) once ahead of
        traffic.  Returns the number of (bucket, mode) pairs warmed."""
        n = 0
        for bucket in buckets or self.batcher_config.buckets:
            for mode in modes or ([self.force_mode] if self.force_mode else self.modes):
                self._call(np.zeros((bucket, self.dims[0]), np.float32), mode)
                n += 1
        self._synchronize()
        return n

    def _call(self, x_padded: np.ndarray, mode: str) -> torch.Tensor:
        if mode not in self.modes:
            raise ValueError(f"mode {mode!r} not in enabled modes {self.modes}")
        if self._replicas is not None and x_padded.shape[0] % self.mesh.size == 0:
            # batch split along the mesh's data axis, weights replicated (the
            # reference's condition: the rows divide by the mesh's size)
            chunks = np.split(x_padded, len(self._replicas))
            ys = [ddpg.act_batch(actor, torch.from_numpy(c).to(dev), frozen, mode=mode)
                  for (dev, actor, frozen), c in zip(self._replicas, chunks)]
            return torch.cat([y.to(self.device) for y in ys])
        x = torch.from_numpy(x_padded).to(self.device)
        return ddpg.act_batch(self.actor, x, self.frozen, mode=mode)

    def _synchronize(self) -> None:
        devices = [self.device] + [dev for dev, _, _ in self._replicas or ()]
        for dev in devices:
            if dev.type == "cuda":
                torch.cuda.current_stream(dev).synchronize()

    def run_batch(self, obs) -> np.ndarray:
        """One engine pass over (n, obs_dim) observations: pad to a bucket,
        dispatch adaptively, call the device once, unpad.  Batches larger
        than the top bucket are chunked."""
        obs = np.asarray(obs, np.float32)
        n = obs.shape[0]
        cap = self.batcher_config.max_batch
        if n > cap:
            return np.concatenate([self.run_batch(obs[i : i + cap]) for i in range(0, n, cap)])
        tracer = self.obs.tracer
        bucket = self.batcher_config.bucket_for(n)
        with tracer.span("serve.dispatch", bucket=bucket, rows=n) as sp:
            mode = self.choose_mode(bucket)
            sp.set(mode=mode)
        x = np.zeros((bucket, self.dims[0]), np.float32)
        x[:n] = obs
        t0 = time.perf_counter()
        with tracer.span("serve.launch", bucket=bucket, mode=mode):
            y = self._call(x, mode)
        with tracer.span("serve.block_until_ready", bucket=bucket, mode=mode):
            self._synchronize()
        if self._finish_call(n, bucket, mode, time.perf_counter() - t0):
            self.record_qat_telemetry(x, rows=n)
        return y[:n].cpu().numpy()

    # ------------------------------------------------------------------ #
    # threaded serving
    # ------------------------------------------------------------------ #

    def submit(self, obs) -> PolicyFuture:
        """Enqueue one observation (obs_dim,); resolve via .result().
        Raises RuntimeError once the engine is stopped."""
        self._require_running()
        return self._batcher.submit(obs)

    def _process(self, reqs: list) -> list:
        return list(self.run_batch(np.stack([r.obs for r in reqs])))

    # ------------------------------------------------------------------ #
    # telemetry
    # ------------------------------------------------------------------ #

    def record_qat_telemetry(self, obs, rows: Optional[int] = None) -> dict:
        """Probe per-site activation ranges + saturation on one (possibly
        padded) observation batch and fold them into the registry.  `rows`
        masks out padding rows.  Returns the per-site `qat_telemetry` view."""
        if not self._qat_ranges_recorded and self.frozen is not None and self.frozen.quantized:
            for i in range(len(self.frozen.a_mins)):
                self._qat.record_range(f"act{i}", float(self.frozen.a_mins[i]), float(self.frozen.a_maxs[i]))
            self._qat_ranges_recorded = True
        x = torch.from_numpy(np.ascontiguousarray(obs, np.float32)).to(self.device)
        mask = None
        if rows is not None and rows < x.shape[0]:
            mask = torch.zeros((x.shape[0],), dtype=torch.float32, device=self.device)
            mask[:rows] = 1.0
        mns, mxs, sats = (t.cpu().numpy() for t in ddpg.actor_site_telemetry(self.actor, x, self.frozen, mask))
        for i in range(mns.shape[0]):
            self._qat.record_probe(f"act{i}", float(mns[i]), float(mxs[i]), float(sats[i]))
        return self._qat.stats()

    # ------------------------------------------------------------------ #
    # metrics
    # ------------------------------------------------------------------ #

    def stats(self) -> dict:
        """Serving metrics so far, read off the shared registry (the same
        keys as the reference engine's)."""
        m = self._metrics
        device_s = m.device_s
        wall = m.wall_s()
        return {
            "requests": m.requests,
            "actions": m.items,
            "batches": m.calls,
            "ips_device": m.items / device_s if device_s > 0 else None,
            "ips_wall": (m.requests / wall if wall else None),
            "p50_ms": m.latency_ms(0.50),
            "p99_ms": m.latency_ms(0.99),
            "batch_occupancy": m.occupancy(),
            "mode_histogram": m.mode_histogram(),
            "cost_model": self.cost_model.source,
            "dispatch_audit": self._audit.snapshot(),
            "qat_telemetry": self._qat.stats(),
        }


def _actor_on(actor: Params, dev: torch.device) -> Params:
    return {name: {k: v.to(dev, torch.float32).contiguous() for k, v in layer.items()}
            for name, layer in actor.items()}


def _data_slice_devices(mesh) -> list:
    """The first device of each slice of `mesh`'s data axis, in order (the
    mesh's devices are row-major over its axes)."""
    grid = np.arange(mesh.size).reshape(mesh.axis_sizes)
    at = lambda i: tuple(i if name == "data" else 0 for name in mesh.axis_names)  # noqa: E731
    return [mesh.devices[int(grid[at(i)])] for i in range(mesh.shape["data"])]


def _same_device(a: torch.device, b: torch.device) -> bool:
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return True
    current = torch.cuda.current_device()
    return (a.index if a.index is not None else current) == (b.index if b.index is not None else current)


__all__ = ["PolicyEngine"]
