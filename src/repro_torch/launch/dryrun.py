"""Dry-run cells: build one (arch × shape × mesh) step and run it once
(port of `repro.launch.dryrun`).

The reference lowers and compiles every cell for the 256-device (data 16,
model 16) and 512-device (pod 2, data 16, model 16) TPU meshes over forced
host devices and reads XLA's cost and memory analyses.  The port runs the
cell's step once, its state, batch and cache laid out as DTensors by the
same rules (`distribute_tree`), and records what the run did:

  * **The production meshes** (the default): one process, as the
    reference's.  It starts a fake world of the mesh's size
    (`launch.mesh.init_fake_world`: a "fake" process group, rank 0, whose
    collectives move nothing) and builds state, batch and cache under
    `FakeTensorMode` at the full config: no tensor holds data, so a
    132B-parameter cell runs on one host in seconds to minutes, and rank
    0's program — every rank's, at the same shapes — is what is measured.
  * **The debug mesh** (`--debug-mesh`, data 2 × model 4 or pod 2 × data 2
    × model 2): the cell runs for real on the ranks of a live process group
    (`launch.mesh.init_distributed`, one process per rank).

Both record the same keys, from the same measurement (`measure`: a
`RankTracker` and a `_CommBytes` mode over the step, on rank 0's local
tensors, fake or real):

  * `flops_per_rank`: rank 0's local products (mm / bmm / addmm /
    baddbmm FLOPs of the ops it runs on its shards: the reference's
    per-device cost analysis); `flops`: the whole step, the products of
    all ranks together (`n_devices` × `flops_per_rank`: every rank runs
    rank 0's shapes), which exceeds the step's count on one device by the
    products a layout replicates;
  * `collective_bytes` and `collective_counts`: the output bytes and the
    number of every collective rank 0 issues, by kind (`all_gather`,
    `all_reduce`, `reduce_scatter`, `all_to_all`, ...; per rank, as the
    reference counts its per-device HLO);
  * `memory` (per rank, rank 0's local storages, `RankTracker`):
    `argument_bytes` (the step's arguments), `output_bytes` (its outputs'
    storages that are not an argument's), `peak_bytes` (the most bytes
    alive at once: the arguments, held by the caller through the step as
    `launch.train` holds its state — the old state is released when the
    new one is bound, after the step — and every storage the step makes
    until Python frees it), `temp_bytes` (`peak_bytes` − `argument_bytes`),
    and `peak_kind`, which says so;
  * `planner_ops`: the ops of DTensor's sharding planner left out of the
    above (see `RankTracker`); a cell on a mesh runs some, so a count of 0
    there means the planner is no longer recognised.

A cell fits the card when its `peak_bytes` is at most `HBM_BYTES`.

Usage (one process; the fake world on the card, or `--device cpu`):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2_0_5b --shape decode_32k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --multi-pod --device cpu
The debug mesh, 8 CPU ranks:
  PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 8 \\
      -m repro_torch.launch.dryrun --arch qwen2_0_5b --shape decode_32k --debug-mesh --smoke --device cpu
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import pathlib
import sys
import time
import weakref
from typing import Any, Optional

import torch
from torch.distributed.tensor.debug import CommDebugMode
from torch.utils._python_dispatch import TorchDispatchMode, is_traceable_wrapper_subclass

from repro_torch import tree
from repro_torch.configs import registry
from repro_torch.core.parallelism import Mesh, distribute_tree, rules_for
from repro_torch.data.synthetic import DataConfig, DataIterator
from repro_torch.device import DeviceLike
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import init_fake_world, make_debug_mesh, make_production_mesh, mesh_context
from repro_torch.models import transformer as T
from repro_torch.models.config import ALL_SHAPES, ModelConfig, ShapeConfig
from repro_torch.optim import adam
from repro_torch.serve.engine import make_prefill, make_serve_step
from repro_torch.train.step import init_state, make_train_step

RESULTS = pathlib.Path(__file__).resolve().parents[3] / "results" / "dryrun"
# the H100's 80 GB (decimal; torch reports 85.0e9 bytes on the card): a
# cell whose per-rank peak is at most this fits
HBM_BYTES = 80e9

# cells skipped per the reference's task spec
FULL_ATTENTION_ONLY = {"internlm2-1.8b", "qwen2-0.5b", "deepseek-7b", "dbrx-132b", "moonshot-v1-16b-a3b",
                       "phi-3-vision-4.2b"}
ENCODER_ONLY = {"hubert-xlarge"}


def skip_reason(cfg: ModelConfig, shape: ShapeConfig) -> Optional[str]:
    if cfg.name in ENCODER_ONLY and shape.kind == "decode":
        return "encoder-only: no decode step"
    if cfg.name in FULL_ATTENTION_ONLY and shape.name == "long_500k":
        return "pure full attention: 500k decode excluded per spec"
    return None


def _serve_layout_hints(cfg: ModelConfig, mesh: Mesh) -> dict:
    """Arch-aware serve-rule knobs (the reference's): follow the cache
    layout when kv_heads cannot shard over "model"; keep MoE weights
    resident when their bf16 bytes per model shard fit."""
    n_model = mesh.shape["model"]
    hints = {}
    if cfg.n_kv_heads % n_model != 0:
        hints["prefer_head_dim"] = True
    if cfg.is_moe:
        hints["shard_expert_ffn"] = cfg.total_params() * 2 / n_model > 8e9
    return hints


class _CommBytes(CommDebugMode):
    """`CommDebugMode` that also sums the output bytes of every collective
    it sees (DTensor's functional ones and c10d's own, e.g. a direct
    `all_reduce`), by kind."""

    KINDS = ("all_gather", "reduce_scatter", "all_reduce", "all_to_all", "broadcast")

    def __init__(self):
        super().__init__()
        self.bytes: dict[str, float] = {}
        from torch.distributed.tensor.debug import _comm_mode

        self._collectives = set(self.comm_registry) | set(getattr(_comm_mode, "c10d_collective_ops", ()))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        packet = getattr(func, "_overloadpacket", None)
        if out is not NotImplemented and packet in self._collectives:
            name = str(packet).split(".")[-1]
            kind = next((k for k in self.KINDS if k.replace("_", "") in name.replace("_", "")), name)
            n = sum(t.numel() * t.element_size() for t in torch.utils._pytree.tree_leaves(out)
                    if isinstance(t, torch.Tensor))
            self.bytes[kind] = self.bytes.get(kind, 0.0) + float(n)
        return out


class RankTracker(TorchDispatchMode):
    """What one rank's step holds and computes, on its local tensors, real
    or fake: the bytes of the storages alive at once (`current`, `peak`)
    and the FLOPs of its products (`flops`).

    A dispatch mode that lets DTensor desugar first (it answers
    `NotImplemented` to a DTensor op, as `CommDebugMode` does), so it sees
    every op the rank runs on its shards, collectives included.  An
    output's storage counts once, from the op that makes it until Python
    frees it (a finalizer on the storage: a view keeps its storage alive,
    an in-place op makes none); a wrapper tensor (a DTensor, a collective's
    `AsyncCollectiveTensor`) holds no bytes of its own, only its inner
    tensors' storages; a collective's wait returns its input, whose
    storage a fake run copies, so the copy is not counted and keeps the
    input's alive.  `hold` counts tensors made before the step (its
    arguments).  The FLOPs are `torch.utils.flop_counter`'s formulas
    for the ops it has them for (the products).  The ops DTensor's sharding
    planner runs at global shapes to learn an output's shape are not the
    rank's and are left out (counted in `planner_ops`)."""

    def __init__(self):
        super().__init__()
        self.live: dict[int, int] = {}
        self.current = self.peak = 0
        self.flops = self.planner_ops = 0

    def hold(self, node) -> int:
        """Count the storages of `node`'s tensors (DTensors: their local
        ones) as alive; returns the bytes they add."""
        before = self.current
        for t in tree.leaves(node):
            if isinstance(t, torch.Tensor):
                self._born(t)
        return self.current - before

    def _born(self, t: torch.Tensor, counted: bool = True) -> None:
        for st in _storages(t):
            key = st._cdata
            if key in self.live:
                continue
            n = self.live[key] = int(st.nbytes()) if counted else 0
            self.current += n
            self.peak = max(self.peak, self.current)
            weakref.finalize(st, self._freed, key)

    def _freed(self, key: int) -> None:
        self.current -= self.live.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry

        if any(t is DTensor for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if _in_sharding_propagation():
            self.planner_ops += 1
            return out
        if func is torch.ops._c10d_functional.wait_tensor.default:
            held, got = _storages(args[0]), _storages(out)
            if [st._cdata for st in held] != [st._cdata for st in got]:
                self._born(out, counted=False)
                weakref.finalize(got[0], _keep, held)
            return out
        formula = flop_registry.get(getattr(func, "_overloadpacket", None))
        if formula is not None:
            self.flops += int(formula(*args, **kwargs, out_val=out))
        for t in torch.utils._pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self._born(t)
        return out


def _keep(_) -> None:
    """A finalizer's no-op: its argument lives as long as the finalizer's
    object."""


def _storages(t: torch.Tensor) -> list:
    """The storages that hold `t`'s bytes: a wrapper subclass's (DTensor,
    `AsyncCollectiveTensor`) are its inner tensors'."""
    if not is_traceable_wrapper_subclass(t):
        return [t.untyped_storage()]
    attrs, _ = t.__tensor_flatten__()
    inner = (getattr(t, a) for a in attrs)
    return [st for x in inner if isinstance(x, torch.Tensor) for st in _storages(x)]


def _in_sharding_propagation() -> bool:
    """Whether DTensor's sharding planner is on the Python stack: it runs
    an op once at its global shapes on fake arguments of its own to learn
    the output's shape, which no rank computes or holds."""
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_filename.endswith("_sharding_prop.py"):
            return True
        f = f.f_back
    return False


def measure(fn, args: tuple, sync=None) -> dict:
    """Run `fn(*args)` once under a `RankTracker` and a `_CommBytes` mode
    and return this rank's record: `flops_per_rank`, `collective_bytes`,
    `collective_counts`, `memory` (argument, output, temp and peak bytes
    with `peak_kind`), `planner_ops` and `run_s` (between two calls of
    `sync`, when given).  `args` stay held through the run, as a caller
    holds a step's state until it binds the new one; real tensors or fake
    ones (`FakeTensorMode`), with or without a mesh."""
    tracker = RankTracker()
    arg_bytes = tracker.hold(args)
    arg_keys = set(tracker.live)
    comm = _CommBytes()
    if sync:
        sync()
    t0 = time.perf_counter()
    with comm, tracker:
        out = fn(*args)
    if sync:
        sync()
    run_s = time.perf_counter() - t0
    outs = {st._cdata: int(st.nbytes()) for t in tree.leaves(out) if isinstance(t, torch.Tensor)
            for st in _storages(t) if st._cdata not in arg_keys}
    return {
        "run_s": run_s,
        "flops_per_rank": float(tracker.flops),
        "collective_bytes": collective_bytes(comm),
        "collective_counts": {str(k).split(".")[-1]: v for k, v in comm.get_comm_counts().items()},
        "planner_ops": tracker.planner_ops,
        "memory": {
            "argument_bytes": arg_bytes,
            "output_bytes": sum(outs.values()),
            "temp_bytes": tracker.peak - arg_bytes,
            "peak_bytes": tracker.peak,
            "peak_kind": "one rank's local storages alive at once: the step's arguments, held by the caller "
                         "through the step (no donation), and every storage the step makes until it is freed",
        },
    }


def collective_bytes(comm_mode) -> dict[str, float]:
    """Output bytes of the collectives a `_CommBytes` mode saw, by kind
    (the reference parses them out of the compiled HLO's text)."""
    return dict(comm_mode.bytes)


def cost_analysis_dict(rec: dict, n_devices: int) -> dict:
    """The cost record of a cell measured on a mesh of `n_devices` (`rec`
    is `measure`'s): {"flops": the whole step, every rank's products}
    (the reference reads XLA's cost analysis of the compiled cell)."""
    return {"flops": rec["flops_per_rank"] * n_devices}


def _cell_cfg(cfg: ModelConfig, shape: ShapeConfig, qat: bool) -> ModelConfig:
    if qat and shape.kind == "train":
        cfg = dataclasses.replace(cfg, qat=True, qat_delay=10_000)
    return cfg


def build_cell(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh, *, qat: bool):
    """(step, example_args) for one cell: the step built with the phase's
    rules, its arguments made on this rank's device from seed 0 and laid
    out as DTensors on `mesh` (which must run: a process group of its
    size).  Train: (state, batch); prefill: (params, batch); decode:
    (params, tokens, cache, pos)."""
    mesh.runnable()
    dev = mesh.devices[0]
    cfg = _cell_cfg(cfg, shape, qat)
    attn_chunk = 4096 if shape.seq_len > 4096 else 0
    if shape.kind == "train":
        rules = rules_for(mesh, "train")
        st_sh, b_sh = S.train_shardings(cfg, shape, mesh, rules)
        opt_cfg = adam.AdamConfig(lr=1e-4, grad_clip_norm=1.0)
        fn = make_train_step(cfg, opt_cfg, rules=rules, attn_chunk=attn_chunk)
        state = init_state(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
        batch = next(DataIterator(DataConfig(seed=0), cfg, shape, device=dev))
        return fn, (distribute_tree(state, st_sh), distribute_tree(batch, b_sh))
    params = T.init_params(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    if shape.kind == "prefill":
        rules = rules_for(mesh, "serve")
        p_sh, b_sh, _ = S.serve_shardings(cfg, shape, mesh, rules)
        fn = make_prefill(cfg, rules=rules, attn_chunk=attn_chunk)
        batch = next(DataIterator(DataConfig(seed=0), cfg, shape, device=dev))
        batch.pop("labels", None)
        return fn, (distribute_tree(params, p_sh), distribute_tree(batch, b_sh))
    # decode: one token at the cache's last position
    shard_kv_seq = shape.global_batch == 1  # long-context single request: sequence-parallel
    rules = rules_for(mesh, "serve", shard_kv_seq=shard_kv_seq, **_serve_layout_hints(cfg, mesh))
    p_sh, b_sh, c_sh = S.serve_shardings(cfg, shape, mesh, rules)
    fn = make_serve_step(cfg, rules=rules)
    gen = torch.Generator(device=dev).manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (shape.global_batch, 1), generator=gen, device=dev,
                           dtype=torch.int32)
    cache = T.init_cache(cfg, shape.global_batch, shape.seq_len, device=dev)
    return fn, (distribute_tree(params, p_sh), distribute_tree({"tokens": tokens}, b_sh)["tokens"],
                distribute_tree(cache, c_sh), shape.seq_len - 1)


def production_mesh(*, multi_pod: bool, device: DeviceLike = None) -> Mesh:
    """The production mesh (16 × 16, or 2 × 16 × 16 with `multi_pod`) over
    a fake world of its size on `device` (`init_fake_world`; one already
    up is kept)."""
    init_fake_world(512 if multi_pod else 256, device)
    return make_production_mesh(multi_pod=multi_pod)


def measure_cell(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh, *, qat: bool, fake: bool = True) -> dict:
    """One cell of `cfg` (any config: the CLI's are the registry's) on
    `mesh`, built and run once (`measure`): under `FakeTensorMode` over a
    fake world (`production_mesh`), or with `fake=False` on real tensors
    over the live process group (the ranks in step: a barrier, and on the
    card a device sync, on each side of the timed run).  The record with
    `status` "ok", `n_devices`, `flops`, `build_s` and `run_s`."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    sync = None
    if not fake:
        import torch.distributed as dist

        cuda = mesh.runnable().device_type == "cuda"

        def sync():
            if cuda:
                torch.cuda.synchronize()
            dist.barrier()

    t0 = time.perf_counter()
    with FakeTensorMode() if fake else contextlib.nullcontext(), mesh_context(mesh):
        fn, args = build_cell(cfg, shape, mesh, qat=qat)
        build_s = time.perf_counter() - t0
        rec = measure(fn, args, sync)
    return {"status": "ok", "build_s": build_s, "n_devices": int(mesh.size),
            **cost_analysis_dict(rec, mesh.size), **rec}


def _mesh_name(debug_mesh: bool, multi_pod: bool) -> str:
    return "debug" if debug_mesh else ("pod2x16x16" if multi_pod else "pod16x16")


def run_cell(arch: str, shape: ShapeConfig, *, multi_pod: bool, qat: bool, debug_mesh: bool = False,
             smoke: bool = False, device: DeviceLike = None) -> dict:
    """Build the cell and run it once (`measure_cell`); returns the
    reference's record (status, n_devices, flops, collective_bytes,
    memory, with `run_s` for its `compile_s`).  On a production mesh under
    fake tensors in this process (its fake world started on `device`
    unless one is up), on the debug mesh with real tensors on the live
    process group.  `smoke` takes the reduced config."""
    cfg = registry.get_smoke(arch) if smoke else registry.get(arch)
    reason = skip_reason(cfg, shape)
    rec: dict[str, Any] = {"arch": cfg.name, "shape": shape.name, "mesh": _mesh_name(debug_mesh, multi_pod),
                           "status": "skip", "skip_reason": reason}
    if reason:
        return rec
    if debug_mesh:
        rec.update(measure_cell(cfg, shape, make_debug_mesh(multi_pod=multi_pod), qat=qat, fake=False))
    else:
        rec.update(measure_cell(cfg, shape, production_mesh(multi_pod=multi_pod, device=device), qat=qat))
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--debug-mesh", action="store_true", help="the 8-device debug mesh (data 2 x model 4)")
    ap.add_argument("--smoke", action="store_true", help="the reduced same-family configs")
    ap.add_argument("--no-qat", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch.distributed as dist

    from repro_torch.launch.mesh import init_distributed

    if args.debug_mesh:  # one process per rank of a live group
        init_distributed(args.device)
    else:  # the production mesh: a fake world in this process
        init_fake_world(512 if args.multi_pod else 256, args.device)
    archs = registry.lm_archs() if args.arch == "all" else [args.arch]
    shapes = list(ALL_SHAPES) if args.shape == "all" else [s for s in ALL_SHAPES if s.name == args.shape]
    rank = dist.get_rank()
    if rank == 0:
        RESULTS.mkdir(parents=True, exist_ok=True)
    ok = True
    try:
        for arch in archs:
            for shape in shapes:
                try:
                    rec = run_cell(arch, shape, multi_pod=args.multi_pod, qat=not args.no_qat,
                                   debug_mesh=args.debug_mesh, smoke=args.smoke, device=args.device)
                except Exception as e:  # noqa: BLE001 — record and continue
                    rec = {"arch": arch, "shape": shape.name, "mesh": _mesh_name(args.debug_mesh, args.multi_pod),
                           "status": "error", "error": f"{type(e).__name__}: {e}"}
                    ok = False
                if rank != 0:
                    continue
                name = f"{rec['arch']}_{rec['shape']}_{rec['mesh']}.json"
                out = pathlib.Path(args.out) if args.out else RESULTS / name
                out.write_text(json.dumps(rec, indent=2, default=str))
                line = {k: rec.get(k) for k in ("arch", "shape", "mesh", "status", "run_s", "skip_reason", "error")}
                print(json.dumps(line), flush=True)
                if rec["status"] == "ok":
                    mem = rec["memory"]
                    print(f"  flops={rec['flops']:.3e} peak/rank={mem['peak_bytes'] / 1e9:.2f} GB "
                          f"coll={ {k: f'{v:.2e}' for k, v in rec['collective_bytes'].items()} }", flush=True)
    finally:
        dist.destroy_process_group()
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
