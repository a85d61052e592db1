"""Dry-run cells: build and run one (arch × shape × mesh) step on the live
process group (port of `repro.launch.dryrun`).

The reference lowers and compiles every cell for a 256- or 512-device TPU
mesh over forced host devices and reads XLA's cost and memory analyses.
The port runs the cell once, for real, on the ranks of the process group
(`launch.mesh.init_distributed`), its state, batch and cache laid out as
DTensors by the same rules, and records what the run did:

  * `flops`: `torch.utils.flop_counter.FlopCounterMode` over the step (the
    whole step's products at their global shapes);
  * `collective_bytes`: the bytes of every collective DTensor issued, by
    kind (`all_gather`, `all_reduce`, `reduce_scatter`, `all_to_all`, ...),
    from a `CommDebugMode` that also sums each collective's output bytes;
  * `memory`: per rank, the bytes of the step's arguments and outputs held
    locally, and the peak (the card's allocator peak on the card; the
    process's peak resident set on the CPU, which includes the runtime).

The production meshes (16 × 16 and 2 × 16 × 16) are layouts only in the
port: asked to run, they raise.

Usage (8 CPU ranks, the debug mesh data 2 × model 4):
  PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 8 \\
      -m repro_torch.launch.dryrun --arch qwen2_0_5b --shape decode_32k --debug-mesh --smoke --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys
import time
from typing import Any, Optional

import torch
from torch.distributed.tensor.debug import CommDebugMode

from repro_torch import tree
from repro_torch.configs import registry
from repro_torch.core.parallelism import Mesh, distribute_tree, is_dtensor, rules_for
from repro_torch.data.synthetic import DataConfig, DataIterator
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh, mesh_context
from repro_torch.models import transformer as T
from repro_torch.models.config import ALL_SHAPES, ModelConfig, ShapeConfig
from repro_torch.optim import adam
from repro_torch.serve.engine import make_prefill, make_serve_step
from repro_torch.train.step import init_state, make_train_step

RESULTS = pathlib.Path(__file__).resolve().parents[3] / "results" / "dryrun"

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
    DTensor issues, by kind."""

    KINDS = (("all_gather", "all_gather"), ("reduce_scatter", "reduce_scatter"), ("all_reduce", "all_reduce"),
             ("all_to_all", "all_to_all"), ("broadcast", "broadcast"))

    def __init__(self):
        super().__init__()
        self.bytes: dict[str, float] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        packet = getattr(func, "_overloadpacket", None)
        if out is not NotImplemented and packet in self.comm_registry:
            name = str(packet).split(".")[-1]
            kind = next((k for key, k in self.KINDS if key in name), name)
            n = sum(t.numel() * t.element_size() for t in torch.utils._pytree.tree_leaves(out)
                    if isinstance(t, torch.Tensor))
            self.bytes[kind] = self.bytes.get(kind, 0.0) + float(n)
        return out


def collective_bytes(comm_mode) -> dict[str, float]:
    """Output bytes of the collectives a `_CommBytes` mode saw, by kind
    (the reference parses them out of the compiled HLO's text)."""
    return dict(comm_mode.bytes)


def cost_analysis_dict(counter) -> dict:
    """The cost record of a run: {"flops": total} from a
    `FlopCounterMode` (the reference reads XLA's cost analysis)."""
    return {"flops": float(counter.get_total_flops())}


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


def _local_bytes(node) -> int:
    return sum((t.to_local() if is_dtensor(t) else t).nbytes for t in tree.leaves(node) if isinstance(t, torch.Tensor))


def run_cell(arch: str, shape: ShapeConfig, *, multi_pod: bool, qat: bool, debug_mesh: bool = False,
             smoke: bool = False) -> dict:
    """Build the cell and run it once on the live process group; returns the
    reference's record (status, n_devices, flops, collective_bytes,
    memory, with `run_s` for its `compile_s`).  `smoke` takes the reduced
    config."""
    import torch.distributed as dist
    from torch.utils.flop_counter import FlopCounterMode

    cfg = registry.get_smoke(arch) if smoke else registry.get(arch)
    reason = skip_reason(cfg, shape)
    mesh = make_debug_mesh(multi_pod=multi_pod) if debug_mesh else make_production_mesh(multi_pod=multi_pod)
    mesh_name = "debug" if debug_mesh else ("pod2x16x16" if multi_pod else "pod16x16")
    rec: dict[str, Any] = {"arch": cfg.name, "shape": shape.name, "mesh": mesh_name, "status": "skip",
                           "skip_reason": reason}
    if reason:
        return rec
    t0 = time.perf_counter()
    with mesh_context(mesh):
        fn, args = build_cell(cfg, shape, mesh, qat=qat)
        dm = mesh.runnable()
        cuda = dm.device_type == "cuda"
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        dist.barrier()
        t1 = time.perf_counter()
        comm = _CommBytes()
        with FlopCounterMode(display=False) as counter, comm:
            out = fn(*args)
        if cuda:
            torch.cuda.synchronize()
        dist.barrier()
        t2 = time.perf_counter()
    import resource

    peak = torch.cuda.max_memory_allocated() if cuda else resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    rec.update(
        status="ok",
        build_s=t1 - t0, run_s=t2 - t1,
        n_devices=int(mesh.size),
        flops=cost_analysis_dict(counter)["flops"],
        collective_bytes=collective_bytes(comm),
        collective_counts={str(k).split(".")[-1]: v for k, v in comm.get_comm_counts().items()},
        memory={
            "argument_bytes": _local_bytes(args),
            "output_bytes": _local_bytes(out),
            "peak_bytes": int(peak),
            "peak_kind": "cuda allocator" if cuda else "process resident set",
        },
    )
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

    if not args.debug_mesh:  # 256 / 512 devices: layouts only in the port
        make_production_mesh(multi_pod=args.multi_pod).runnable()
    init_distributed(args.device)
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
                                   debug_mesh=args.debug_mesh, smoke=args.smoke)
                except Exception as e:  # noqa: BLE001 — record and continue
                    rec = {"arch": arch, "shape": shape.name, "mesh": "debug" if args.debug_mesh else "pod16x16",
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
                    print(f"  flops={rec['flops']:.3e} coll={ {k: f'{v:.2e}' for k, v in rec['collective_bytes'].items()} }",
                          flush=True)
    finally:
        dist.destroy_process_group()
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
