"""End-to-end LM training driver (port of `repro.launch.train`).

Wires every substrate together: config registry -> synthetic data ->
QAT-enabled train step -> (fixed-point) Adam -> async checkpointing ->
heartbeat/straggler supervisor -> deterministic restart.

On the card (the default device):
  PYTHONPATH=src python -m repro_torch.launch.train --arch demo_100m --steps 300 \\
      --batch 8 --seq 1024 --qat --qat-delay 100 --ckpt-dir build/ckpt_demo

On the CPU, at the smoke config:
  PYTHONPATH=src python -m repro_torch.launch.train --arch demo_100m --smoke --device cpu \\
      --steps 30 --batch 2 --seq 64 --qat --qat-delay 10
(`--arch moonlight-16b-a3b`, the latent-attention MoE, logs its MoE
counters besides.)

Sharded, one process per rank (`--mesh debug`: data 2 × model 4, the
reference's debug layout; here on 8 CPU ranks):
  PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 8 \
      -m repro_torch.launch.train --arch demo_100m --smoke --device cpu --mesh debug --steps 3

It prints the reference's log lines (one JSON object per `--log-every`
steps: step, loss, lr, grad_norm, quant_phase, s_per_step, tokens_per_s;
the card is synchronized before the clock is read) and returns the final
`TrainState` and those records.  `--mesh debug|pod16x16` builds the
reference's layout and its train rules, joins the launcher's process group
(`launch.mesh.init_distributed`: `nccl` on the card, rank r on cuda:r,
`gloo` on the CPU) and lays the state and every batch out as DTensors;
rank 0 logs and writes the checkpoints, which every rank gathers, and a
resume restores onto the run's own layout.  A world whose size is not the
mesh's raises, and so does `pod16x16` (256 devices, a layout only): a
sharded run never falls back to one device.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import time

import torch

from repro_torch import tree
from repro_torch.checkpoint import ckpt
from repro_torch.configs import registry
from repro_torch.core.parallelism import distribute_tree, is_dtensor, rules_for
from repro_torch.data.synthetic import DataConfig, DataIterator
from repro_torch.device import resolve_device
from repro_torch.models.config import ShapeConfig
from repro_torch.optim import adam, schedule
from repro_torch.runtime.ft import TrainingSupervisor
from repro_torch.train.step import init_state, make_train_step


# an MLA model's MoE counters (`train.step`), read with the window's other metrics
MOE_COUNTERS = ("moe_rows_held", "moe_load_max_over_mean", "moe_rows_dropped", "moe_bias_absmax")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="demo_100m")
    ap.add_argument("--smoke", action="store_true", help="use the reduced same-family config")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=50)
    ap.add_argument("--qat", action="store_true")
    ap.add_argument("--qat-delay", type=int, default=0)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--mesh", default="none", choices=["none", "debug", "pod16x16"])
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = registry.get_smoke(args.arch) if args.smoke else registry.get(args.arch)
    if args.qat:
        cfg = dataclasses.replace(cfg, qat=True, qat_delay=args.qat_delay)
    shape = ShapeConfig("train_cli", "train", args.seq, args.batch)

    rules = st_sh = b_sh = None
    rank = 0
    with contextlib.ExitStack() as scope:
        if args.mesh != "none":
            import torch.distributed as dist

            from repro_torch.launch import specs
            from repro_torch.launch.mesh import init_distributed, make_debug_mesh, make_production_mesh, mesh_context

            if args.mesh == "pod16x16":
                make_production_mesh().runnable()  # raises: 256 devices, a layout only
            started = not dist.is_initialized()
            dev = init_distributed(dev)
            if started:
                scope.callback(dist.destroy_process_group)
            rank = dist.get_rank()
            mesh = make_debug_mesh()
            rules = rules_for(mesh, "train")
            scope.enter_context(mesh_context(mesh))
            st_sh, b_sh = specs.train_shardings(cfg, shape, mesh, rules)

        opt_cfg = adam.AdamConfig(lr=args.lr, grad_clip_norm=1.0,
                                  schedule=schedule.warmup_cosine(args.warmup, args.steps))
        step_fn = make_train_step(cfg, opt_cfg, rules=rules, n_microbatches=args.microbatches)

        state = init_state(torch.Generator(device=dev).manual_seed(args.seed), cfg, device=dev)
        if st_sh is not None:
            state = distribute_tree(state, st_sh)
        start_step = 0
        if args.resume and args.ckpt_dir:
            latest = ckpt.latest_step(args.ckpt_dir)
            if latest is not None:
                state, start_step, _ = ckpt.restore(args.ckpt_dir, state, shardings=st_sh)
                if rank == 0:
                    print(f"resumed from step {start_step}")

        data = DataIterator(DataConfig(seed=args.seed), cfg, shape, start_step=start_step, device=dev)
        writer = ckpt.AsyncCheckpointer(args.ckpt_dir) if args.ckpt_dir else None
        supervisor = TrainingSupervisor(n_hosts=1,
                                        devices_per_host=torch.cuda.device_count() if dev.type == "cuda" else 1)

        n_params = sum(t.numel() for t in tree.leaves(state.params))
        if rank == 0:
            print(f"arch={cfg.name} params={n_params / 1e6:.1f}M qat={cfg.qat} "
                  f"delay={cfg.qat_delay} steps={args.steps}")

        records = []
        t_last = time.perf_counter()
        for step in range(start_step, args.steps):
            batch = next(data)
            if b_sh is not None:
                batch = distribute_tree(batch, b_sh)
            state, metrics = step_fn(state, batch)
            if (step + 1) % args.log_every == 0 or step == args.steps - 1:
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                now = time.perf_counter()
                dt = (now - t_last) / args.log_every
                t_last = now
                supervisor.step_report(0, dt)
                m = {k: v.full_tensor() if is_dtensor(v) else v for k, v in metrics.items()}
                records.append({
                    "step": step + 1, "loss": round(float(m["loss"]), 4),
                    "lr": float(m["lr"]),
                    "grad_norm": round(float(m.get("grad_norm", 0)), 3),
                    "quant_phase": int(m.get("quant_phase", 0)),
                    "s_per_step": round(dt, 3),
                    "tokens_per_s": round(args.batch * args.seq / dt, 1)})
                records[-1].update({k: float(m[k]) for k in MOE_COUNTERS if k in m})
                if rank == 0:
                    print(json.dumps(records[-1]), flush=True)
            if writer and (step + 1) % args.ckpt_every == 0:
                writer.save(step + 1, state, extra={"arch": cfg.name})
        if writer:
            writer.save(args.steps, state, extra={"arch": cfg.name})
            writer.close()
    if rank == 0:
        print("done")
    return state, records


if __name__ == "__main__":
    main()
