#!/usr/bin/env python3
"""Time kernels 4 and 5's chain passes, and kernel 3's, on other launch
plans than `step_plan` and `bwd_plan` pick.

    python3 tools/step_plans.py [--batch B] [--kernels step|bwd|all]

For each variant (the chosen plans, then one pass forced to another rows
per block and cluster width, persistent where its row blocks outnumber the
clusters the card holds) it prints one JSON line with the device µs a call
of each pass takes (`chip_smoke._pass_us`: a torch.profiler trace of 50
calls, by kernel name) in both phases, at the paper's nets; kernel 3's
lines (`bwd_plans`) time its chain pass and pass 2 for the actor and the
critic on the residuals of kernel B's forward.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]
VARIANTS = (("chosen", {}), ("actor 8 rows, C 8", {"actor": (8, 8)}), ("actor 8 rows, C 16", {"actor": (8, 16)}),
            ("actor 16 rows, C 16", {"actor": (16, 16)}), ("critic 16 rows, C 8", {"critic": (16, 8)}),
            ("critic 8 rows, C 8", {"critic": (8, 8)}), ("critic 8 rows, C 16", {"critic": (8, 16)}),
            ("target 8 rows, C 8", {"target": (8, 8)}))
BWD_VARIANTS = (("chosen", None), ("8 rows, C 4", (8, 4)), ("16 rows, C 8", (16, 8)), ("8 rows, C 8", (8, 8)),
                ("16 rows, C 4", (16, 4)), ("8 rows, C 16", (8, 16)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--kernels", choices=("step", "bwd", "all"), default="all")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(REPO), str(REPO / "src")]
    import torch

    import chip_smoke as cs
    from repro_torch.kernels.fxp_mlp import kernel as K

    if not torch.cuda.is_available():
        print("step_plans: no CUDA device available", file=sys.stderr)
        return 2
    dims = {"actor": cs.ACTOR_DIMS, "critic": cs.CRITIC_DIMS}
    chosen, forced = K.step_plan, {}

    def plan(m, actor_dims, critic_dims, which):
        if which not in forced:
            return chosen(m, actor_dims, critic_dims, which)
        bm, c = forced[which]
        nets = [dims[n] for n in K.STEP_NETS[which]]
        layouts = (K._step_layout(bm, c, nets, True, nbuf) for nbuf in (2, 1))
        layout = next(p for p in layouts if p.smem <= K.MAX_SMEM - K.STATIC_SMEM)
        return layout._replace(n_clusters=min(-(-m // bm), K.CLUSTER_SLOTS[c]))

    K.step_plan = plan
    dev = torch.device("cuda")
    info = cs.phase_device()
    cs.phase_build()
    c = cs._step_case(torch.Generator().manual_seed(5), dev, args.batch, 0)
    for label, force in VARIANTS if args.kernels != "bwd" else ():
        forced.clear()
        forced.update(force)
        row = {"step_plans": label, "card": info["nvidia_smi"], "batch": args.batch,
               "plans": {w: list(plan(args.batch, dims["actor"], dims["critic"], w)[:5]) for w in K.STEP_NETS}}
        for phase in cs.STEP_PHASES:
            pt = torch.full((1,), int(phase == "quant"), dtype=torch.int32, device=dev)
            row[phase] = {
                "kernel4": cs._pass_us(lambda: K.ddpg_critic_step_cuda(*cs._critic_args(c), pt, **c["kw"])),
                "kernel5": cs._pass_us(lambda: K.ddpg_actor_step_cuda(*cs._actor_args(c, c["critic"]), pt, **c["kw"])),
            }
        print(json.dumps(row), flush=True)
    if args.kernels != "step":
        bwd_variants(args.batch, dev, info, cs, K, torch)
    return 0


def bwd_variants(batch, dev, info, cs, K, torch) -> None:
    """Kernel 3's chain pass and pass 2 on each of BWD_VARIANTS."""
    chosen = K.bwd_plan
    gen = torch.Generator().manual_seed(5)
    nets = {}
    for net in cs.NETS:
        dims, acts, ws, bs, deltas, zs = cs._net_operands(gen, dev, net)
        x = (torch.randn(batch, dims[0], generator=gen) * 2).to(dev)
        g = torch.randn(batch, dims[-1], generator=gen).to(dev)
        nets[net] = (dims, acts, ws, bs, deltas, zs, x, g)
    for label, force in BWD_VARIANTS:
        def plan(m, dims, force=force):
            if force is None:
                return chosen(m, dims)
            bm, c = force
            return K._bwd_layout(bm, c, dims, True)._replace(n_clusters=min(-(-m // bm), K.CLUSTER_SLOTS[c]))

        K.bwd_plan = plan
        row = {"bwd_plans": label, "card": info["nvidia_smi"], "batch": batch}
        for net, (dims, acts, ws, bs, deltas, zs, x, g) in nets.items():
            p = plan(batch, dims)
            row[net] = {"plan": list(p[:4]), "smem": p.smem}
            for phase in cs.STEP_PHASES:
                kw = cs._case_kw(acts, phase)
                _, _, _, qs, hs = K.fxp_mlp_fwd_cuda(x, ws, bs, deltas, zs, save_residuals=True, **kw)
                row[net][phase] = cs._pass_us(lambda: K.fxp_mlp_bwd_cuda(g, x, ws, qs, hs, deltas, zs, **kw))
        print(json.dumps(row), flush=True)
    K.bwd_plan = chosen


if __name__ == "__main__":
    sys.exit(main())
