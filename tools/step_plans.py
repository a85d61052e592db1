#!/usr/bin/env python3
"""Time kernels 4 and 5's chain passes on other launch plans than
`step_plan` picks.

    python3 tools/step_plans.py [--batch B]

For each variant (the chosen plans, then one pass forced to another rows
per block and cluster width, persistent where its row blocks outnumber the
clusters the card holds) it prints one JSON line with the device µs a call
of each pass takes (`chip_smoke._pass_us`: a torch.profiler trace of 50
calls, by kernel name) in both phases, at the paper's nets.
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=128)
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
    for label, force in VARIANTS:
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
