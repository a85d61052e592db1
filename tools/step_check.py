#!/usr/bin/env python3
"""Hold one tree's kernels 4 and 5 to the step check, case by case.

    python3 tools/step_check.py TREE [--label NAME] [--seeds N]

TREE is a checkout of the repository (the current one, `.`, or an older
commit unpacked with `git archive` into a directory `.gitignore` lists).
The script imports TREE's `src/`, the current `chip_smoke.py` and the
current `kernels/fxp_mlp/replay.py` (loaded by path, so an older tree is
held to the same check), builds TREE's kernels, runs the phases that draw
from the shared generator before `kernel_step` (so the cases get
`kernel_step`'s own inputs), then checks kernel 4 and kernel 5 against
their twins with `replay.check_step` on every `kernel_step` case, on
`kernel_step`'s two base cases drawn from a fresh generator of seed 0
instead (other inputs of the same shapes; kernel 4 moves one param two
quanta there, ROADMAP queue 3), and on N more seeded cases (B = 200 with
30 masked rows and B = 128, both phases; seeds 1000..).  The kernels'
pass-2 operands (product inputs and cotangents) come from the wrappers'
internal launch helpers, or for a tree without them from the wrappers'
allocations.
Prints one JSON line: the label, the failures and every case's result:
worst error of each tree, the param and the first moment farthest from the
twin's (leaf, index, the pre-projection gradient there on each side from
the operands and its slack, in quanta of 2⁻¹⁶, and v) and the replay's
counts, with the first few
ReLU decisions the kernel took apart from the twin (row, unit, exact
pre-activation, its rounding bound, Σ|terms|, both cotangents).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import pathlib
import sys
import types

REPO = pathlib.Path(__file__).resolve().parents[1]


def scratch_reader(kernel_mod, torch):
    """A function that calls a step kernel and returns (out, (qs, gs))."""
    recorded = []
    helpers = {"critic": getattr(kernel_mod, "_ddpg_critic_step", None),
               "actor": getattr(kernel_mod, "_ddpg_actor_step", None)}
    if None in helpers.values():
        # a tree before the internal launch helpers: the last six
        # allocations of a wrapper call are its qs and gs
        shim = types.SimpleNamespace(**{k: getattr(torch, k) for k in dir(torch) if not k.startswith("__")})

        def empty(*args, **kw):
            t = torch.empty(*args, **kw)
            recorded.append(t)
            return t

        shim.empty = empty
        kernel_mod.torch = shim

    def call(name, args, phase, kw):
        if helpers[name] is not None:
            return helpers[name](*args, phase, **kw)
        recorded.clear()
        out = getattr(kernel_mod, f"ddpg_{name}_step_cuda")(*args, phase, **kw)
        return out, (recorded[-6:-3], recorded[-3:])

    return call


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("tree", type=pathlib.Path)
    ap.add_argument("--label", default=None)
    ap.add_argument("--seeds", type=int, default=24)
    args = ap.parse_args(argv)
    tree = args.tree.resolve()
    sys.path[:0] = [str(REPO), str(tree / "src")]
    import torch

    import chip_smoke as cs
    import repro_torch
    from repro_torch.kernels.fxp_mlp import kernel as K
    from repro_torch.kernels.fxp_mlp.ref import ref_ddpg_actor_step, ref_ddpg_critic_step

    if not pathlib.Path(repro_torch.__file__).resolve().is_relative_to(tree):
        raise SystemExit(f"imported {repro_torch.__file__}, not {tree}'s")
    spec = importlib.util.spec_from_file_location("step_replay", REPO / "src/repro_torch/kernels/fxp_mlp/replay.py")
    replay = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(replay)
    if not torch.cuda.is_available():
        print("step_check: no CUDA device available", file=sys.stderr)
        return 2
    call = scratch_reader(K, torch)
    dev = torch.device("cuda")
    info = cs.phase_device()
    cs.phase_build()

    def check(c, phase, edge=False):
        quant = phase == "quant"
        pt = torch.full((1,), int(quant), dtype=torch.int32, device=dev)
        want_c = ref_ddpg_critic_step(*cs._critic_args(c), quant, **c["kw"])
        got_c, sc = call("critic", cs._critic_args(c), pt, c["kw"])
        a_args = cs._actor_args(c, want_c[0])
        got_a, sa = call("actor", a_args, pt, c["kw"])
        want_a = ref_ddpg_actor_step(*a_args, quant, **c["kw"])
        torch.cuda.synchronize()
        res = {}
        for name, got, want, scratch in (("critic", got_c, want_c, sc), ("actor", got_a, want_a, sa)):
            r = replay.check_step(got, want, c, name, quant, *scratch, critic=want_c[0] if name == "actor" else None,
                                  edge=edge)
            res[name] = {"ok": not r["failures"], "failures": r["failures"], "max_abs": r["max_abs"],
                         "worst": r["worst"], **r["replay"]}
        return res

    gen = torch.Generator().manual_seed(0)
    for phase_fn in (cs.phase_kernel_a, cs.phase_kernel_b, cs.phase_kernel_b_res, cs.phase_kernel_bwd):
        phase_fn(gen, dev)
    cases = {}
    for label, _, _, c in cs._step_cases(gen, dev):
        for phase in cs.STEP_PHASES:
            cases[f"{label} {phase}"] = check(c, phase, label.startswith("plan"))
    fresh = torch.Generator().manual_seed(0)
    for batch, masked in cs.STEP_CASES:
        c = cs._step_case(fresh, dev, batch, masked)
        for phase in cs.STEP_PHASES:
            cases[f"fresh seed 0 B={batch} masked={masked} {phase}"] = check(c, phase)
    for seed in range(args.seeds):
        g = torch.Generator().manual_seed(1000 + seed)
        for batch, masked in ((200, 30), (128, 0)):
            c = cs._step_case(g, dev, batch, masked)
            for phase in cs.STEP_PHASES:
                cases[f"seed {1000 + seed} B={batch} masked={masked} {phase}"] = check(c, phase)
    fails = [f"{case} {name}" for case, res in cases.items() for name, r in res.items() if not r["ok"]]
    print(json.dumps({"step_check": args.label or str(args.tree), "card": info["nvidia_smi"], "fails": fails,
                      "cases": cases}), flush=True)
    return 0 if not fails else 1


if __name__ == "__main__":
    sys.exit(main())
