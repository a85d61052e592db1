#!/usr/bin/env python3
"""Hold one tree's kernels 4 and 5 to the step check, case by case.

    python3 tools/step_check.py TREE [--label NAME] [--seeds N]
    python3 tools/step_check.py --reference [--batch B] [--steps N]   (the CPU, JAX)

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

`--reference` runs on the CPU, with JAX, and needs no card: it replays
the JAX reference's own `test_monitor_phase_tracks_pallas_path[200-None]`
(tests/kernels/test_fxp_mlp_step.py, its inputs from that file's `_batch`)
step by step through the reference's fused step and its 8-launch "pallas"
path, finds the param farthest apart, recovers each path's Q15.16 gradient
there at every step from the first moments, and at the step where they part
replays the pre-activations of the param's net in float64 from each path's
own params and residuals (`ops._train_fwd_call`): every ReLU decision
whose exact pre-activation lies within float32's rounding bound of 0
(λ·u·√Σ s_k² per limb chain, λ = 10, as `kernels/fxp_mlp/replay.py`), and
what the gradient at the param becomes when that one decision is taken the
other way.  Prints one JSON line.
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


U = 2.0**-24  # float32's unit roundoff
LAMBDA = 10.0  # kernels/fxp_mlp/replay.py LAMBDA
Q = 2.0**-16  # one Q15.16 quantum


def _bf16_hi(x):
    """float32 → its bf16 round-to-nearest-even hi limb, as float32 (numpy)."""
    import numpy as np

    b = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32).astype(np.uint64)
    b = (b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000
    return b.astype(np.uint32).view(np.float32)


def _chain(a, w):
    """λ·u·√Σ s_k² of the float32 chains Σ_j a[r, j]·w[j, c], per (r, c),
    the prefix sums in j order: float64 (R, C)."""
    import numpy as np

    out = np.empty((a.shape[0], w.shape[1]))
    step = max(1, (1 << 22) // max(1, a.shape[1] * w.shape[1]))
    for r0 in range(0, a.shape[0], step):
        s = np.cumsum(a[r0:r0 + step, :, None] * w[None], axis=1)
        out[r0:r0 + step] = np.sqrt(np.square(s).sum(1))
    return LAMBDA * U * out


def _pre_bound(q, w):
    """The forward's bound: one chain per limb (the monitor phase's bf16 hi
    and the residual lo), float64 (R, N)."""
    hi = _bf16_hi(q).astype("float64")
    return _chain(hi, w) + _chain(q.astype("float64") - hi, w)


def reference_case(batch: int, steps: int) -> int:
    """The JAX reference's fused step against its 8-launch path (module
    docstring); the CPU only."""
    import importlib.util

    import jax
    import jax.numpy as jnp
    import numpy as np

    sys.path[:0] = [str(REPO / "src")]
    from repro.core.qat import QATContext
    from repro.kernels.fxp_mlp import ops as rops
    from repro.optim import fxp_adam
    from repro.rl import ddpg

    spec_t = importlib.util.spec_from_file_location("ref_step_test", REPO / "tests/kernels/test_fxp_mlp_step.py")
    test = importlib.util.module_from_spec(spec_t)
    spec_t.loader.exec_module(test)
    backends = ("pallas_fused_step", "pallas")
    cfgs = {b: ddpg.DDPGConfig(backend=b, qat_delay=100, qat_enabled=True, fxp_weights=True) for b in backends}
    batches = [test._batch(100 + t, batch, None) for t in range(steps)]  # the test's `_run`
    runs = {}
    for b in backends:
        state = ddpg.init(jax.random.key(0), test.SPEC, cfgs[b])
        runs[b] = [state]
        for t in range(steps):
            state, _ = ddpg.update(state, batches[t], cfgs[b])
            runs[b].append(state)
    npf = lambda a: np.asarray(a, dtype=np.float32)  # noqa: E731

    # the param farthest apart at the end
    worst = None
    last_f, last_p = runs["pallas_fused_step"][-1], runs["pallas"][-1]
    for net in ("actor", "critic", "actor_target", "critic_target"):
        for layer, leaves in getattr(last_f, net).items():
            for leaf, v in leaves.items():
                d = np.abs(npf(v).astype(np.float64) - npf(getattr(last_p, net)[layer][leaf]))
                i = np.unravel_index(int(np.argmax(d)), d.shape)
                if worst is None or d[i] > worst[0]:
                    worst = (float(d[i]), net, layer, leaf, tuple(int(j) for j in i))
    err, net, layer, leaf, idx = worst
    trained = net.split("_")[0]
    b1 = fxp_adam.FxpAdamConfig().b1

    def grad_at(run, t):  # the Q15.16 gradient of step t (1-based) from mu, in quanta
        m1 = float(npf(getattr(run[t], f"{trained}_opt").mu[layer][leaf])[idx])
        m0 = float(npf(getattr(run[t - 1], f"{trained}_opt").mu[layer][leaf])[idx])
        return round((m1 - b1 * m0) / (1 - b1) / Q)

    grads = {b: [grad_at(runs[b], t) for t in range(1, steps + 1)] for b in backends}
    apart = [t for t in range(steps) if grads["pallas_fused_step"][t] != grads["pallas"][t]]
    out = {"reference_case": f"test_monitor_phase_tracks_pallas_path[{batch}-None]", "steps": steps,
           "max_abs": err, "quanta": err / Q, "param": f"{net}.{layer}.{leaf}{list(idx)}",
           "grad_quanta_by_step": grads, "steps_apart": [t + 1 for t in apart], "replay": {}}
    if not apart or net not in ("actor", "critic"):
        out["note"] = "no gradient parted, or not a trained net: no replay"
        print(json.dumps(out), flush=True)
        return 0
    t = apart[0]
    lp = int(layer[1:])
    bt = batches[t]
    obs_dim = int(bt["obs"].shape[-1])

    def stage(params, x, sites, acts, qat_state):
        """One net's forward through the reference's own residual launch."""
        ctx = QATContext(qat_state)
        deltas, zs = ctx.site_quant_params(sites)
        cq = qat_state.config
        L = len(acts)
        ws = tuple(params[f"l{i}"]["w"] for i in range(L))
        bs = tuple(params[f"l{i}"]["b"] for i in range(L))
        dims = (int(x.shape[-1]),) + tuple(int(w.shape[-1]) for w in ws)
        spec = rops._TrainSpec(activations=tuple(acts), dims=dims, n_bits=cq.n_bits, qat=True,
                               fxp32_phase1=cq.fxp32_phase1, interpret=True)
        phase_f = jnp.asarray(qat_state.quantized_phase).astype(jnp.float32).reshape(())
        _, _, _, yp, _, _, res, _, _ = rops._train_fwd_call(spec, phase_f, x, ws, bs, deltas, zs, True)
        qs = [npf(res[i])[:batch, :dims[i]] for i in range(L)]
        hs = [npf(res[L + i])[:batch, :dims[i + 1]] for i in range(L - 1)] + [npf(yp)[:batch, :dims[L]]]
        W = [npf(w).astype(np.float64) for w in ws]
        pre = [qs[i].astype(np.float64) @ W[i] + npf(bs[i]).astype(np.float64)[None] for i in range(L)]
        amb = []
        for i in range(L):
            if acts[i] != "relu":
                continue
            near = np.abs(pre[i]) < 1e-4
            if near.any():
                rows = np.unique(np.nonzero(near)[0])
                bound = np.zeros_like(pre[i])
                bound[rows] = _pre_bound(qs[i][rows], W[i])
                bound += 2 * U * np.abs(pre[i])
                amb += [(i, int(r), int(u), float(pre[i][r, u]), float(bound[r, u]),
                         float(np.abs(qs[i][r].astype(np.float64) * W[i][:, u]).sum()))
                        for r, u in zip(*np.nonzero(np.abs(pre[i]) <= bound))]
        return {"acts": acts, "qs": qs, "hs": hs, "W": W, "amb": amb}

    def back(st, g, gr, flip=None, stop=None):
        """float64 backward of one net from the cotangent g ± gr of its
        output; flip = (layer, row, unit) whose ReLU goes the other way.
        Returns the cotangent of its input, or (G, radius) at layer `stop`.
        Monitor phase: the Q15.16 sites' masks pass every value here."""
        for l in range(len(st["acts"]) - 1, -1, -1):
            h = st["hs"][l].astype(np.float64)
            if st["acts"][l] == "relu":
                on = h > 0
                if flip is not None and flip[0] == l:
                    on = on.copy()
                    on[flip[1], flip[2]] = ~on[flip[1], flip[2]]
                g, gr = g * on, gr * on
            elif st["acts"][l] == "tanh":
                d = 1.0 - h * h
                g, gr = g * d, gr * np.abs(d) + 3 * U * np.abs(g * d)
            if l == stop:
                return g, gr
            g, gr = g @ st["W"][l].T, gr @ np.abs(st["W"][l].T) + _chain(g, st["W"][l].T)
        return g, gr

    k, n = idx if leaf == "w" else (None, idx[0])
    for b in backends:
        s0, s1 = runs[b][t], runs[b][t + 1]
        if trained == "critic":
            x = jnp.concatenate([bt["obs"], bt["action"]], axis=-1)
            crit = stage(s0.critic, x, ddpg.CRITIC_SITES, ddpg.CRITIC_ACTS, s0.qat)
            tctx = QATContext(s0.qat)
            next_a = ddpg.actor_forward(s0.actor_target, bt["next_obs"], tctx, backend="pallas")
            q_next = ddpg.critic_forward(s0.critic_target, bt["next_obs"], next_a, tctx, backend="pallas")
            y = npf(bt["reward"] + cfgs[b].gamma * (1.0 - bt["done"]) * q_next).astype(np.float64)
            top = (2.0 / batch) * (crit["hs"][-1][:, :1].astype(np.float64) - y[:, None])
            stages = [("critic", crit)]
        else:
            act = stage(s0.actor, bt["obs"], ddpg.ACTOR_SITES, ddpg.ACTOR_ACTS, s0.qat)
            x = jnp.concatenate([bt["obs"], jnp.asarray(act["hs"][-1])], axis=-1)
            crit = stage(s1.critic, x, ddpg.CRITIC_SITES, ddpg.CRITIC_ACTS, s0.qat)  # the updated critic
            top = np.full((batch, 1), -1.0 / batch)
            stages = [("critic", crit), ("actor", act)]

        def grad(flip=None):
            g, gr = top, np.zeros_like(top)
            for name, st in stages:
                if name == trained:
                    G, Gr = back(st, g, gr, flip[1:] if flip and flip[0] == name else None, stop=lp)
                    if k is None:
                        err = _chain(G[:, n][None], np.ones((batch, 1)))[0, 0]
                        return float(G[:, n].sum()), float(Gr[:, n].sum() + err)
                    q = st["qs"][lp][:, k].astype(np.float64)
                    return float(q @ G[:, n]), float(np.abs(q) @ Gr[:, n] + _chain(q[None], G[:, n][:, None])[0, 0])
                g, gr = back(st, g, gr, flip[1:] if flip and flip[0] == name else None)
                g, gr = g[:, obs_dim:], gr[:, obs_dim:]  # the action's columns of the critic's input

        exact, radius = grad()
        edge = min(np.floor(exact / Q) + 0.5, np.ceil(exact / Q) - 0.5, key=lambda e: abs(exact / Q - e))
        flips = []
        for name, st in stages:
            for l, r, u, pre, bound, terms in st["amb"]:
                if name == trained and l < lp:
                    continue
                fl, _ = grad((name, l, r, u))
                flips.append({"net": name, "layer": l, "row": r, "unit": u, "pre_activation": pre, "bound": bound,
                              "sum_abs_terms": terms, "relu_on": bool(st["hs"][l][r, u] > 0),
                              "grad_quanta_flipped": fl / Q})
        out["replay"][b] = {"step": t + 1, "grad_quanta_exact": exact / Q, "grad_quanta_radius": radius / Q,
                            "nearest_rounding_edge_quanta": float(edge),
                            "edge_within_radius": bool(abs(exact / Q - edge) <= radius / Q),
                            "relu_within_bound": flips}
    print(json.dumps(out), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("tree", type=pathlib.Path, nargs="?")
    ap.add_argument("--label", default=None)
    ap.add_argument("--seeds", type=int, default=24)
    ap.add_argument("--reference", action="store_true", help="the JAX reference's failing case, on the CPU")
    ap.add_argument("--batch", type=int, default=200)
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args(argv)
    if args.reference:
        return reference_case(args.batch, args.steps)
    if args.tree is None:
        ap.error("TREE is required without --reference")
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
