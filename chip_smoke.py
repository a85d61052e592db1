#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--out FILE]

Run from the repository root on a machine with a CUDA card and the CUDA
toolkit.  It drives the port's two main paths, policy serving (slice 1)
and DDPG training (slice 2).  Phases, each printing one JSON line:

  1. device   — the card's name and power limit (nvidia-smi), CUDA version,
                TF32 switched off for matmul and cuDNN;
  2. build    — nvcc builds the three kernel libraries from
                `src/repro_torch/csrc/`, in parallel, into `build/kernels/`;
  3. kernel_a — the dense-layer kernel against its plain version: the three
                actor layer shapes, B in {1, 7, 8, 32, 128, 512} (the
                serving buckets and a ragged 7), full and half precision,
                relu/tanh/none;
  4. kernel_b — the fused MLP kernel against its plain version at
                17-400-300-6, same batches, QAT off / monitor / quant phase,
                y and the site mins/maxs;
  5. kernel_b_res — kernel B with the training residuals against the plain
                version's: qs, hs, y and the site mins/maxs at 17-400-300-6
                and 23-400-300-1, B in {1, 7, 128, 256}, QAT off / monitor /
                quant; y bitwise the same as without residuals;
  6. kernel_bwd — kernel 3 (the fused backward) against its plain version on
                the same residuals: dx, dW, db at the same shapes and
                phases; two calls on the same inputs bitwise equal;
  7. serve    — serving main path: a seeded random actor, ranges captured by
                monitor-phase fused forwards and frozen (Algorithm 1's
                monitor-then-freeze), then `PolicyEngine` serving 256
                threaded requests in each forced mode (fused, layer, jnp) and
                under adaptive dispatch, every reply checked against the
                plain `act_batch`.  Kernel launch counts are zeroed just
                before this phase and read just after it;
  8. update   — one `ddpg.update(backend="pallas")` on the card against the
                same update by the plain versions on the CPU, from the same
                state, at B = 128, in the monitor and the quant phase;
  9. train    — training main path: `rl.loop.train_host` on the paper's
                configuration (`configs/fixar_ddpg.CONFIG`: halfcheetah,
                actor 17-400-300-6, critic 23-400-300-1, B = 128) cut to
                2000 env steps, updates from step 1000, the QAT delay at 40 %
                of the updates (400, `qat_delay_frac`); then `evaluate` (2 episodes) and 64
                requests served from the trained actor through
                `PolicyEngine.from_ddpg`.  Launch counts are zeroed just
                before `train_host` and read just after it: kernel B must
                show 5 per update + 1 per env step, kernel 3 3 per update;
 10. profile  — `torch.profiler` over 20 updates at B = 128: host wall and
                device busy time per update (so the device's idle share),
                kernels and CUDA runtime calls per update, the costliest
                kernels and host ops;
 11. times    — each kernel at the main paths' shapes: kernels A and B at
                the serving shapes (B in {1, 128, 512}, both precision
                phases), kernel B with residuals and kernel 3 at B = 128 for
                the actor and the critic, both phases: kernel, plain
                version, library yardstick and the least time the card
                could take (`bound_ms`);
 12. engine   — host wall time of synchronous `run_batch` calls per mode
                and batch (the engine's own cost, without queueing).

Then the `{"kernels": [...]}` line and, last, the status line
`{"ok": true, "device": {...}}`.  Any failed build, launch or comparison
raises, so the run exits non-zero before the status line.  Without a CUDA
device, or without the repository's `src/repro_torch` beside this file, it
exits non-zero at once and prints no result.

Tolerances: kernel A, and kernel B with QAT off or in the monitor phase,
rtol = atol = 2e-5 (the reference's fused-forward contract; sums run in
another order).  Kernel B in the quant phase, and the serving replies of the
quantized frozen actor, 1e-3: one ulp at a site input can flip one 16-bit
affine code, which then propagates (the reference's quant-phase contract).
Site mins/maxs 2e-5, and layer 0's exactly equal.  The residuals qs are
held bitwise to what the kernel's own layer inputs (x, then its own
hs[l-1]) project to, as bf16 hi limbs in the quant phase; against the plain
version, qs[l > 0] in the quant phase is held at rtol 2⁻⁷ (one bf16 ulp) /
atol 1e-3, since where an upstream code flips the limb can round to the
neighbouring bf16 value, and its error is reported apart.  Kernel 3: rtol 2e-4 /
atol 2e-5 with QAT off or in the monitor phase, 5e-3 / 2e-2 in the quant
phase (the reference's gradient contract, `tests/kernels/
test_fxp_mlp_grad.py:91`).  One update, card against CPU: losses rtol 1e-4
/ atol 1e-5, nets rtol 1e-4 / atol 2e-5 (`test_fxp_mlp_grad.py:187-190`).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import pathlib
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

REPO = pathlib.Path(__file__).resolve().parent
SRC = REPO / "src"

ACTOR_DIMS = (17, 400, 300, 6)
CHECK_BATCHES = (1, 7, 8, 32, 128, 512)  # the serving buckets, and a ragged 7
TIME_BATCHES = (1, 128, 512)
TOL = 2e-5
TOL_QUANT = 1e-3
CRITIC_DIMS = (23, 400, 300, 1)
NETS = {"actor": (ACTOR_DIMS, ("relu", "relu", "tanh")), "critic": (CRITIC_DIMS, ("relu", "relu", "none"))}
TRAIN_BATCHES = (1, 7, 128, 256)
QS_RTOL_QUANT = 2.0**-7  # one bf16 ulp, relative (docstring)
GRAD_TOL = {"off": (2e-4, 2e-5), "monitor": (2e-4, 2e-5), "quant": (5e-3, 2e-2)}  # (rtol, atol)
# The train phase runs the paper's configuration, `configs/fixar_ddpg.CONFIG`,
# cut in length only (listed in its report under "reduced").
TRAIN_CUT = dict(total_steps=2000, warmup_steps=1000, eval_episodes=2, requests=64)
REQUESTS_PER_MODE = 256
CLIENT_THREADS = 8

# Data-sheet peaks by part (NVIDIA data sheets): f32 outside the tensor
# cores, and device-memory bytes/s.  Matched against the name the card
# reports, most specific first.
PEAKS = (
    ("H100 PCIe", 51.2e12, 2.0e12),
    ("H100 NVL", 60.0e12, 3.9e12),
    ("H100", 67.0e12, 3.35e12),
    ("H200", 67.0e12, 4.8e12),
)


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def compare(got: torch.Tensor, want: torch.Tensor, tol: float, what: str, atol: float | None = None) -> dict:
    """max abs/rel error of got vs want; raises past |err| <= atol + tol·|want|
    (atol = tol unless given)."""
    require(got.shape == want.shape, f"{what}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    require(bool(torch.isfinite(got).all()), f"{what}: non-finite values")
    got, want = got.detach().to(want.device), want.detach()
    err = (got.double() - want.double()).abs()
    limit = (tol if atol is None else atol) + tol * want.double().abs()
    worst = float((err / limit).max()) if err.numel() else 0.0
    out = {
        "max_abs": float(err.max()) if err.numel() else 0.0,
        "max_rel": float((err / want.double().abs().clamp_min(1e-6)).max()) if err.numel() else 0.0,
    }
    require(worst <= 1.0, f"{what}: error {out} beyond tolerance {tol}")
    return out


def sync(dev) -> None:
    """Wait for the card (a no-op for a CPU rehearsal of a phase)."""
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def peaks(name: str) -> tuple[float, float, str]:
    for part, flops, bw in PEAKS:
        if part in name:
            return flops, bw, part
    return PEAKS[2][1], PEAKS[2][2], "H100 SXM (assumed: part not recognised)"


def device_time_ms(fn, iters: int, reps: int = 5) -> float:
    """Median over `reps` of the mean device time of `iters` back-to-back
    calls.  A sleep kernel queued first lets the host enqueue every call
    before the first one runs, so host launch overhead does not set the
    time.  Inputs and weights stay warm in L2, as in serving."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(100_000_000)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        per_call.append(start.elapsed_time(end) / iters)
    return statistics.median(per_call)


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------


def phase_device() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    flops, bw, part = peaks(name)
    info = {
        "nvidia_smi": smi,
        "name": name,
        "count": torch.cuda.device_count(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
        "peak_f32_flops": flops,
        "peak_bytes_per_s": bw,
        "peak_part": part,
    }
    emit("device", **info)
    return info


def phase_build() -> None:
    from repro_torch.kernels import _build

    seconds = _build.build(["fxp_dense", "fxp_mlp_fwd", "fxp_mlp_bwd"])
    ptxas = {}
    for name in seconds:
        log = _build.log_path(name)
        lines = log.read_text().splitlines() if log.exists() else []
        ptxas[name] = [ln.strip() for ln in lines if "registers" in ln or "spill" in ln]
    emit("build", seconds=seconds, ptxas=ptxas, flags=list(_build.NVCC_FLAGS))


def _layer_operands(gen: torch.Generator, dev) -> list:
    from repro_torch.rl import ddpg

    actor = ddpg.init_actor(ACTOR_DIMS[0], ACTOR_DIMS[-1], generator=gen, device=dev)
    return [(actor[f"l{i}"]["w"], actor[f"l{i}"]["b"]) for i in range(len(ACTOR_DIMS) - 1)]


def phase_kernel_a(gen: torch.Generator, dev) -> float:
    from repro_torch.kernels.fxp_matmul.kernel import fxp_dense_cuda
    from repro_torch.kernels.fxp_matmul.ref import ref_fxp_dense

    worst = {"max_abs": 0.0, "max_rel": 0.0}
    cases = 0
    for w, b in _layer_operands(gen, dev):
        k = w.shape[0]
        for batch in CHECK_BATCHES:
            x = (torch.randn(batch, k, generator=gen) * 2).to(dev)
            for full in (True, False):
                for act in ("relu", "tanh", "none"):
                    for bias in (b, None) if act == "none" else (b,):
                        got = fxp_dense_cuda(x, w, bias, full_precision=full, activation=act)
                        want = ref_fxp_dense(x, w, bias, full_precision=full, activation=act)
                        torch.cuda.synchronize()
                        e = compare(got, want, TOL, f"kernel A {tuple(w.shape)} B={batch} full={full} {act}")
                        worst = {key: max(worst[key], e[key]) for key in worst}
                        cases += 1
    emit("kernel_a", cases=cases, tolerance=TOL, **worst)
    return worst["max_abs"]


def _site_operands(ws, bs, x_cal, acts=NETS["actor"][1]):
    """Per-site affine operands from the extrema of one monitor-phase pass."""
    from repro_torch.core import fixedpoint as fxp
    from repro_torch.kernels.fxp_mlp.ref import ref_mlp_forward

    _, mins, maxs = ref_mlp_forward(x_cal, ws, bs, None, None, activations=acts, quant=False, qat=False)
    deltas, zs = fxp.affine_params(mins, maxs, 16)
    return deltas.contiguous(), zs.to(torch.float32).contiguous()


def phase_kernel_b(gen: torch.Generator, dev) -> tuple[float, float]:
    from repro_torch.kernels.fxp_mlp.kernel import fxp_mlp_fwd_cuda
    from repro_torch.kernels.fxp_mlp.ref import ref_mlp_forward
    from repro_torch.rl import ddpg

    layers = _layer_operands(gen, dev)
    ws, bs = [w for w, _ in layers], [b for _, b in layers]
    deltas, zs = _site_operands(ws, bs, (torch.randn(512, ACTOR_DIMS[0], generator=gen) * 2).to(dev))
    worst = {"off": 0.0, "monitor": 0.0, "quant": 0.0, "minmax": 0.0}
    for batch in CHECK_BATCHES:
        x = (torch.randn(batch, ACTOR_DIMS[0], generator=gen) * 2).to(dev)
        for case in ("off", "monitor", "quant"):
            qat, quant = case != "off", case == "quant"
            kw = dict(activations=ddpg.ACTOR_ACTS, quant=quant, qat=qat, n_bits=16, fxp32_phase1=True)
            y, bmins, bmaxs = fxp_mlp_fwd_cuda(x, ws, bs, deltas if qat else None, zs if qat else None, **kw)
            y_ref, mins_ref, maxs_ref = ref_mlp_forward(x, ws, bs, deltas, zs, **kw)
            torch.cuda.synchronize()
            tag = f"kernel B B={batch} {case}"
            require(bmins.shape == (-(-batch // (1 if batch == 1 else 8)), 3), f"{tag}: mins shape {bmins.shape}")
            e = compare(y, y_ref, TOL_QUANT if quant else TOL, f"{tag} y")
            worst[case] = max(worst[case], e["max_abs"])
            mins, maxs = bmins.amin(0), bmaxs.amax(0)
            require(
                float(mins[0]) == float(mins_ref[0]) and float(maxs[0]) == float(maxs_ref[0]),
                f"{tag}: layer-0 extrema {float(mins[0])}, {float(maxs[0])} != "
                f"{float(mins_ref[0])}, {float(maxs_ref[0])}",
            )
            for got, want, what in ((mins, mins_ref, "mins"), (maxs, maxs_ref, "maxs")):
                worst["minmax"] = max(worst["minmax"], compare(got, want, TOL, f"{tag} {what}")["max_abs"])
    emit("kernel_b", tolerance={"off": TOL, "monitor": TOL, "quant": TOL_QUANT, "minmax": TOL}, max_abs=worst)
    return max(worst["off"], worst["monitor"], worst["minmax"]), worst["quant"]


def _net_operands(gen: torch.Generator, dev, net: str):
    """A seeded random actor or critic and its site operands."""
    from repro_torch.rl import ddpg

    dims, acts = NETS[net]
    params = ddpg._init_mlp(gen, list(dims), True, dev)
    ws = [params[f"l{i}"]["w"] for i in range(len(dims) - 1)]
    bs = [params[f"l{i}"]["b"] for i in range(len(dims) - 1)]
    deltas, zs = _site_operands(ws, bs, (torch.randn(512, dims[0], generator=gen) * 2).to(dev), acts)
    return dims, acts, ws, bs, deltas, zs


def _case_kw(acts, case: str) -> dict:
    return dict(activations=acts, quant=case == "quant", qat=case != "off", n_bits=16, fxp32_phase1=True)


def _qs_of_own_inputs(x, hs, deltas, zs, kw) -> list:
    """What kernel B must store as qs, bitwise: each layer's input (x, then
    the kernel's own hs[l-1]) through the site projection, as its bf16 hi
    limb in the quant phase."""
    from repro_torch.kernels.fxp_matmul.ref import limb_split
    from repro_torch.kernels.fxp_mlp.ref import site_project

    out = []
    for i, v in enumerate([x, *hs[:-1]]):
        if kw["qat"]:
            v = site_project(v, kw["quant"], deltas[i], zs[i], n_bits=kw["n_bits"], fxp32_phase1=kw["fxp32_phase1"])
        out.append(limb_split(v, with_lo=False)[0] if kw["quant"] else v)
    return out


def phase_kernel_b_res(gen: torch.Generator, dev) -> tuple[float, float]:
    """Kernel B's residual mode against `ref_mlp_forward(save_residuals=True)`;
    returns the worst error of y, hs and the extrema, and that of qs."""
    from repro_torch.kernels.fxp_mlp.kernel import fxp_mlp_fwd_cuda
    from repro_torch.kernels.fxp_mlp.ref import ref_mlp_forward

    worst = {"off": 0.0, "monitor": 0.0, "quant": 0.0}
    worst_qs = {"off": 0.0, "monitor": 0.0, "quant": 0.0}
    cases = 0
    for net in NETS:
        dims, acts, ws, bs, deltas, zs = _net_operands(gen, dev, net)
        for batch in TRAIN_BATCHES:
            x = (torch.randn(batch, dims[0], generator=gen) * 2).to(dev)
            for case in ("off", "monitor", "quant"):
                kw = _case_kw(acts, case)
                d, z = (deltas, zs) if kw["qat"] else (None, None)
                tol = TOL_QUANT if kw["quant"] else TOL
                tag = f"kernel B residuals {net} B={batch} {case}"
                y0, _, _ = fxp_mlp_fwd_cuda(x, ws, bs, d, z, **kw)
                y, bmins, bmaxs, qs, hs = fxp_mlp_fwd_cuda(x, ws, bs, d, z, save_residuals=True, **kw)
                y_ref, mins_ref, maxs_ref, qs_ref, hs_ref = ref_mlp_forward(x, ws, bs, deltas, zs, save_residuals=True,
                                                                            **kw)
                torch.cuda.synchronize()
                require(torch.equal(y, y0), f"{tag}: y differs from the run without residuals")
                require(len(qs) == len(hs) == len(ws) and hs[-1] is y, f"{tag}: residual lists")
                for i, (got, want) in enumerate(zip(qs, _qs_of_own_inputs(x, hs, d, z, kw))):
                    require(not kw["quant"] or torch.equal(got, got.bfloat16().float()),
                            f"{tag}: qs {i} is not bf16-exact in the quant phase")
                    require(torch.equal(got, want), f"{tag}: qs {i} is not the projection of the kernel's own input")
                require(torch.equal(qs[0], qs_ref[0]), f"{tag}: qs[0] (the projected input) not bitwise equal")
                err = 0.0
                for i, (got, want) in enumerate(zip([y, *hs[:-1]], [y_ref, *hs_ref[:-1]])):
                    err = max(err, compare(got, want, tol, f"{tag} y/hs {i}")["max_abs"])
                for got, want, what in ((bmins.amin(0), mins_ref, "mins"), (bmaxs.amax(0), maxs_ref, "maxs")):
                    err = max(err, compare(got, want, TOL, f"{tag} {what}")["max_abs"])
                q_rtol, q_atol = (QS_RTOL_QUANT, TOL_QUANT) if kw["quant"] else (TOL, TOL)
                for i, (got, want) in enumerate(zip(qs[1:], qs_ref[1:])):
                    e = compare(got, want, q_rtol, f"{tag} qs {i + 1}", atol=q_atol)["max_abs"]
                    worst_qs[case] = max(worst_qs[case], e)
                worst[case] = max(worst[case], err)
                cases += 1
    emit("kernel_b_res", cases=cases, tolerance={"off": TOL, "monitor": TOL, "quant": TOL_QUANT},
         max_abs=worst, qs_tolerance={"off": TOL, "monitor": TOL, "quant": {"rtol": QS_RTOL_QUANT, "atol": TOL_QUANT}},
         qs_max_abs=worst_qs, qs_bitwise_projection_of_own_inputs=True,
         y_bitwise_with_and_without_residuals=True)
    return max(worst.values()), max(worst_qs.values())


def phase_kernel_bwd(gen: torch.Generator, dev) -> float:
    """Kernel 3 against `ref_mlp_backward` on the kernel's own residuals."""
    from repro_torch.kernels.fxp_mlp.kernel import fxp_mlp_bwd_cuda, fxp_mlp_fwd_cuda
    from repro_torch.kernels.fxp_mlp.ref import ref_mlp_backward

    worst = {"off": 0.0, "monitor": 0.0, "quant": 0.0}
    cases = 0
    for net in NETS:
        dims, acts, ws, bs, deltas, zs = _net_operands(gen, dev, net)
        for batch in TRAIN_BATCHES:
            x = (torch.randn(batch, dims[0], generator=gen) * 2).to(dev)
            g = torch.randn(batch, dims[-1], generator=gen).to(dev)
            for case in ("off", "monitor", "quant"):
                kw = _case_kw(acts, case)
                d, z = (deltas, zs) if kw["qat"] else (None, None)
                rtol, atol = GRAD_TOL[case]
                tag = f"kernel 3 {net} B={batch} {case}"
                _, _, _, qs, hs = fxp_mlp_fwd_cuda(x, ws, bs, d, z, save_residuals=True, **kw)
                dx, dws, dbs = fxp_mlp_bwd_cuda(g, x, ws, qs, hs, d, z, **kw)
                dx2, dws2, dbs2 = fxp_mlp_bwd_cuda(g, x, ws, qs, hs, d, z, **kw)
                rdx, rdws, rdbs = ref_mlp_backward(g, x, ws, qs, hs, deltas, zs, **kw)
                torch.cuda.synchronize()
                for a, b2 in zip([dx, *dws, *dbs], [dx2, *dws2, *dbs2]):
                    require(torch.equal(a, b2), f"{tag}: two launches on the same inputs differ")
                err = 0.0
                names = ["dx"] + [f"dW{i}" for i in range(len(ws))] + [f"db{i}" for i in range(len(ws))]
                for got, want, what in zip([dx, *dws, *dbs], [rdx, *rdws, *rdbs], names):
                    err = max(err, compare(got, want, rtol, f"{tag} {what}", atol=atol)["max_abs"])
                worst[case] = max(worst[case], err)
                cases += 1
    emit("kernel_bwd", cases=cases, tolerance={c: {"rtol": r, "atol": a} for c, (r, a) in GRAD_TOL.items()},
         max_abs=worst, bitwise_repeat=True, cuda_launches_per_call=2)
    return max(worst.values())


def _paper_ddpg(qat_delay: int):
    """The paper's DDPG settings (`CONFIG.ddpg`: B = 128, Adam lr 1e-4,
    Q15.16 weights, 16-bit QAT) on the "pallas" backend, the QAT delay at
    `qat_delay` updates."""
    from repro_torch.configs.fixar_ddpg import CONFIG

    return dataclasses.replace(CONFIG.ddpg, backend="pallas", qat_delay=qat_delay)


def _random_batch(gen: torch.Generator, dev, spec, n: int) -> dict:
    return {
        "obs": torch.randn(n, spec.obs_dim, generator=gen).to(dev),
        "action": (torch.rand(n, spec.act_dim, generator=gen) * 2 - 1).to(dev),
        "reward": torch.randn(n, generator=gen).to(dev),
        "next_obs": torch.randn(n, spec.obs_dim, generator=gen).to(dev),
        "done": (torch.rand(n, generator=gen) < 0.05).to(dev),
    }


def phase_update(gen: torch.Generator, dev) -> dict:
    """One `ddpg.update(backend="pallas")` on the card against the same
    update by the plain versions on the CPU, in the monitor phase and in
    the quant phase (Adam moments warm from earlier updates)."""
    from repro_torch.rl import ddpg
    from repro_torch.rl.envs import make

    spec = make("halfcheetah").spec
    cfg = _paper_ddpg(3)
    state = ddpg.init(spec, cfg, generator=gen, device=dev)
    report = {}
    for i in range(4):
        batch = _random_batch(gen, dev, spec, cfg.batch_size)
        phase = "quant" if bool(state.qat.quantized_phase) else "monitor"
        compared = i >= 2
        if compared:
            cpu_state, cpu_batch = state.to("cpu"), {k: v.cpu() for k, v in batch.items()}
        new_state, metrics = ddpg.update(state, batch, cfg)
        sync(dev)
        if compared:
            want_state, want_metrics = ddpg.update(cpu_state, cpu_batch, cfg)
            errs = {}
            for k in want_metrics:
                errs[k] = compare(metrics[k].reshape(1), want_metrics[k].reshape(1), 1e-4, f"update {phase} {k}",
                                  atol=1e-5)["max_abs"]
            for name in ("actor", "critic", "actor_target", "critic_target"):
                got_net, want_net = getattr(new_state, name), getattr(want_state, name)
                errs[name] = max(
                    compare(got_net[layer][leaf], want_net[layer][leaf], 1e-4, f"update {phase} {name}/{layer}/{leaf}",
                            atol=2e-5)["max_abs"]
                    for layer in want_net for leaf in want_net[layer]
                )
            require(int(new_state.qat.step) == int(want_state.qat.step), f"update {phase}: QAT steps differ")
            report[phase] = {"max_abs": errs, "losses": {k: float(v) for k, v in metrics.items()}}
        state = new_state
    require(set(report) == {"monitor", "quant"}, f"update compared phases {sorted(report)}")
    emit("update", batch=cfg.batch_size, tolerance={"losses": {"rtol": 1e-4, "atol": 1e-5},
                                                     "nets": {"rtol": 1e-4, "atol": 2e-5}}, **report)
    return report


def phase_train(gen: torch.Generator, dev, seed: int) -> dict:
    """The training main path (module docstring), with the launch counts of
    the `train_host` run and its throughput."""
    from repro_torch.configs.fixar_ddpg import CONFIG
    from repro_torch.kernels.fxp_mlp.kernel import fxp_mlp_bwd_cuda, fxp_mlp_fwd_cuda
    from repro_torch.obs import Tracer
    from repro_torch.rl import ddpg, loop
    from repro_torch.rl.envs import make
    from repro_torch.serve.policy import BatcherConfig, PolicyEngine

    env = make(CONFIG.env)
    cfg = loop.TrainConfig(total_steps=TRAIN_CUT["total_steps"], warmup_steps=TRAIN_CUT["warmup_steps"],
                           replay_capacity=100_000, seed=seed)
    # the paper's delay falls at `qat_delay_frac` of the run; here, of its updates
    qat_delay = round(CONFIG.qat_delay_frac * (cfg.total_steps - cfg.warmup_steps + 1))
    dcfg = _paper_ddpg(qat_delay)
    reduced = {
        "total_steps": [CONFIG.total_steps, cfg.total_steps],
        "qat_delay": f"{CONFIG.qat_delay_frac} of the updates: {qat_delay}",
        "eval": f"{TRAIN_CUT['eval_episodes']} episodes once at the end (the paper: 10 every 5000 steps)",
    }
    tracer = Tracer()
    fxp_mlp_fwd_cuda.launches = 0
    fxp_mlp_bwd_cuda.launches = 0
    t0 = time.perf_counter()
    ts, info = loop.train_host(env, cfg, dcfg, device=dev, tracer=tracer)
    sync(dev)
    wall = time.perf_counter() - t0
    launches = {"fxp_mlp_fwd": fxp_mlp_fwd_cuda.launches, "fxp_mlp_bwd": fxp_mlp_bwd_cuda.launches}
    agent = ts.agent
    updates = int(agent.step)
    steps = cfg.total_steps * max(cfg.n_envs, 1)
    require(updates == cfg.total_steps - cfg.warmup_steps + 1, f"train: {updates} updates")
    want = {"fxp_mlp_fwd": 5 * updates + cfg.total_steps, "fxp_mlp_bwd": 3 * updates}
    require(launches == want, f"train: launches {launches}, expected {want}")
    phase = "quant" if bool(agent.qat.quantized_phase) else "monitor"
    require(phase == "quant" and int(agent.qat.step) == updates, f"train ended in the {phase} phase")
    for name in ("actor", "critic"):
        for layer in getattr(agent, name).values():
            require(all(bool(torch.isfinite(t).all()) for t in layer.values()), f"train: non-finite {name} params")
    # steady state: the timesteps that update (act, env, replay, update each)
    first = cfg.warmup_steps - 1
    spans = [e for e in tracer.events() if e["args"]["step"] >= first]
    upd = [e["dur"] / 1e6 for e in spans if e["name"] == "loop.update"]
    steady_s = (max(e["ts"] + e["dur"] for e in spans) - min(e["ts"] for e in spans)) / 1e6
    reward = float(loop.evaluate(env, agent, dcfg, torch.Generator(device=dev).manual_seed(seed + 7), TRAIN_CUT["eval_episodes"]))
    require(math.isfinite(reward), f"train: evaluate returned {reward}")

    engine = PolicyEngine.from_ddpg(agent, device=dev, batcher=BatcherConfig(max_wait_ms=2.0))
    require(engine.frozen is not None and engine.frozen.quantized, "the served actor must be frozen in the quant phase")
    engine.warmup()
    obs = (torch.randn(TRAIN_CUT["requests"], env.spec.obs_dim, generator=gen) * 2).numpy()
    engine.start()
    try:
        replies = _serve_threaded(engine, obs)
    finally:
        engine.stop()
    engine.close()
    want_act = ddpg.act(agent.to("cpu"), torch.from_numpy(obs), cfg=dcfg).numpy()
    serve_err = float(np.abs(replies - want_act).max())
    require(serve_err <= TOL_QUANT, f"served actions off the trained actor's by {serve_err}")
    report = {
        "env": env.spec.name, "batch": dcfg.batch_size, "reduced": reduced, "env_steps": steps,
        "updates": updates, "qat_delay": qat_delay, "phase_at_end": phase, "wall_s": wall,
        "env_steps_per_s": steps / wall, "updates_per_s": updates / wall,
        "update_ms_p50": statistics.median(upd) * 1e3, "updates_per_s_update_only": len(upd) / sum(upd),
        "steady_steps_per_s": len(upd) / steady_s,
        "times": info["times"], "launches": launches, "launches_expected": want,
        "cuda_launches": {"fxp_mlp_fwd": launches["fxp_mlp_fwd"], "fxp_mlp_bwd": 2 * launches["fxp_mlp_bwd"]},
        "eval_reward": reward, "eval_episodes": TRAIN_CUT["eval_episodes"], "served": len(replies),
        "serve_max_abs_err": serve_err,
    }
    emit("train", **report)
    return report


def phase_profile(gen: torch.Generator, dev, updates: int = 20) -> dict:
    """Where an update's time goes: `torch.profiler` over `updates` calls
    of `ddpg.update(backend="pallas")` at B = 128 (the QAT delay halfway, so
    both phases): host wall per update, device busy time per update (the
    sum of kernel times) and so the device's idle share, kernels and CUDA
    runtime calls per update, and the kernels and CPU ops that take the
    most time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.rl import ddpg
    from repro_torch.rl.envs import make

    spec = make("halfcheetah").spec
    cfg = _paper_ddpg(3 + updates // 2)
    state = ddpg.init(spec, cfg, generator=gen, device=dev)
    batches = [_random_batch(gen, dev, spec, cfg.batch_size) for _ in range(updates + 3)]
    for b in batches[:3]:
        state, _ = ddpg.update(state, b, cfg)
    sync(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches[3:]:
            state, _ = ddpg.update(state, b, cfg)
        sync(dev)
        wall = time.perf_counter() - t0
    require(bool(state.qat.quantized_phase), "profile: the QAT delay was not crossed")

    def dev_us(e) -> float:
        return float(getattr(e, "self_device_time_total", 0.0) or getattr(e, "self_cuda_time_total", 0.0))

    events = prof.key_averages()
    kernels = [e for e in events if str(e.device_type).endswith("CUDA")]
    device_us = sum(dev_us(e) for e in kernels)
    runtime = sorted((e for e in events if e.key.startswith("cuda")), key=lambda e: -e.count)
    host_ops = sorted((e for e in events if not str(e.device_type).endswith("CUDA")),
                      key=lambda e: -e.self_cpu_time_total)
    per = 1.0 / updates
    report = {
        "updates": updates, "batch": cfg.batch_size, "wall_ms_per_update": wall * 1e3 * per,
        "device_busy_ms_per_update": device_us / 1e3 * per if device_us else None,
        "device_idle_share": 1.0 - device_us / 1e6 / wall if device_us else None,
        "kernels_per_update": sum(e.count for e in kernels) * per,
        "runtime_calls_per_update": {e.key: e.count * per for e in runtime[:8]},
        "top_kernels_ms_per_update": {e.key[:60]: dev_us(e) / 1e3 * per
                                      for e in sorted(kernels, key=lambda e: -dev_us(e))[:8]},
        "top_host_ops_ms_per_update": {e.key[:60]: e.self_cpu_time_total / 1e3 * per for e in host_ops[:10]},
        "note": "the profiler's own cost is in the wall time; device time is the sum of kernel times",
    }
    emit("profile", **report)
    return report


def _calibrate(actor, gen, dev, batches: int = 4):
    """Algorithm 1's monitor-then-freeze flow: monitor-phase fused forwards
    on seeded calibration batches, extrema folded into the range monitors,
    one tick past the delay, then freeze."""
    from repro_torch.core.qat import QATState, freeze_quant
    from repro_torch.core.ranges import update_minmax_scalar
    from repro_torch.kernels.fxp_mlp.ops import fxp_mlp_forward
    from repro_torch.rl import ddpg

    state = QATState.init(delay=1, sites=ddpg.ACTOR_SITES, device=dev)
    ws = [actor[f"l{i}"]["w"] for i in range(3)]
    bs = [actor[f"l{i}"]["b"] for i in range(3)]
    for _ in range(batches):
        monitor = freeze_quant(state, ddpg.ACTOR_SITES)
        require(not monitor.quantized, "calibration must run in the monitor phase")
        x = (torch.randn(512, ACTOR_DIMS[0], generator=gen) * 2).to(dev)
        _, mns, mxs = fxp_mlp_forward(
            x, ws, bs, monitor.deltas, monitor.zs, activations=ddpg.ACTOR_ACTS,
            quant_phase=monitor.quantized, n_bits=monitor.n_bits, fxp32_phase1=monitor.fxp32_phase1,
        )
        for j, site in enumerate(ddpg.ACTOR_SITES):
            state.ranges[site] = update_minmax_scalar(state.ranges[site], mns[j], mxs[j])
    state = state.tick()
    frozen = freeze_quant(state, ddpg.ACTOR_SITES)
    require(frozen.quantized, "frozen snapshot must be in the quantized phase")
    return frozen


def _serve_threaded(engine, obs: np.ndarray) -> np.ndarray:
    """Submit every row from CLIENT_THREADS client threads; return replies
    in row order."""
    futures = [None] * len(obs)
    errors = []

    def client(rows):
        try:
            for i in rows:
                futures[i] = engine.submit(obs[i])
        except BaseException as err:  # relayed to the main thread below
            errors.append(err)
            raise

    threads = [
        threading.Thread(target=client, args=(range(t, len(obs), CLIENT_THREADS),))
        for t in range(CLIENT_THREADS)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        require(not t.is_alive(), "client thread did not finish")
    require(not errors, f"client error: {errors[:1]}")
    return np.stack([f.result(timeout=120) for f in futures])


def phase_serve(gen: torch.Generator, dev) -> dict:
    from repro_torch.kernels.fxp_matmul.kernel import fxp_dense_cuda
    from repro_torch.kernels.fxp_mlp.kernel import fxp_mlp_fwd_cuda
    from repro_torch.rl import ddpg
    from repro_torch.serve.policy import BatcherConfig, PolicyEngine

    fxp_dense_cuda.launches = 0
    fxp_mlp_fwd_cuda.launches = 0

    actor = ddpg.init_actor(ACTOR_DIMS[0], ACTOR_DIMS[-1], generator=gen, device=dev)
    frozen = _calibrate(actor, gen, dev)
    actor_cpu = {k: {n: t.cpu() for n, t in v.items()} for k, v in actor.items()}
    frozen_cpu = frozen.to("cpu")

    def plain(obs: np.ndarray, mode: str) -> torch.Tensor:
        return ddpg.act_batch(actor_cpu, torch.from_numpy(obs), frozen_cpu, mode=mode)

    report = {"frozen": {"a_mins": frozen.a_mins.tolist(), "a_maxs": frozen.a_maxs.tolist()}}
    per_run = {"fused": (1, 0), "layer": (0, 3), "jnp": (0, 0)}  # (B launches, A launches)
    for mode in ("fused", "layer", "jnp", None):
        label = mode or "adaptive"
        engine = PolicyEngine(actor, frozen, device=dev, force_mode=mode, batcher=BatcherConfig(max_wait_ms=2.0))
        engine.warmup()
        if mode is not None:
            obs = (torch.randn(7, ACTOR_DIMS[0], generator=gen) * 2).numpy()
            before = (fxp_mlp_fwd_cuda.launches, fxp_dense_cuda.launches)
            got = engine.run_batch(obs)
            after = (fxp_mlp_fwd_cuda.launches, fxp_dense_cuda.launches)
            require(
                (after[0] - before[0], after[1] - before[1]) == per_run[mode],
                f"{mode}: one run_batch launched {after[0] - before[0]} fused and "
                f"{after[1] - before[1]} dense kernels, expected {per_run[mode]}",
            )
            compare(torch.from_numpy(got), plain(obs, mode), TOL_QUANT, f"serve {label} run_batch")
            candidates = (mode,)
        else:
            candidates = tuple(sorted({engine.choose_mode(b) for b in engine.batcher_config.buckets}))
            for b in (1, 512):
                x = (torch.randn(b, ACTOR_DIMS[0], generator=gen) * 2).numpy()
                compare(torch.from_numpy(engine.run_batch(x)), plain(x, engine.choose_mode(b)),
                        TOL_QUANT, f"serve adaptive run_batch B={b}")
        # two rounds on one serve thread: the first pays the thread's cold
        # start (per-thread CUDA/cuBLAS state), the second is steady state
        report[label] = {}
        engine.start()
        try:
            for rnd in ("cold", "warm"):
                engine.reset_stats()
                obs = (torch.randn(REQUESTS_PER_MODE, ACTOR_DIMS[0], generator=gen) * 2).numpy()
                replies = _serve_threaded(engine, obs)
                tag = f"{label} {rnd}"
                require(replies.shape == (REQUESTS_PER_MODE, ACTOR_DIMS[-1]), f"{tag}: replies {replies.shape}")
                require(bool(np.isfinite(replies).all()) and bool((np.abs(replies) <= 1.0).all()),
                        f"{tag}: replies not finite actions in [-1, 1]")
                # each reply must match the plain act_batch of a mode this
                # engine dispatches to (one mode when forced)
                errs = np.min([np.abs(replies - plain(obs, m).numpy()).max(axis=1) for m in candidates], axis=0)
                require(float(errs.max()) <= TOL_QUANT, f"{tag}: reply error {float(errs.max())} > {TOL_QUANT}")
                s = engine.stats()
                require(s["requests"] == REQUESTS_PER_MODE, f"{tag}: served {s['requests']} requests")
                report[label][rnd] = {
                    "requests": s["requests"],
                    "batches": s["batches"],
                    "ips_device": s["ips_device"],
                    "ips_wall": s["ips_wall"],
                    "p50_ms": s["p50_ms"],
                    "p99_ms": s["p99_ms"],
                    "batch_occupancy": s["batch_occupancy"],
                    "mode_histogram": s["mode_histogram"],
                    "drift_factor": s["dispatch_audit"]["drift_factor"],
                    "max_abs_err": float(errs.max()),
                }
        finally:
            engine.stop()
        if mode is None:
            report[label]["qat_telemetry"] = engine.record_qat_telemetry(obs[:32])
        engine.close()
    launches = {"fxp_mlp_fwd": fxp_mlp_fwd_cuda.launches, "fxp_dense": fxp_dense_cuda.launches}
    require(all(n > 0 for n in launches.values()), f"a kernel of the main path never launched: {launches}")
    emit("serve", launches=launches, tolerance=TOL_QUANT, **report)
    return launches


def _bound_ms(bytes_moved: float, flops: float, dev_info: dict) -> tuple[float, str]:
    t_bytes = bytes_moved / dev_info["peak_bytes_per_s"]
    t_ops = flops / dev_info["peak_f32_flops"]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def phase_times(gen: torch.Generator, dev, dev_info: dict) -> dict:
    from repro_torch.kernels.fxp_matmul.kernel import fxp_dense_cuda
    from repro_torch.kernels.fxp_matmul.ref import limb_split, ref_fxp_dense
    from repro_torch.kernels.fxp_mlp.kernel import fxp_mlp_fwd_cuda
    from repro_torch.kernels.fxp_mlp.ref import ref_mlp_forward
    from repro_torch.rl import ddpg

    layers = _layer_operands(gen, dev)
    ws, bs = [w for w, _ in layers], [b for _, b in layers]
    deltas, zs = _site_operands(ws, bs, (torch.randn(512, ACTOR_DIMS[0], generator=gen) * 2).to(dev))
    acts = ddpg.ACTOR_ACTS
    act_fn = {"relu": torch.relu, "tanh": torch.tanh}
    n_params = sum(w.numel() + b.numel() for w, b in layers)
    rows = []
    for batch in TIME_BATCHES:
        x = (torch.randn(batch, ACTOR_DIMS[0], generator=gen) * 2).to(dev)
        # per-layer inputs of the chain, so each layer is timed on its own shape
        inputs = [x]
        for (w, b), a in zip(layers[:-1], acts):
            inputs.append(ref_fxp_dense(inputs[-1], w, b, activation=a))
        for full in (True, False):
            passes = 2 if full else 1
            macs = sum(batch * w.shape[0] * w.shape[1] for w in ws)

            # kernel A: the three-layer chain of the `layer` mode
            def chain_kernel():
                for xi, (w, b), a in zip(inputs, layers, acts):
                    fxp_dense_cuda(xi, w, b, full_precision=full, activation=a)

            def chain_plain():
                for xi, (w, b), a in zip(inputs, layers, acts):
                    ref_fxp_dense(xi, w, b, full_precision=full, activation=a)

            limbs = [limb_split(xi) for xi in inputs]

            def chain_library():
                for (hi, lo), (w, b), a in zip(limbs, layers, acts):
                    acc = torch.addmm(b, hi, w)
                    if full:
                        acc = torch.addmm(acc, lo, w)
                    act_fn[a](acc)

            a_bytes = 4 * sum(xi.numel() + w.numel() + b.numel() + xi.shape[0] * w.shape[1]
                              for xi, (w, b) in zip(inputs, layers))
            a_bound, a_by = _bound_ms(a_bytes, 2 * passes * macs, dev_info)
            rows.append({
                "kernel": "fxp_dense", "shape": "chain 17-400-300-6", "batch": batch,
                "phase": "full" if full else "half",
                "ms": device_time_ms(chain_kernel, 100),
                "plain_ms": device_time_ms(chain_plain, 20),
                "library_ms": device_time_ms(chain_library, 20),
                "bound_ms": a_bound, "bound_by": a_by, "launches_per_call": 3,
            })

            # kernel B: the whole network in one launch, QAT sites on
            kw = dict(activations=acts, quant=not full, qat=True, n_bits=16, fxp32_phase1=True)
            n_blocks = -(-batch // (1 if batch == 1 else 8))
            b_bytes = 4 * (x.numel() + n_params + batch * ACTOR_DIMS[-1] + 2 * len(ws) + 2 * n_blocks * len(ws))
            b_bound, b_by = _bound_ms(b_bytes, 2 * passes * macs, dev_info)
            rows.append({
                "kernel": "fxp_mlp_fwd", "shape": "17-400-300-6", "batch": batch,
                "phase": "monitor (full)" if full else "quant (half)",
                "ms": device_time_ms(lambda: fxp_mlp_fwd_cuda(x, ws, bs, deltas, zs, **kw), 100),
                "plain_ms": device_time_ms(lambda: ref_mlp_forward(x, ws, bs, deltas, zs, **kw), 20),
                "library_ms": None,
                "bound_ms": b_bound, "bound_by": b_by, "launches_per_call": 1,
            })
    # the training path's shapes: kernel B with residuals and kernel 3 at B = 128
    from repro_torch.kernels.fxp_mlp.kernel import fxp_mlp_bwd_cuda
    from repro_torch.kernels.fxp_mlp.ref import ref_mlp_backward

    batch = _paper_ddpg(0).batch_size
    for net in NETS:
        dims, nacts, nws, nbs, nd, nz = _net_operands(gen, dev, net)
        x = (torch.randn(batch, dims[0], generator=gen) * 2).to(dev)
        g = torch.randn(batch, dims[-1], generator=gen).to(dev)
        macs = batch * sum(k * n for k, n in zip(dims[:-1], dims[1:]))
        w_elems = sum(w.numel() for w in nws)
        b_elems = sum(b.numel() for b in nbs)
        res_elems = batch * (sum(dims[:-1]) + sum(dims[1:-1]))  # qs, and hs before y
        for case in ("monitor", "quant"):
            kw = _case_kw(nacts, case)
            passes = 1 if kw["quant"] else 2
            n_blocks = -(-batch // 8)
            f_bytes = 4 * (x.numel() + w_elems + b_elems + batch * dims[-1] + 2 * len(nws) + 2 * n_blocks * len(nws)
                           + res_elems)
            f_bound, f_by = _bound_ms(f_bytes, 2 * passes * macs, dev_info)
            rows.append({
                "kernel": "fxp_mlp_fwd", "shape": f"{net} {'-'.join(map(str, dims))}, residuals", "batch": batch,
                "phase": case,
                "ms": device_time_ms(lambda: fxp_mlp_fwd_cuda(x, nws, nbs, nd, nz, save_residuals=True, **kw), 100),
                "plain_ms": device_time_ms(lambda: ref_mlp_forward(x, nws, nbs, nd, nz, save_residuals=True, **kw), 20),
                "library_ms": None, "bound_ms": f_bound, "bound_by": f_by, "launches_per_call": 1,
            })
            _, _, _, qs, hs = fxp_mlp_fwd_cuda(x, nws, nbs, nd, nz, save_residuals=True, **kw)
            # read once: g, x0, W, qs, hs (with y) and deltas/zs; written once: dx, dW, db
            k_bytes = 4 * (g.numel() + x.numel() + w_elems + res_elems + batch * dims[-1] + 2 * len(nws)
                           + x.numel() + w_elems + b_elems)
            k_bound, k_by = _bound_ms(k_bytes, 4 * macs, dev_info)
            rows.append({
                "kernel": "fxp_mlp_bwd", "shape": f"{net} {'-'.join(map(str, dims))}", "batch": batch, "phase": case,
                "ms": device_time_ms(lambda: fxp_mlp_bwd_cuda(g, x, nws, qs, hs, nd, nz, **kw), 100),
                "plain_ms": device_time_ms(lambda: ref_mlp_backward(g, x, nws, qs, hs, nd, nz, **kw), 20),
                "library_ms": None, "bound_ms": k_bound, "bound_by": k_by, "launches_per_call": 1,
                "cuda_launches_per_call": 2,
            })
    emit("times", card=dev_info["nvidia_smi"], rows=rows,
         note="device time of back-to-back calls, operands warm in L2; library_ms for fxp_dense is "
              "torch.addmm on the precomputed hi and lo limbs plus the activation; fxp_mlp_fwd and "
              "fxp_mlp_bwd have no single PyTorch call computing their function (the backward is two "
              "products and three masks per layer, walked in order)")
    return {(r["kernel"], r["shape"], r["batch"], r["phase"]): r for r in rows}


def phase_engine_latency(gen: torch.Generator, dev, calls: int = 50) -> None:
    """Host wall time of one synchronous `run_batch` (pad, dispatch, copy
    in, kernels, synchronize, copy out) on the calling thread, per mode and
    batch: what the engine adds on top of the kernels, without queueing."""
    from repro_torch.rl import ddpg
    from repro_torch.serve.policy import PolicyEngine

    actor = ddpg.init_actor(ACTOR_DIMS[0], ACTOR_DIMS[-1], generator=gen, device=dev)
    frozen = _calibrate(actor, gen, dev)
    rows = []
    for mode in ("fused", "layer", "jnp"):
        engine = PolicyEngine(actor, frozen, device=dev, force_mode=mode)
        engine.warmup()
        for batch in TIME_BATCHES:
            obs = (torch.randn(batch, ACTOR_DIMS[0], generator=gen) * 2).numpy()
            for _ in range(5):
                engine.run_batch(obs)
            times = []
            for _ in range(calls):
                t0 = time.perf_counter()
                engine.run_batch(obs)
                times.append((time.perf_counter() - t0) * 1e3)
            times.sort()
            rows.append({"mode": mode, "batch": batch, "calls": calls, "p50_ms": statistics.median(times),
                         "p90_ms": times[int(0.9 * calls) - 1]})
        engine.close()
    emit("engine", rows=rows, note="host wall time of synchronous run_batch calls on the main thread")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0, help="seed of every random weight and input")
    ap.add_argument("--out", type=pathlib.Path, default=None, help="also write every phase's result here as JSON")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(args.seed)
    t0 = time.perf_counter()
    dev_info = phase_device()
    phase_build()
    err_a = phase_kernel_a(gen, dev)
    err_b, err_b_quant = phase_kernel_b(gen, dev)
    err_b_res, err_qs = phase_kernel_b_res(gen, dev)
    err_bwd = phase_kernel_bwd(gen, dev)
    serve_launches = phase_serve(gen, dev)
    phase_update(gen, dev)
    train = phase_train(gen, dev, args.seed)
    phase_profile(gen, dev)
    times = phase_times(gen, dev, dev_info)
    phase_engine_latency(gen, dev)

    by_path = {
        "fxp_dense": {"serve": serve_launches["fxp_dense"]},
        "fxp_mlp_fwd": {"serve": serve_launches["fxp_mlp_fwd"], "train": train["launches"]["fxp_mlp_fwd"]},
        "fxp_mlp_bwd": {"train": train["launches"]["fxp_mlp_bwd"]},
    }
    kernels = []
    for name, source, replaces, key, err, tol in (
        ("fxp_dense", "src/repro_torch/csrc/fxp_dense.cu", "src/repro/kernels/fxp_matmul/kernel.py:47",
         ("fxp_dense", "chain 17-400-300-6", 512, "full"), err_a, TOL),
        ("fxp_mlp_fwd", "src/repro_torch/csrc/fxp_mlp_fwd.cu", "src/repro/kernels/fxp_mlp/kernel.py:76",
         ("fxp_mlp_fwd", "17-400-300-6", 512, "monitor (full)"), max(err_b, err_b_quant, err_b_res), TOL_QUANT),
        ("fxp_mlp_bwd", "src/repro_torch/csrc/fxp_mlp_bwd.cu", "src/repro/kernels/fxp_mlp/kernel.py:223",
         ("fxp_mlp_bwd", "critic 23-400-300-1", _paper_ddpg(0).batch_size, "monitor"), err_bwd,
         {"rtol": GRAD_TOL["quant"][0], "atol": GRAD_TOL["quant"][1]}),
    ):
        row = times[key]
        entry = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(by_path[name].values()), "launches_by_path": by_path[name],
            "max_abs_err": err, "tolerance": tol,
            "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "shape": f"{key[1]}, B={key[2]}, {key[3]}",
        }
        if name == "fxp_mlp_fwd":
            entry["qs_max_abs_err"] = err_qs
            entry["qs_tolerance"] = {"rtol": QS_RTOL_QUANT, "atol": TOL_QUANT}
        if name == "fxp_mlp_bwd":
            entry["cuda_launches_per_call"] = 2
            entry["library_note"] = "no single PyTorch call computes the masked backward chain"
        kernels.append(entry)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"device": dev_info, "kernels": kernels,
                                        "times": list(times.values())}, indent=1))
    emit("done", seconds=time.perf_counter() - t0)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
