#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--out FILE]

Run from the repository root on a machine with a CUDA card and the CUDA
toolkit.  Phases, each printing one JSON line:

  1. device   — the card's name and power limit (nvidia-smi), CUDA version,
                TF32 switched off for matmul and cuDNN;
  2. build    — nvcc builds both kernels from `src/repro_torch/csrc/`, in
                parallel, into `build/kernels/`;
  3. kernel_a — the dense-layer kernel against its plain version: the three
                actor layer shapes, B in {1, 7, 8, 32, 128, 512} (the
                serving buckets and a ragged 7), full and half precision,
                relu/tanh/none;
  4. kernel_b — the fused MLP kernel against its plain version at
                17-400-300-6, same batches, QAT off / monitor / quant phase,
                y and the site mins/maxs;
  5. serve    — the main path: a seeded random actor, ranges captured by
                monitor-phase fused forwards and frozen (Algorithm 1's
                monitor-then-freeze), then `PolicyEngine` serving 256
                threaded requests in each forced mode (fused, layer, jnp) and
                under adaptive dispatch, every reply checked against the
                plain `act_batch`.  Kernel launch counts are zeroed just
                before this phase and read just after it;
  6. times    — each kernel at the serving shapes (B in {1, 128, 512}, both
                precision phases): kernel, plain version, library yardstick
                and the least time the card could take (`bound_ms`);
  7. engine   — host wall time of synchronous `run_batch` calls per mode
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
Site mins/maxs 2e-5, and layer 0's exactly equal.
"""

from __future__ import annotations

import argparse
import json
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


def compare(got: torch.Tensor, want: torch.Tensor, tol: float, what: str) -> dict:
    """max abs/rel error of got vs want; raises past |err| <= tol + tol·|want|."""
    require(got.shape == want.shape, f"{what}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    require(bool(torch.isfinite(got).all()), f"{what}: non-finite values")
    err = (got.double() - want.double()).abs()
    limit = tol + tol * want.double().abs()
    worst = float((err / limit).max()) if err.numel() else 0.0
    out = {
        "max_abs": float(err.max()) if err.numel() else 0.0,
        "max_rel": float((err / want.double().abs().clamp_min(1e-6)).max()) if err.numel() else 0.0,
    }
    require(worst <= 1.0, f"{what}: error {out} beyond tolerance {tol}")
    return out


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

    seconds = _build.build(["fxp_dense", "fxp_mlp_fwd"])
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


def _site_operands(ws, bs, x_cal):
    """Per-site affine operands from the extrema of one monitor-phase pass."""
    from repro_torch.core import fixedpoint as fxp
    from repro_torch.kernels.fxp_mlp.ref import ref_mlp_forward
    from repro_torch.rl import ddpg

    _, mins, maxs = ref_mlp_forward(x_cal, ws, bs, None, None, activations=ddpg.ACTOR_ACTS, quant=False, qat=False)
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
    emit("times", card=dev_info["nvidia_smi"], rows=rows,
         note="device time of back-to-back calls, operands warm in L2; library_ms for fxp_dense is "
              "torch.addmm on the precomputed hi and lo limbs plus the activation; fxp_mlp_fwd has "
              "no single PyTorch call computing its function")
    return {(r["kernel"], r["batch"], r["phase"]): r for r in rows}


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
    launches = phase_serve(gen, dev)
    times = phase_times(gen, dev, dev_info)
    phase_engine_latency(gen, dev)

    kernels = []
    for name, source, replaces, shape, err, tol in (
        ("fxp_dense", "src/repro_torch/csrc/fxp_dense.cu", "src/repro/kernels/fxp_matmul/kernel.py:47",
         "chain 17-400-300-6", err_a, TOL),
        ("fxp_mlp_fwd", "src/repro_torch/csrc/fxp_mlp_fwd.cu", "src/repro/kernels/fxp_mlp/kernel.py:76",
         "17-400-300-6", max(err_b, err_b_quant), TOL_QUANT),
    ):
        row = times[(name, 512, "full" if name == "fxp_dense" else "monitor (full)")]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": err, "tolerance": tol,
            "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "shape": f"{shape}, B=512, full precision",
        })
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
