#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--out FILE]   (FILE: every phase's result as JSON)

Run from the repository root on a machine with a CUDA card and the CUDA
toolkit.  It drives the port's eight main paths: policy serving (slice
1), DDPG training through backend "pallas" (slice 2), training through
the fused whole-update step, eagerly and as a captured CUDA graph (slice
3), Algorithm 1 over the per-layer datapath with the standalone
monitor + quantizer at each site (slice 4), the learner engine that
coalesces update requests into bucket-padded batches (slice 8), policy
serving over a device mesh and the LM zoo's attention-family serving path
at full width (slice 9), and the LM zoo's MoE, RWKV-6 and RG-LRU serving
paths at full width (slice 10), LM training with QAT at full width
(slice 11), and the sharded LM code (DTensor rules, the expert-parallel
MoE dispatch) at world size 1 (slice 12), and the production dry run on the 256- and
512-rank layouts over a fake process group under fake tensors (slice 13).  Phases,
each printing one JSON line (`lm` one per model),
each line with its wall seconds since the line before:

  1. device   — the card's name and power limit (nvidia-smi), CUDA version,
                TF32 switched off for matmul and cuDNN;
  2. build    — nvcc builds the five kernel libraries from
                `src/repro_torch/csrc/`, in parallel, into `build/kernels/`;
  3. kernel_a — the dense-layer kernel against its plain version: the three
                actor layer shapes and two ragged ones (K no multiple of
                the split, N no multiple of 4), B in {1, 7, 8, 32, 128,
                512} (the serving buckets and a ragged 7) and the launch
                plans' edges {9, 16, 17, 120, 121, 511}, full and half
                precision, relu/tanh/none; two calls bitwise equal;
  4. kernel_b — the fused MLP kernel against its plain version at the actor
                17-400-300-6 and the critic 23-400-300-1, same batches,
                QAT off / monitor / quant phase, y and the site mins/maxs
                (as many rows as `monitor_rows` says); two calls bitwise
                equal; the card's cluster occupancy for the plans;
  5. kernel_b_res — kernel B with the training residuals against the plain
                version's: qs, hs, y and the site mins/maxs at 17-400-300-6
                and 23-400-300-1, B in {1, 7, 128, 256}, QAT off / monitor /
                quant; y bitwise the same as without residuals;
  6. kernel_bwd — kernel 3 (the fused backward) against its plain version on
                the same residuals: dx, dW, db at the same nets, B in
                {1, 7, 128, 256}, the launch plan's edges {8, 9, 16, 17,
                120, 121, 241, 511} and the learner's bucket 32, QAT off /
                monitor / quant; two calls on
                the same inputs bitwise equal; the actor's tanh layer's
                cotangent after the activation backward bitwise g·(1 − h·h);
  7. kernel_step — kernels 4 and 5 (the fused DDPG step) against their plain
                twins at the paper's shapes, B = 128 and a multi-block
                ragged B = 200 with 30 rows of weight 0, a standing case
                (the inputs of a ReLU decision that flipped, restored from
                `tests/data/kernel_step_relu_flip.gen`) and the chain
                passes' plan edges (B in {1, 7, 8, 9, 16, 17, 120, 121, 241,
                511}) and the learner's bucket 32, both phases: new params,
                moments, targets, site
                extrema, loss partials; two calls bitwise equal; the twin's
                step must move each tree further than its tolerance, so a
                stale tree cannot pass; the plans and the card's cluster
                occupancy for them;
  8. kernel_mq — kernel 6 (the standalone monitor + quantizer) against its
                plain version: the reference test's shapes, the paper's site
                inputs (B in {1, 7, 128, 512} × width in {17, 23, 400,
                300}), a 2^24-element sweep and a length that is not a
                multiple of the block, both phases, incoming ranges
                (−3, 3.5) and (+inf, −inf), y and both extrema bitwise; an
                input holding a NaN; an unaligned view (x[1:] of a flat
                tensor, the scalar path); two calls bitwise equal; one CUDA
                launch a call (a profiler trace); a captured CUDA graph's
                replays bitwise the eager call's; one call under
                `torch.cuda.set_sync_debug_mode("error")`;
  9. serve    — serving main path: a seeded random actor, ranges captured by
                monitor-phase fused forwards and frozen (Algorithm 1's
                monitor-then-freeze), then `PolicyEngine` serving 256
                threaded requests in each forced mode (fused, layer, jnp) and
                under adaptive dispatch, every reply checked against the
                plain `act_batch`.  Kernel launch counts are zeroed just
                before this phase and read just after it;
 10. layer_monitor — slice 4's path: Algorithm 1 over the per-layer
                datapath (`fxp_dense_chain`, kernel 6 at each site, then
                kernel A) for the paper's actor 17-400-300-6 and critic
                23-400-300-1 at B = 128 and 512.  Monitor phase from
                (+inf, −inf): each site's extrema against kernel B's from
                the same input (site 0 exactly, later sites 2e-5); quant
                phase with the captured ranges frozen: kernel 6 must return
                them unchanged.  Every kernel 6 result bitwise the plain
                version's.  Launch counts zeroed just before, read just
                after: kernel 6 and kernel A once per site per walk;
 11. fxp_raw  — the raw fixed-point API on CUDA tensors against the CPU
                and the numpy int64 oracle, bitwise (`fxp_matmul_raw` at
                (128, 400) @ (400, 300), saturating `quantize`, `fxp_mul`,
                `fxp_add`, `affine_quantize` / `affine_dequantize`),
                `numerics.sqrt_rn` on 2^20 values against the float64-
                rounded square root, and the card path's one quotient by a
                Python number (`site_project`'s / 2^16) bitwise the IEEE
                quotient on 2^20 values;
 12. update   — one `ddpg.update(backend="pallas")` on the card against the
                same update by the plain versions on the CPU, from the same
                state, at B = 128, in the monitor and the quant phase;
 13. update_fused — the same for backend "pallas_fused_step";
 14. train    — training main path, backend "pallas": `rl.loop.train_host`
                on the paper's configuration (`configs/fixar_ddpg.CONFIG`:
                halfcheetah, actor 17-400-300-6, critic 23-400-300-1,
                B = 128) cut to 2000 env steps, updates from step 1000, the
                QAT delay at 40 % of the updates (400, `qat_delay_frac`);
                then `evaluate` (2 episodes) and 64 requests served from the
                trained actor through `PolicyEngine.from_ddpg`.  Launch
                counts are zeroed just before `train_host` and read just
                after it: kernel B must show 5 per update + 1 per env step,
                kernel 3 3 per update;
 15. train_fused — the same configuration with backend "pallas_fused_step",
                through `train_host` (kernels 4 and 5 once per update,
                kernel B once per env step, kernel 3 and kernel B's
                residual mode never) and through `train_device` (a warmup
                window run eagerly, then every updating timestep a replay of
                one captured CUDA graph, the QAT delay crossed inside it;
                the wrapper counts and the replays are checked, and the
                same run made again with its graph window under
                `torch.profiler` counts by name the kernels each replay
                ran); both agents evaluated and served;
 16. learner  — the learner engine (`train.learner.LearnerEngine`) at the
                paper's nets, buckets 8, 32, 128: (1) for the forced modes
                "fused" (kernels B and 3) and "fused_step" (kernels 4 + 5),
                requests of 8, 32 and 128 rows bitwise equal to direct
                `ddpg.update` calls on the same state sequence, with the
                wrapper launches of each update; (2) requests of 5, 27 and
                100 rows (zero-weight pad rows) bitwise equal to direct
                calls on the engine's padded batch, and within the update
                contracts of the unpadded direct call (params 2^-16,
                targets 1e-6; for "fused_step" the padded case through
                kernel_step's check, moments included); a 300-row request
                bitwise its three chunks' direct calls in order; (3) the
                adaptive learner warmed on the main thread, then four
                producer threads submitting 64 requests of 4-40 rows; (4)
                `train_fused`'s `train_host` run again through a learner
                forced to "fused_step", its agent bitwise that run's; (5)
                `Observability(serve_http=0)`: /metrics with the learner's
                counters, /healthz (200 while training), the default SLO
                rules, a fleet aggregator over the registry's snapshot; (6)
                a checkpoint of a learner's state restored on the card,
                bitwise, and one more update from each, bitwise; (7)
                updates/s and train IPS per forced mode at bucket 128 beside
                direct calls, and 16 requests of 8 rows coalesced into one
                update against 16 direct B = 8 updates.  Launch counts are
                tallied around the learner's own calls only;
 17. profile  — `torch.profiler` over 20 updates at B = 128, backend "pallas"
                and "pallas_fused_step", and over 20 replays of the captured
                timestep: host wall and device busy time per step (so the
                device's idle share), kernels and CUDA runtime calls per
                step, the costliest kernels and host ops;
 18. times    — each kernel at the main paths' shapes: kernel A as the
                three-layer chain and layer by layer, and kernel B, at the
                serving shapes (B in {1, 8, 128, 512}, both precision
                phases), kernel B's device-phase instance at B = 1 (the
                launch a captured timestep replays), kernel B with
                residuals and kernel 3 at B = 128 for the actor and the
                critic, kernels 4 and 5 at B = 128, both phases, kernel 6
                at B × 400 for B = 512 and 128 and a 2^24-element sweep,
                both phases: kernel, plain version, library yardstick and
                the least time the card could take (`bound_ms`);
 19. engine   — host wall time of synchronous `run_batch` calls per mode
                and batch (the engine's own cost, without queueing);
 20. mesh     — `PolicyEngine(mesh=make_serve_mesh())` (every visible
                card on the `data` axis) at buckets 1, 8 and 128 in every
                mode, bitwise the `mesh=None` engine's actions; the serve
                rules (with the reference's layout hint) and the train
                rules over the params and decode caches (the reference's
                decode_32k cell, 128 × 32,768) of qwen2-0.5b, gemma3-1b,
                moonshot-v1-16b-a3b, rwkv6-1.6b, recurrentgemma-2b and
                dbrx-132b at their full configs on the reference's (16, 16)
                production layout, shapes only: sharded and replicated
                leaves and the bytes one device would hold, per phase;
 21. lm       — the LM zoo's serving path at full width, random weights
                from the seed, float32 params cast once to the bf16 serving
                tree (the configs' compute dtype), one model at a time, the
                float32 tree freed after the cast: qwen2-0.5b (24 layers,
                global KV), gemma3-1b (26 layers, 5 local : 1 global, a tail
                of 2, window 512), moonshot-v1-16b-a3b (MoE 64 experts
                top-6, 12 of its 48 layers), rwkv6-1.6b (24 RWKV-6 layers),
                recurrentgemma-2b (26 layers: 8 periods of RG-LRU, RG-LRU,
                local attention + 2 RG-LRU, window 2048) and dbrx-132b (MoE
                16 experts top-4, 2 of its 40 layers).  Per model: decode
                against the full forward (16 tokens; 8 for MoE, where the
                forward drops no pair); prefill and `generate` (16 new
                tokens) on prompts of 128 and 1024 tokens, 700 on gemma3
                (its masked local path; 1024 takes the banded one), 2304 on
                recurrentgemma (past its window: the ring wraps); decode ms
                per step at 1, 4 and 16 lanes (5 steps, the median of 2
                timed runs after a warmup), beside the least time of the
                serving tree's read (every expert, for MoE's dense
                dispatch); a `torch.profiler` pass over
                decode at 4 lanes and 1024-token prefills; except for dbrx,
                an `LMEngine` with 4 lanes serving 8 requests (prompts
                64–1024, rwkv6's rounded down to a multiple of 128 past
                128; 16–32 new tokens, 8–16 for this slice's models),
                admissions in the middle of decodes, each lane's logits
                held to the B = 1 path on the same tokens and every request
                equal to B = 1 `generate`, flips counted; tokens/s, TTFT and
                peak memory.  rwkv6 must refuse a 200-token prompt (the
                reference's chunk rule).  Float32, TF32 off, the card's
                forward of a 64-token prompt against the CPU's: qwen2 whole,
                one pattern period of moonshot (1 layer), rwkv6 (1) and
                recurrentgemma (3).  The six ported kernels' counts are set
                to 0 before the phase and must read 0 after it;
 22. lm_train — LM training at full width (slice 11): demo-100m
                (`configs/demo_100m.py`, 12 layers, d 768, 12 / 4 heads,
                GLU 3072, vocab 32,768, tied; bf16 compute, float32 master
                weights, remat "dots") through the port's own train CLI
                (`repro_torch.launch.train.main`) at B = 8, S = 1024 with
                QAT (delay 30): 70 steps checkpointed every 30 and at the
                end, then the step-70 checkpoint deleted and the same
                command resumed from step 60, the two under
                `torch.use_deterministic_algorithms(True)` (cuBLAS's
                workspace set deterministic at start); the loss must fall
                (mean of the last 5 steps below the first 5's by 0.2, the
                reference's rule), `quant_phase` flip at step 31, every
                range leaf stay finite and bitwise frozen from the delay's
                checkpoint on, every param stay finite, and the resumed
                step-70 state equal the uninterrupted one bitwise.  Then
                the step's host wall ms (p50 of 3 steady steps, each
                ending in a sync), tokens/s, MFU (6·N·tokens plus causal
                attention over 989 TFLOP/s), peak memory and a profiler
                pass over 3 steps; the same step with `ce_chunk=256` and
                with remat "none" (ms and peak memory each); 4 steps
                through `LearnerEngine(learner_update_fns(...),
                pad_policy="exact")` bitwise 4 direct calls; and one
                float32 step (TF32 off, QAT in the monitor phase, B = 1,
                S = 128) per family, card against CPU on the same params
                and batch: qwen2-0.5b (1 layer), moonshot-v1-16b-a3b (1
                layer, 64 experts), rwkv6-1.6b (1), recurrentgemma-2b (3).
                The six kernels' counts are set to 0 before and must read
                0 after;
 23. dist     — the sharded code (slice 12: the rules through DTensor,
                the expert-parallel MoE dispatch) at world size 1: a
                one-rank NCCL group (a `HashStore`, no network) and a
                (1, 1) ("data", "model") `DeviceMesh` on the card, every
                tensor a DTensor laid out by the rules.  demo-100m: 3
                train steps at B = 8, S = 1024 with QAT (the quant phase
                from step 2) against the plain step on the same batches,
                both under deterministic algorithms: losses, grad norms and
                the whole state bitwise; qwen2-0.5b (bf16 serving tree): a
                1024-token prefill into a cache and 16 greedy decode steps
                against the plain path, logits bitwise; moonshot-v1-16b-a3b
                cut to 2 layers: a prefill of 64 × 1024 = 65,536 tokens,
                which selects the expert-parallel path at model = 1 (its
                calls counted), against the plain dense dispatch within the
                bf16 serving contract 0.05·scale + 0.05.  The mesh path's
                and the plain path's train step ms and kernels per step
                (DTensor's host cost at one rank).  The group is destroyed
                when the phase ends; the six kernels' counts must read 0;
 24. dryrun   — the production dry run (slice 13): the per-rank memory
                estimator (`launch.dryrun.measure`, a dispatch mode over
                the live local storages) calibrated against the card's
                allocator — demo-100m's train step at B = 8, S = 1024
                (QAT, remat "dots") and qwen2-0.5b's 1024-token prefill
                (float32 params), each once for real (the allocator's peak
                over the run, from its arguments' creation on) and once
                under fake tensors with no process group: the estimate
                within 10 % of the allocator's peak; meanwhile, through the
                CLI (`python -m repro_torch.launch.dryrun`, one process per
                cell, both started first: each starts a fake world of its
                mesh's size), qwen2-0.5b decode_32k on the (16, 16) mesh and
                qwen2-0.5b train_4k on (2, 16, 16), full configs, fake CUDA
                tensors: each must end "ok" with ops of DTensor's planner
                recognised and left out of its peak; per-rank peak GB
                against the card's 80 GB (`launch.dryrun.HBM_BYTES`),
                collective bytes by kind, flops.  The six
                kernels' counts must read 0.

The LM path runs no kernel of the port's own: the reference computes its
attention, MoE dispatch, recurrences and products in jnp, outside any
Pallas kernel, so they are `torch.matmul` / `einsum` here.  Then the `{"kernels": [...]}` line (the
six TPU kernels' counterparts) and, last, the status line
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
Kernels 4 and 5 against their twins on the same inputs
(`kernels.fxp_mlp.replay.check_step`, in both phases): params within 2⁻¹⁶,
targets 1e-6, mu 2e-6 and nu 1e-7 (rtol 1e-4: a gradient can land one
Q15.16 quantum apart), the monitor-phase contract of
`tests/test_torch_ddpg_step.py`; each leaf of params, mu and targets must
be moved by the twin's step past its tolerance, so a tree left as it was
fails.  A ReLU, straight-through or rounding decision whose exact operand
lies within float32 rounding of its edge can go either way and move a
gradient by a row's cotangent or a rounding step, past the one quantum: so
the kernel's pass-2 operands (product inputs and cotangents) are held to a
float64 replay from their own previous layer, within the probabilistic
rounding bound of a float32 chain (λ·u·√Σ s_k², λ = 10), and mu and nu are
widened leaf by leaf by how far those operands lie from the twin's
(|q_k|ᵀ|ΔG| + |Δq|ᵀ|G|).  Extrema as kernel B's, layer 0's exactly; loss
partials over Σw (the update's metrics) rtol 1e-5 / atol 1e-6 (monitor) and
1e-3 / 1e-5 (quant), the reference's metric contracts, which it holds at
batches of 8 (monitor) and 32 (quant): a plan-edge case with fewer live
rows adds what one row's output, within kernel B's forward contract, can
move them by (at B = 9 one flipped bf16 limb moves the mean of eight rows
past 1e-5).  Kernel 6 and the raw
fixed-point API: bitwise, the contract for elementwise fixed-point ops
(min and max are order-free; a NaN matches a NaN).  The serve mesh on one
card: bitwise (the same code, one chunk).  LM, bf16: decode against the
full forward within the reference's own contract, max |Δ| < 0.05·scale +
0.05 (`tests/test_archs.py:77-78`); a lane's logits against the B = 1 path
on the same tokens within the same bound, since the card's GEMMs may sum
a row in another order at another batch size — and a lane's token may
differ from B = 1's argmax only where B = 1's top-2 margin is within it.
LM, float32 card against CPU: max |Δ| ≤ 1e-3·scale + 1e-3 (a float32 sum
in another order, 24 layers deep; bf16 compute would miss it by an order
of magnitude), also for one period of each recurrent and MoE family.  LM
training, float32 card against CPU: the loss within 1e-3·|loss| + 1e-3,
each gradient leaf within 1e-3·max|g_leaf| + 1e-6 (the same contract leaf
by leaf; the card's backward may sum a gather's or an embedding's
scatter in another order), the new ranges 2e-5; demo-100m's resumed run,
its frozen ranges and the learner path: bitwise.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import math
import os
import pathlib
import re
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
# the launch plans' edges: the first two row blocks, a ragged third, the
# widest one-wave batch of clusters of 8 (15 row blocks) and the next, and
# a ragged last row block
PLAN_BATCHES = (9, 16, 17, 120, 121, 511)
RAGGED_DENSE = ((301, 70), (257, 300))  # (K, N): K no multiple of the split, N no multiple of 4
TIME_BATCHES = (1, 8, 128, 512)
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
# the learner phase: the engine's default buckets, requests that miss them
# (padded with zero-weight rows) and one past the top bucket (three chunks)
LEARNER_BUCKETS = (8, 32, 128)
LEARNER_PADDED = (5, 27, 100)
LEARNER_CHUNKED = 300
LEARNER_THREADS, LEARNER_REQUESTS, LEARNER_ROWS = 4, 64, (4, 40)
LEARNER_COALESCE = (16, 8)  # 16 requests of 8 rows: one bucket-128 update, or 16 direct B = 8 updates
LEARNER_TIMED = dict(updates=30, rounds=8)
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


PHASES: list = []  # every emitted line, for --out
_LAST_LINE = [time.perf_counter()]


def emit(phase: str, **fields) -> None:
    """Print one phase's JSON line, with the wall seconds since the line
    before it (the phase's own time, for a phase that prints one line)."""
    now = time.perf_counter()
    PHASES.append({"phase": phase, **fields, "line_seconds": now - _LAST_LINE[0]})
    _LAST_LINE[0] = now
    print(json.dumps(PHASES[-1]), flush=True)


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


def device_time_ms(fn, iters: int, reps: int = 3, sleep_cycles: int = 100_000_000) -> float:
    """Median over `reps` of the mean device time of `iters` back-to-back
    calls.  A sleep kernel of `sleep_cycles` queued first lets the host
    enqueue every call before the first one runs, so host launch overhead
    does not set the time (as long as the sleep outlasts the enqueue).
    Inputs and weights stay warm in L2, as in serving."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep_cycles)
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

    seconds = _build.build(["fxp_dense", "fxp_mlp_fwd", "fxp_mlp_bwd", "fxp_ddpg_step", "fxp_monitor_quant"])
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


def _extra(gen: torch.Generator) -> torch.Generator:
    """A generator for cases added in PR 15, seeded from `gen`'s seed
    without drawing from it, so the phases that share `gen` keep the inputs
    they had before those cases existed."""
    return torch.Generator().manual_seed(gen.initial_seed() + 15)


def phase_kernel_a(gen: torch.Generator, dev) -> float:
    from repro_torch.kernels.fxp_matmul.kernel import dense_plan, fxp_dense_cuda
    from repro_torch.kernels.fxp_matmul.ref import ref_fxp_dense

    worst = {"max_abs": 0.0, "max_rel": 0.0}
    cases = 0
    plans = set()
    extra = _extra(gen)
    layers = [(w, b, True) for w, b in _layer_operands(gen, dev)]
    # the plan's edges beyond the actor: K not a multiple of the split on a
    # width not a multiple of 4 (the tiled body's 4-byte copies)
    for k, n in RAGGED_DENSE:
        layers.append((((torch.rand(k, n, generator=extra) * 2 - 1) * k**-0.5).to(dev),
                       (torch.rand(n, generator=extra) * 2 - 1).to(dev), False))
    for w, b, actor in layers:
        k = w.shape[0]
        for batch in CHECK_BATCHES + PLAN_BATCHES:
            g = gen if actor and batch in CHECK_BATCHES else extra
            x = (torch.randn(batch, k, generator=g) * 2).to(dev)
            plans.add((batch, k, w.shape[1], dense_plan(batch, k, w.shape[1])[:3]))
            for full in (True, False):
                for act in ("relu", "tanh", "none"):
                    for bias in (b, None) if act == "none" else (b,):
                        got = fxp_dense_cuda(x, w, bias, full_precision=full, activation=act)
                        again = fxp_dense_cuda(x, w, bias, full_precision=full, activation=act)
                        want = ref_fxp_dense(x, w, bias, full_precision=full, activation=act)
                        torch.cuda.synchronize()
                        tag = f"kernel A {tuple(w.shape)} B={batch} full={full} {act}"
                        require(torch.equal(got, again), f"{tag}: two calls on the same inputs differ")
                        e = compare(got, want, TOL, tag)
                        worst = {key: max(worst[key], e[key]) for key in worst}
                        cases += 1
    emit("kernel_a", cases=cases, tolerance=TOL, bitwise_repeat=True,
         plans=sorted([*p[:3], *p[3]] for p in plans), **worst)
    return worst["max_abs"]


def _site_operands(ws, bs, x_cal, acts=NETS["actor"][1]):
    """Per-site affine operands from the extrema of one monitor-phase pass."""
    from repro_torch.core import fixedpoint as fxp
    from repro_torch.kernels.fxp_mlp.ref import ref_mlp_forward

    _, mins, maxs = ref_mlp_forward(x_cal, ws, bs, None, None, activations=acts, quant=False, qat=False)
    deltas, zs = fxp.affine_params(mins, maxs, 16)
    return deltas.contiguous(), zs.to(torch.float32).contiguous()


def _cluster_slots() -> dict:
    """cudaOccupancyMaxActiveClusters for kernel B's plans at the paper's
    actor (B = 1 and 120: clusters of 8; B = 128: of 4), beside the count
    the plan assumes (`CLUSTER_SLOTS`).  A plan the card cannot schedule
    fails; fewer slots than assumed only make a second wave."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.fxp_mlp.kernel import CLUSTER_SLOTS, mlp_plan

    lib = _build.load("fxp_mlp_fwd")
    out = {}
    for batch in (1, 120, 128):
        p = mlp_plan(batch, ACTOR_DIMS)
        n = lib.fxp_mlp_fwd_max_clusters(p.bm, p.cluster, p.smem, int(p.resident))
        require(n >= 1, f"kernel B's plan for B={batch} cannot be scheduled ({n})")
        out[f"B={batch} C={p.cluster} smem={p.smem}"] = {"queried": n, "assumed": CLUSTER_SLOTS[p.cluster]}
    return out


def phase_kernel_b(gen: torch.Generator, dev) -> tuple[float, float]:
    from repro_torch.kernels.fxp_mlp.kernel import fxp_mlp_fwd_cuda, mlp_plan, monitor_rows
    from repro_torch.kernels.fxp_mlp.ref import ref_mlp_forward

    worst = {"off": 0.0, "monitor": 0.0, "quant": 0.0, "minmax": 0.0}
    plans = {}
    extra = _extra(gen)
    layers = _layer_operands(gen, dev)
    ws, bs = [w for w, _ in layers], [b for _, b in layers]
    deltas, zs = _site_operands(ws, bs, (torch.randn(512, ACTOR_DIMS[0], generator=gen) * 2).to(dev))
    nets = {"actor": (ACTOR_DIMS, NETS["actor"][1], ws, bs, deltas, zs), "critic": _net_operands(extra, dev, "critic")}
    for net, (dims, acts, ws, bs, deltas, zs) in nets.items():
        for batch in CHECK_BATCHES + PLAN_BATCHES:
            g = gen if net == "actor" and batch in CHECK_BATCHES else extra
            x = (torch.randn(batch, dims[0], generator=g) * 2).to(dev)
            p = mlp_plan(batch, dims)
            plans[f"{net} B={batch}"] = {"bm": p.bm, "cluster": p.cluster, "n_clusters": p.n_clusters,
                                         "resident": p.resident, "nbuf": p.nbuf, "smem": p.smem}
            for case in ("off", "monitor", "quant"):
                kw = _case_kw(acts, case)
                quant = kw["quant"]
                d, z = (deltas, zs) if kw["qat"] else (None, None)
                y, bmins, bmaxs = fxp_mlp_fwd_cuda(x, ws, bs, d, z, **kw)
                again = fxp_mlp_fwd_cuda(x, ws, bs, d, z, **kw)
                y_ref, mins_ref, maxs_ref = ref_mlp_forward(x, ws, bs, deltas, zs, **kw)
                torch.cuda.synchronize()
                tag = f"kernel B {net} B={batch} {case}"
                require(all(torch.equal(a, b) for a, b in zip((y, bmins, bmaxs), again)),
                        f"{tag}: two calls on the same inputs differ")
                require(bmins.shape == (monitor_rows(batch, dims), len(ws)), f"{tag}: mins shape {bmins.shape}")
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
    emit("kernel_b", tolerance={"off": TOL, "monitor": TOL, "quant": TOL_QUANT, "minmax": TOL}, max_abs=worst,
         bitwise_repeat=True, plans=plans, cluster_slots=_cluster_slots())
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


# kernel 3's launch-plan edges (`bwd_plan`): one row, the first row blocks of
# 8 and 16, the widest one-wave batch of clusters of 8 and the next, where
# 16-row blocks take over (241), and persistent clusters (511); then the
# learner's middle bucket (32), last so the edges before it keep their inputs
BWD_PLAN_BATCHES = (1, 7, 8, 9, 16, 17, 120, 121, 241, 511, 32)


def phase_kernel_bwd(gen: torch.Generator, dev) -> float:
    """Kernel 3 against `ref_mlp_backward` on the kernel's own residuals:
    dx, dW, db at the paper's nets, TRAIN_BATCHES (drawn from `gen`) and the
    launch plan's edges BWD_PLAN_BATCHES (from a generator of their own, so
    later phases keep their inputs), QAT off / monitor / quant; two calls on
    the same inputs bitwise equal; for the net whose last layer is tanh,
    that layer's cotangent after the activation backward (G, read through
    the internal launch helper `_fxp_mlp_bwd`) bitwise the plain version's
    g·(1 − h·h), each operation rounded on its own."""
    from repro_torch.kernels.fxp_mlp.kernel import _fxp_mlp_bwd, bwd_plan, fxp_mlp_bwd_cuda, fxp_mlp_fwd_cuda
    from repro_torch.kernels.fxp_mlp.ref import ref_mlp_backward

    worst = {"off": 0.0, "monitor": 0.0, "quant": 0.0}
    cases = tanh_cases = 0
    edges = torch.Generator().manual_seed(gen.initial_seed() + 17)
    for net in NETS:
        dims, acts, ws, bs, deltas, zs = _net_operands(gen, dev, net)
        for batch, src in [(b, gen) for b in TRAIN_BATCHES] + [(b, edges) for b in BWD_PLAN_BATCHES]:
            x = (torch.randn(batch, dims[0], generator=src) * 2).to(dev)
            g = torch.randn(batch, dims[-1], generator=src).to(dev)
            for case in ("off", "monitor", "quant"):
                kw = _case_kw(acts, case)
                d, z = (deltas, zs) if kw["qat"] else (None, None)
                rtol, atol = GRAD_TOL[case]
                tag = f"kernel 3 {net} B={batch} {case}"
                _, _, _, qs, hs = fxp_mlp_fwd_cuda(x, ws, bs, d, z, save_residuals=True, **kw)
                (dx, dws, dbs), gs = _fxp_mlp_bwd(g, x, ws, qs, hs, d, z, **kw)
                dx2, dws2, dbs2 = fxp_mlp_bwd_cuda(g, x, ws, qs, hs, d, z, **kw)
                rdx, rdws, rdbs = ref_mlp_backward(g, x, ws, qs, hs, deltas, zs, **kw)
                torch.cuda.synchronize()
                for a, b2 in zip([dx, *dws, *dbs], [dx2, *dws2, *dbs2]):
                    require(torch.equal(a, b2), f"{tag}: two launches on the same inputs differ")
                if acts[-1] == "tanh":
                    require(_bitwise(gs[-1], g * (1.0 - hs[-1] * hs[-1])),
                            f"{tag}: the tanh layer's cotangent is not bitwise g·(1 − h·h)")
                    tanh_cases += 1
                err = 0.0
                names = ["dx"] + [f"dW{i}" for i in range(len(ws))] + [f"db{i}" for i in range(len(ws))]
                for got, want, what in zip([dx, *dws, *dbs], [rdx, *rdws, *rdbs], names):
                    err = max(err, compare(got, want, rtol, f"{tag} {what}", atol=atol)["max_abs"])
                worst[case] = max(worst[case], err)
                cases += 1
    plans = {f"{net} B={b}": dict(zip(("bm", "cluster", "n_clusters", "resident"), bwd_plan(b, NETS[net][0])[:4]),
                                  smem=bwd_plan(b, NETS[net][0]).smem)
             for net in NETS for b in sorted({*TRAIN_BATCHES, *BWD_PLAN_BATCHES})}
    emit("kernel_bwd", cases=cases, batches=sorted({*TRAIN_BATCHES, *BWD_PLAN_BATCHES}),
         tolerance={c: {"rtol": r, "atol": a} for c, (r, a) in GRAD_TOL.items()}, max_abs=worst,
         bitwise_repeat=True, tanh_cotangent_bitwise_cases=tanh_cases, cuda_launches_per_call=2, plans=plans)
    return max(worst.values())


# kernels 4 and 5 against their twins: `kernels.fxp_mlp.replay.check_step`
# (the trees at the monitor-phase contract of tests/test_torch_ddpg_step.py,
# mu and nu widened leaf by leaf by how far the kernel's pass-2 operands,
# held to a float64 replay of their own, lie from the twin's)
STEP_PHASES = ("monitor", "quant")
STEP_CASES = ((128, 0), (200, 30))  # (B, rows masked by w = 0): the training batch, and multi-block ragged
# the chain passes' plan edges: one row, the first row blocks of 8 and 16, the
# widest one-wave batch of clusters of 8 (15 row blocks) and the next (16-row
# blocks, or clusters of 4 for the critic pass), where the critic pass moves
# to 16-row blocks (241), and persistent clusters (511); then the learner's
# middle bucket (32), last so the edges before it keep their inputs
STEP_PLAN_BATCHES = (1, 7, 8, 9, 16, 17, 120, 121, 241, 511, 32)
# CUDA launches a wrapper call makes: kernel 4 its target pass, critic pass
# and pass 2; kernel 5 its chain pass and pass 2
STEP_CUDA_LAUNCHES = {"ddpg_critic_step": 3, "ddpg_actor_step": 2}
# A standing case: the inputs on which kernel 5's first moments once landed
# two quanta from its twin's (B = 200, 30 masked, monitor phase; a ReLU
# decision at a pre-activation of -5.3e-7 went the other way).  The CPU
# generator's state at that case, restored into a generator of its own.
STEP_FLIP_STATE = REPO / "tests" / "data" / "kernel_step_relu_flip.gen"


def _step_cases(gen: torch.Generator, dev):
    """The fused-step cases: STEP_CASES drawn from `gen`, the standing case
    restored from STEP_FLIP_STATE, then the launch plans' edges
    (STEP_PLAN_BATCHES, a fifth of the rows masked) from a generator of their
    own, so earlier phases keep their inputs.  Yields (label, batch, masked,
    case)."""
    for batch, masked in STEP_CASES:
        yield f"B={batch} masked={masked}", batch, masked, _step_case(gen, dev, batch, masked)
    flip = torch.Generator()
    flip.set_state(torch.from_numpy(np.fromfile(STEP_FLIP_STATE, dtype=np.uint8)))
    yield "relu_flip B=200 masked=30", 200, 30, _step_case(flip, dev, 200, 30)
    edges = torch.Generator().manual_seed(gen.initial_seed() + 16)
    for batch in STEP_PLAN_BATCHES:
        yield f"plan B={batch} masked={batch // 5}", batch, batch // 5, _step_case(edges, dev, batch, batch // 5)


def _step_plans(batches) -> dict:
    """Kernels 4 and 5's chain-pass plans at the paper's nets, with
    cudaOccupancyMaxActiveClusters for each (beside the count the plan
    assumes, `CLUSTER_SLOTS`).  A plan the card cannot schedule fails."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.fxp_mlp.kernel import CLUSTER_SLOTS, step_plan

    lib = _build.load("fxp_ddpg_step")
    out = {}
    for batch in batches:
        for mode, which in enumerate(("target", "critic", "actor")):
            p = step_plan(batch, ACTOR_DIMS, CRITIC_DIMS, which)
            n = lib.fxp_ddpg_step_max_clusters(mode, p.bm, p.cluster, p.smem, int(p.resident))
            require(n >= 1, f"kernel 4/5 {which} pass plan for B={batch} cannot be scheduled ({n})")
            out[f"{which} B={batch}"] = {"bm": p.bm, "cluster": p.cluster, "n_clusters": p.n_clusters,
                                         "resident": p.resident, "nbuf": p.nbuf, "smem": p.smem,
                                         "cluster_slots": {"queried": n, "assumed": CLUSTER_SLOTS[p.cluster]}}
    return out


def _step_case(gen: torch.Generator, dev, batch: int, masked: int) -> dict:
    """A fused-step case at the paper's shapes on `dev`: a batch with
    `masked` rows of weight 0, random nets on the Q15.16 lattice, targets,
    Adam moments as a run leaves them (v of the order of m²), site operands
    from fixed ranges, and the hyper vector of Adam step 5."""
    from repro_torch.core import fixedpoint as fxp
    from repro_torch.kernels.fxp_mlp.ops import _hyper
    from repro_torch.optim import adam

    (a_dims, a_acts), (c_dims, c_acts) = NETS["actor"], NETS["critic"]
    obs, act = a_dims[0], a_dims[-1]

    def tree(dims, scale=None):
        ws = [(torch.rand(k, n, generator=gen) * 2 - 1) * (scale or k**-0.5) for k, n in zip(dims[:-1], dims[1:])]
        bs = [(torch.rand(n, generator=gen) * 2 - 1) * (scale or k**-0.5) for k, n in zip(dims[:-1], dims[1:])]
        if scale is None:
            ws, bs = [fxp.project(w, fxp.FXP32) for w in ws], [fxp.project(b, fxp.FXP32) for b in bs]
        return [w.to(dev) for w in ws], [b.to(dev) for b in bs]

    def second(m):
        return [t * t * 2 + 1e-10 for t in m[0]], [t * t * 2 + 1e-10 for t in m[1]]

    am, cm = tree(a_dims, 1e-3), tree(c_dims, 1e-3)
    c = {
        "obs": (torch.randn(batch, obs, generator=gen) * 2).to(dev),
        "action": (torch.rand(batch, act, generator=gen) * 2 - 1).to(dev),
        "reward": torch.randn(batch, generator=gen).to(dev),
        "done": (torch.rand(batch, generator=gen) < 0.05).to(torch.float32).to(dev),
        "next_obs": (torch.randn(batch, obs, generator=gen) * 2).to(dev),
        "w": (torch.arange(batch) < batch - masked).to(torch.float32).to(dev),
        "actor": tree(a_dims), "actor_t": tree(a_dims), "actor_m": am, "actor_v": second(am),
        "critic": tree(c_dims), "critic_t": tree(c_dims), "critic_m": cm, "critic_v": second(cm),
        "kw": dict(actor_acts=a_acts, critic_acts=c_acts, n_bits=16, qat=True, fxp32_phase1=True, fxp_weights=True),
    }
    d, z = fxp.affine_params(-(torch.rand(6, generator=gen) * 3 + 1), torch.rand(6, generator=gen) * 3 + 1, 16)
    c["deltas"], c["zs"] = d.to(dev), z.to(torch.float32).to(dev)
    consts = adam.step_constants(adam.AdamConfig(), torch.full((), 5, dtype=torch.int32, device=dev))
    c["hyper"] = _hyper(1.0 / torch.clamp(c["w"].sum(), min=1.0), 0.99, 0.005, consts)
    return c


def _critic_args(c: dict) -> tuple:
    return (c["obs"], c["action"], c["reward"], c["done"], c["next_obs"], c["w"], c["actor_t"], c["critic"],
            c["critic_t"], c["critic_m"], c["critic_v"], c["deltas"], c["zs"], c["hyper"])


def _actor_args(c: dict, critic) -> tuple:
    return (c["obs"], c["w"], c["actor"], c["actor_m"], c["actor_v"], c["actor_t"], critic, c["deltas"], c["zs"],
            c["hyper"])


def _step_tolerance() -> dict:
    from repro_torch.kernels.fxp_mlp.replay import STEP_TOL

    return {k: {"atol": a, "rtol": r} for k, (a, r) in STEP_TOL.items()}


def _check_step(got, want, c: dict, name: str, phase: str, tag: str, critic=None, kernel=None,
                edge: bool = False, moved: bool = True) -> dict:
    """One kernel-4/5 result against its twin's (`replay.check_step`, with
    the kernel's pass-2 operands `kernel` = (qs, gs)); fails on any of its
    failures.  Returns its errors, the twin's least moves, the worst first
    moment and the replay's counts."""
    from repro_torch.kernels.fxp_mlp.replay import check_step

    res = check_step(got, want, c, name, phase == "quant", *kernel, critic=critic, edge=edge, moved=moved)
    require(not res["failures"], f"{tag}: {'; '.join(res['failures'][:4])}")
    return res


def _step_pair(c: dict, batch: int, phase: str, label: str, edge: bool = False, moved: bool = True) -> dict:
    """Kernels 4 and 5 on one case in one phase against their plain twins
    (`_check_step`; `moved=False` for a case from a training state);
    two calls on the same inputs bitwise equal.  Kernel 5 runs through
    the twin's updated critic on both sides.  Returns {name: (tag,
    check_step's result)}."""
    from repro_torch.kernels.fxp_mlp.kernel import _ddpg_actor_step, _ddpg_critic_step, step_monitor_rows
    from repro_torch.kernels.fxp_mlp.ref import ref_ddpg_actor_step, ref_ddpg_critic_step

    quant = phase == "quant"
    dev = c["obs"].device
    phase_t = torch.full((1,), int(quant), dtype=torch.int32, device=dev)
    want_c = ref_ddpg_critic_step(*_critic_args(c), quant, **c["kw"])
    out = {}
    for name, launch, twin_out, args in (
        ("critic", _ddpg_critic_step, want_c, _critic_args(c)),
        ("actor", _ddpg_actor_step, None, _actor_args(c, want_c[0])),
    ):
        got, scratch = launch(*args, phase_t, **c["kw"])
        again, _ = launch(*args, phase_t, **c["kw"])
        want = twin_out if twin_out is not None else ref_ddpg_actor_step(*args, quant, **c["kw"])
        torch.cuda.synchronize()
        tag = f"kernel {4 if name == 'critic' else 5} {label} {phase}"
        flat = lambda out: [t for tr in out[:4] for half in tr for t in half] + list(out[4:])  # noqa: E731
        require(all(torch.equal(x, y) for x, y in zip(flat(got), flat(again))),
                f"{tag}: two calls on the same inputs differ")
        n_sites = 3 if name == "critic" else 6
        rows = step_monitor_rows(batch, ACTOR_DIMS, CRITIC_DIMS, name)
        require(got[4].shape == (rows, n_sites) and got[6].shape[0] == rows,
                f"{tag}: mins shape {tuple(got[4].shape)}, partials {tuple(got[6].shape)}")
        out[name] = (tag, _check_step(got, want, c, name, phase, tag, want_c[0] if name == "actor" else None, scratch,
                                      edge=edge, moved=moved))
    return out


def phase_kernel_step(gen: torch.Generator, dev) -> dict:
    """Kernels 4 and 5 against their plain twins on the same card inputs
    (`_step_cases`) in both phases (`_step_pair`)."""
    from repro_torch.kernels.fxp_mlp import replay

    worst = {name: {phase: {} for phase in STEP_PHASES} for name in ("critic", "actor")}
    moved = {name: {phase: {} for phase in STEP_PHASES} for name in ("critic", "actor")}
    replays = {}
    labels = []
    for label, batch, masked, c in _step_cases(gen, dev):
        labels.append(label)
        for phase in STEP_PHASES:
            for name, (tag, res) in _step_pair(c, batch, phase, label, edge=label.startswith("plan")).items():
                for k, v in res["max_abs"].items():
                    worst[name][phase][k] = max(worst[name][phase].get(k, 0.0), v)
                for k, v in res["moved"].items():
                    moved[name][phase][k] = min(moved[name][phase].get(k, math.inf), v)
                replays[tag] = res["replay"]
    emit("kernel_step", cases=labels,
         tolerance={**_step_tolerance(),
                    "mu_nu_slack": "each leaf's atol widened by how far the kernel's pass-2 operands, held to a "
                                   "float64 replay of their own, lie from the twin's (replay.check_step)",
                    "replay_lambda": replay.LAMBDA,
                    "extrema": {"layer0": "exact", "rtol": replay.EXTREMA_TOL, "atol": replay.EXTREMA_TOL},
                    "partials": {p: {"rtol": r, "atol": a} for p, (r, a) in replay.PART_TOL.items()},
                    "partials_one_row_below": replay.PART_ROWS},
         max_abs=worst, twin_moved_least=moved, replay=replays, bitwise_repeat=True,
         cuda_launches_per_call=STEP_CUDA_LAUNCHES,
         plans=_step_plans(sorted({*(b for b, _ in STEP_CASES), *STEP_PLAN_BATCHES, *LEARNER_BUCKETS})))
    return {name: max(v for ph in w.values() for v in ph.values()) for name, w in worst.items()}


# kernel 6 (the standalone monitor + quantizer): the reference test's shapes,
# the paper's site inputs (batch × layer input width), a sweep larger than L2,
# and a length that is not a multiple of the block (csrc THREADS = 256)
MQ_SHAPES = ([(64,), (7, 33), (256, 400), (3, 5, 17), (1, 1), (1024,)]
             + [(b, w) for b in (1, 7, 128, 512) for w in (17, 23, 400, 300)]
             + [(1 << 24,), (1000003,)])
MQ_RANGES = {"captured": (-3.0, 3.5), "empty": (math.inf, -math.inf)}
LAYER_BATCHES = (128, 512)


def _bitwise(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit patterns, a NaN matching any NaN."""
    a, b = a.detach().to(b.device), b.detach()
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if not a.is_floating_point():
        return torch.equal(a, b)
    return bool(((a.view(torch.int32) == b.view(torch.int32)) | (a.isnan() & b.isnan())).all())


def _max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a − b| over the positions where neither is NaN."""
    d = (a.double() - b.double()).abs()
    d = d[~d.isnan()]
    return float(d.max()) if d.numel() else 0.0


def phase_kernel_mq(gen: torch.Generator, dev) -> float:
    """Kernel 6 against its plain version on the card: y, new_min and
    new_max bitwise at MQ_SHAPES, both phases, incoming ranges MQ_RANGES;
    an input holding a NaN (extrema NaN in the monitor phase, frozen in the
    quant phase); two calls bitwise equal; one call under
    `torch.cuda.set_sync_debug_mode("error")` (nothing in a call syncs)."""
    from repro_torch.kernels.quantize import monitor_quant, ref_monitor_quant

    cases, worst = 0, 0.0
    for shape in MQ_SHAPES:
        x = (torch.randn(*shape, generator=gen) * 4).to(dev)
        for label, (a_min, a_max) in MQ_RANGES.items():
            for quant in (False, True):
                got = monitor_quant(x, a_min, a_max, quant)
                again = monitor_quant(x, a_min, a_max, quant)
                want = ref_monitor_quant(x, a_min, a_max, quant)
                torch.cuda.synchronize()
                tag = f"kernel 6 {shape} {label} {'quant' if quant else 'monitor'}"
                for g, a, w, what in zip(got, again, want, ("y", "new_min", "new_max")):
                    worst = max(worst, _max_abs(g, w))
                    require(_bitwise(g, w), f"{tag} {what}: not bitwise the plain version's")
                    require(_bitwise(g, a), f"{tag} {what}: two calls differ")
                cases += 1
    x = (torch.randn(70001, generator=gen) * 4).to(dev)
    x[12345] = math.nan
    for quant in (False, True):
        got = monitor_quant(x, -3.0, 3.5, quant)
        want = ref_monitor_quant(x, -3.0, 3.5, quant)
        torch.cuda.synchronize()
        for g, w, what in zip(got, want, ("y", "new_min", "new_max")):
            worst = max(worst, _max_abs(g, w))
            require(_bitwise(g, w), f"kernel 6 NaN input {quant=} {what}: not bitwise the plain version's")
        require(bool(got[1].isnan()) != quant and bool(got[2].isnan()) != quant,
                f"kernel 6 NaN input {quant=}: extrema {float(got[1])}, {float(got[2])}")
        cases += 1
    # an unaligned view: the scalar path, NaN included (this case and the
    # graph's draw from a generator of their own, so later phases keep their
    # inputs)
    own = torch.Generator().manual_seed(gen.initial_seed() + 18)
    xv = (torch.randn(70002, generator=own) * 4).to(dev)[1:]
    xv[777] = math.nan
    require(xv.data_ptr() % 16 != 0, "kernel 6: the view is aligned")
    for quant in (False, True):
        got = monitor_quant(xv, -3.0, 3.5, quant)
        want = ref_monitor_quant(xv, -3.0, 3.5, quant)
        torch.cuda.synchronize()
        for g, w, what in zip(got, want, ("y", "new_min", "new_max")):
            worst = max(worst, _max_abs(g, w))
            require(_bitwise(g, w), f"kernel 6 unaligned view {quant=} {what}: not bitwise the plain version's")
        cases += 1
    launches_per_call = _mq_cuda_launches(dev)
    require(launches_per_call == 1, f"kernel 6: {launches_per_call} CUDA launches a call, expected 1")
    replays = _mq_graph_replays(own, dev)
    a_min, a_max = torch.full((), -3.0, device=dev), torch.full((), 3.5, device=dev)
    phase = torch.ones((), dtype=torch.bool, device=dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = monitor_quant(x, a_min, a_max, phase)
        got_py = monitor_quant(x, -3.0, 3.5, True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    for g, w in zip(got, got_py):
        require(_bitwise(g, w), "kernel 6: device-tensor and Python phase/ranges differ")
    emit("kernel_mq", cases=cases, shapes=[list(s) for s in MQ_SHAPES], ranges=list(MQ_RANGES),
         tolerance="bitwise (y, new_min, new_max)", max_abs=worst, nan_case=True, unaligned_view_case=True,
         bitwise_repeat=True, cuda_launches_per_call=launches_per_call, graph_replays_bitwise=replays,
         sync_debug_error=True)
    return worst


def _mq_cuda_launches(dev, calls: int = 20) -> int:
    """CUDA kernels a `monitor_quant_cuda` call runs, by a profiler trace of
    `calls` calls at 512 × 400: the kernels named like kernel 6's, per call,
    rounded (a trace can lose a kernel launched as it starts; a sleep kernel
    first, not counted, takes that place)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.quantize.kernel import monitor_quant_cuda

    x = torch.randn(512 * 400, device=dev)
    a_min, a_max = torch.full((1,), -3.0, device=dev), torch.full((1,), 3.5, device=dev)
    phase = torch.zeros((1,), dtype=torch.int32, device=dev)
    monitor_quant_cuda(x, a_min, a_max, phase)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(10_000_000)
        for _ in range(calls):
            monitor_quant_cuda(x, a_min, a_max, phase)
        torch.cuda._sleep(50_000_000)  # keeps the last calls' kernels inside the trace (`_kernels_ran`)
        torch.cuda.synchronize()
        time.sleep(0.2)
    ran = sum(e.count for e in prof.key_averages()
              if str(e.device_type).endswith("CUDA") and "mq_" in e.key)
    return round(ran / calls)


def _mq_graph_replays(gen: torch.Generator, dev) -> int:
    """Kernel 6 captured in a CUDA graph (after an eager call on the capture
    stream), replayed on new inputs written in place, across a phase flip:
    each replay bitwise the eager call's on the same inputs."""
    from repro_torch.kernels.quantize.kernel import monitor_quant_cuda

    x = torch.empty(512 * 400, device=dev)
    a_min, a_max = torch.full((1,), -3.0, device=dev), torch.full((1,), 3.5, device=dev)
    phase = torch.zeros((1,), dtype=torch.int32, device=dev)
    stream = torch.cuda.Stream(dev)
    stream.wait_stream(torch.cuda.current_stream(dev))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream):
        x.copy_(torch.randn(x.numel(), generator=gen).to(dev))
        monitor_quant_cuda(x, a_min, a_max, phase)  # the stream's workspace, made eagerly
        with torch.cuda.graph(graph, stream=stream):
            out = monitor_quant_cuda(x, a_min, a_max, phase)
    torch.cuda.current_stream(dev).wait_stream(stream)
    replays = 0
    for quant in (0, 1, 1, 0):
        x.copy_((torch.randn(x.numel(), generator=gen) * 4).to(dev))
        phase.fill_(quant)
        graph.replay()
        want = monitor_quant_cuda(x, a_min, a_max, phase)
        torch.cuda.synchronize()
        for g, w, what in zip(out, want, ("y", "new_min", "new_max")):
            require(_bitwise(g, w), f"kernel 6 graph replay {replays} (phase {quant}) {what}: not the eager call's")
        replays += 1
    return replays


def phase_layer_monitor(gen: torch.Generator, dev) -> dict:
    """This slice's path at full width: Algorithm 1 over the per-layer
    datapath (`fxp_dense_chain` with `monitor_quant` at each site), for the
    paper's actor and critic at LAYER_BATCHES.  Monitor phase: each site
    monitored from (+inf, −inf) and projected to Q15.16, then kernel A in
    full precision; its extrema held against kernel B's per-site extrema
    from the same input (site 0 exactly, later sites at 2e-5: kernels A and
    B sum in different orders).  Quant phase: the captured ranges frozen,
    kernel 6 must return them unchanged, kernel A in half precision.  Every
    kernel 6 result bitwise the plain version's on the same site input.
    Launch counts are zeroed just before the walks and read just after."""
    from repro_torch.kernels.fxp_matmul import fxp_dense_chain
    from repro_torch.kernels.fxp_matmul.kernel import fxp_dense_cuda
    from repro_torch.kernels.fxp_mlp.kernel import fxp_mlp_fwd_cuda
    from repro_torch.kernels.quantize import monitor_quant, ref_monitor_quant
    from repro_torch.kernels.quantize.kernel import monitor_quant_cuda

    cases = []
    for net in NETS:
        dims, acts, ws, bs, deltas, zs = _net_operands(gen, dev, net)
        for batch in LAYER_BATCHES:
            x = (torch.randn(batch, dims[0], generator=gen) * 2).to(dev)
            _, bmins, bmaxs = fxp_mlp_fwd_cuda(x, ws, bs, deltas, zs, **_case_kw(acts, "monitor"))
            cases.append(dict(net=net, batch=batch, x=x, ws=ws, bs=bs, acts=acts,
                              fused=(bmins.amin(0), bmaxs.amax(0))))

    def walk(c: dict, quant: bool, ranges=None) -> list:
        sites = []

        def site(i: int, xi: torch.Tensor) -> torch.Tensor:
            a_min, a_max = ranges[i] if quant else (math.inf, -math.inf)
            y, new_min, new_max = monitor_quant(xi, a_min, a_max, quant)
            sites.append((xi, y, new_min, new_max))
            return y

        fxp_dense_chain(c["x"], c["ws"], c["bs"], activations=c["acts"], full_precision=not quant, site_fn=site)
        return sites

    sync(dev)
    _reset_counts()
    t0 = time.perf_counter()
    for c in cases:
        c["monitor"] = walk(c, False)
        c["quant"] = walk(c, True, [(s[2], s[3]) for s in c["monitor"]])
    sync(dev)
    wall = time.perf_counter() - t0
    launches = {"fxp_monitor_quant": monitor_quant_cuda.launches, "fxp_dense": fxp_dense_cuda.launches}
    n_sites = sum(len(c["ws"]) for c in cases)
    want = {"fxp_monitor_quant": 2 * n_sites, "fxp_dense": 2 * n_sites}
    require(launches == want, f"layer_monitor: launches {launches}, expected {want}")

    extrema_err = 0.0
    ranges = {}
    for c in cases:
        tag = f"layer_monitor {c['net']} B={c['batch']}"
        mins, maxs = c["fused"]
        ranges[f"{c['net']} B={c['batch']}"] = [[float(s[2]), float(s[3])] for s in c["monitor"]]
        for i, ((xi, y, mn, mx), (_, yq, mnq, mxq)) in enumerate(zip(c["monitor"], c["quant"])):
            if i == 0:
                require(float(mn) == float(mins[0]) and float(mx) == float(maxs[0]),
                        f"{tag} site 0: extrema {float(mn)}, {float(mx)} != kernel B's {float(mins[0])}, "
                        f"{float(maxs[0])}")
            for got, fused, what in ((mn, mins[i], "min"), (mx, maxs[i], "max")):
                extrema_err = max(extrema_err, compare(got.reshape(1), fused.reshape(1), TOL,
                                                       f"{tag} site {i} {what} vs kernel B")["max_abs"])
            for got, want_t, what in zip((y, mn, mx), ref_monitor_quant(xi, math.inf, -math.inf, False),
                                         ("y", "min", "max")):
                require(_bitwise(got, want_t), f"{tag} site {i} monitor {what}: not bitwise the plain version's")
            require(_bitwise(mnq, mn) and _bitwise(mxq, mx), f"{tag} site {i}: frozen range moved")
        for i, (xi, yq, mnq, mxq) in enumerate(c["quant"]):
            want_q = ref_monitor_quant(xi, c["monitor"][i][2], c["monitor"][i][3], True)
            require(_bitwise(yq, want_q[0]), f"{tag} site {i} quant y: not bitwise the plain version's")
    report = {"nets": {net: "-".join(map(str, NETS[net][0])) for net in NETS}, "batches": list(LAYER_BATCHES),
              "sites_per_walk": {net: len(NETS[net][0]) - 1 for net in NETS}, "walks": 2 * len(cases),
              "launches": launches, "launches_expected": want, "cuda_launches": {
                  "fxp_monitor_quant": launches["fxp_monitor_quant"], "fxp_dense": launches["fxp_dense"]},
              "wall_s": wall, "extrema_vs_kernel_b_max_abs": extrema_err, "extrema_tolerance": TOL,
              "captured_ranges": ranges}
    emit("layer_monitor", **report)
    return report


def phase_fxp_raw(gen: torch.Generator, dev) -> dict:
    """The raw fixed-point API on CUDA tensors against the port's CPU results
    and the numpy int64 oracle, bitwise: `quantize` (saturating at ±40000,
    NaN to 0, ties to even), `fxp_matmul_raw` at (128, 400) @ (400, 300)
    (CUDA has no int64 matmul: K-chunked exact sums), `fxp_mul`, `fxp_add`,
    `affine_quantize` / `affine_dequantize`; and `numerics.sqrt_rn` on 2^20
    float32 values against the float64-rounded square root.  Reports, as an
    observation, how many of those square roots the card's float32
    `torch.sqrt` and quotients by a Python number (PyTorch multiplies by
    the reciprocal) differ from the IEEE results in."""
    from repro_torch.core import fixedpoint as fxp
    from repro_torch.numerics import sqrt_rn

    rng = np.random.default_rng(int(torch.randint(0, 2**31 - 1, (1,), generator=gen)))
    cpu = torch.device("cpu")

    def both(fn, *arrays):
        got = fn(*[torch.from_numpy(a).to(dev) for a in arrays])
        want = fn(*[torch.from_numpy(a) for a in arrays])
        sync(dev)
        return got.to(cpu), want

    checks = {}

    def check(name, got, want, oracle=None):
        require(_bitwise(got, want), f"fxp_raw {name}: card and CPU differ")
        if oracle is not None:
            require(np.array_equal(got.numpy(), oracle), f"fxp_raw {name}: the int64 oracle differs")
        checks[name] = list(got.shape)

    edges = np.array([40000.0, -40000.0, np.nan, np.inf, -np.inf, 0.5 / 65536, 1.5 / 65536, 2.5 / 65536], np.float32)
    got, want = both(lambda t: fxp.quantize(t, fxp.FXP32), edges)
    check("quantize edges", got, want)
    require(got.tolist() == [2147483647, -2147483648, 0, 2147483647, -2147483648, 0, 2, 2],
            f"fxp_raw quantize edges {got.tolist()}")
    a = rng.uniform(-4, 4, (128, 400)).astype(np.float32)
    w = rng.uniform(-2, 2, (400, 300)).astype(np.float32)
    ar, wr = (fxp.quantize(torch.from_numpy(v), fxp.FXP32).numpy() for v in (a, w))
    for name, v in (("quantize a", a), ("quantize w", w)):
        check(name, *both(lambda t: fxp.quantize(t, fxp.FXP32), v))
    acc = ar.astype(np.int64) @ wr.astype(np.int64)
    oracle = np.clip((acc + (1 << 15)) >> 16, fxp.FXP32.raw_min, fxp.FXP32.raw_max).astype(np.int32)
    check("fxp_matmul_raw (128,400)@(400,300)",
          *both(lambda x, y: fxp.fxp_matmul_raw(x, y, fxp.FXP32, fxp.FXP32, fxp.FXP32), ar, wr), oracle)
    ra, rb = (rng.integers(-(2**31), 2**31 - 1, 1 << 16, endpoint=True).astype(np.int32) for _ in range(2))
    prod = (ra.astype(np.int64) * rb + (1 << 15)) >> 16
    check("fxp_mul", *both(lambda x, y: fxp.fxp_mul(x, y, fxp.FXP32, fxp.FXP32, fxp.FXP32), ra, rb),
          np.clip(prod, fxp.FXP32.raw_min, fxp.FXP32.raw_max).astype(np.int32))
    check("fxp_add", *both(lambda x, y: fxp.fxp_add(x, y, fxp.FXP32), ra, rb),
          np.clip(ra.astype(np.int64) + rb, fxp.FXP32.raw_min, fxp.FXP32.raw_max).astype(np.int32))
    xs = np.concatenate([(rng.standard_normal(1 << 16) * 3).astype(np.float32),
                         np.array([1e12, -1e12, np.nan], np.float32)])

    def affine(t, dequant):
        delta, z = fxp.affine_params(torch.full((), -3.0, device=t.device), torch.full((), 3.5, device=t.device), 16)
        q = fxp.affine_quantize(t, delta, z, 16)
        return fxp.affine_dequantize(q, delta, z) if dequant else q

    check("affine_quantize", *both(lambda t: affine(t, False), xs))
    check("affine_dequantize", *both(lambda t: affine(t, True), xs))
    v = (rng.uniform(0.5, 2.0, 1 << 20) * np.exp2(rng.integers(-60, 60, 1 << 20))).astype(np.float32)
    vt = torch.from_numpy(v).to(dev)
    got = sqrt_rn(vt).cpu()
    rn = np.sqrt(v.astype(np.float64)).astype(np.float32)
    require(np.array_equal(got.numpy().view(np.int32), rn.view(np.int32)), "fxp_raw sqrt_rn: not correctly rounded")
    checks["sqrt_rn"] = [1 << 20]
    # the one quotient by a Python number on the card path (kernels/fxp_mlp/ref.py
    # `site_project`, monitor phase: rint(clip(x·2^16)) / 2^16): PyTorch multiplies
    # by the reciprocal, exact for a power of two, so it must be the IEEE quotient
    from repro_torch.kernels.fxp_mlp.ref import site_project

    q = torch.from_numpy(np.concatenate([
        rng.integers(-(2**31), 2**31, 1 << 19).astype(np.float32),
        (rng.standard_normal(1 << 19) * np.exp2(rng.integers(-30, 30, 1 << 19))).astype(np.float32)])).to(dev)
    ieee = (q.double() / 65536.0).float()
    require(_bitwise(q / float(2.0**16), ieee), "fxp_raw: x / 2^16 by a Python number is not the IEEE quotient")
    xq = (q / 65536.0) * 1.37
    got_sp = site_project(xq, False, None, None, n_bits=16, fxp32_phase1=True)
    want_sp = (torch.round(torch.clamp(xq.double() * 65536.0, -2.0**31, 2.0**31 - 1)).float().double() / 65536.0).float()
    require(_bitwise(got_sp, want_sp), "fxp_raw: site_project's 2^16 quotient is not the IEEE quotient")
    checks["quotient by 2^16 (site_project)"] = [1 << 20]
    torch_sqrt_off = int((torch.sqrt(vt).cpu().numpy().view(np.int32) != rn.view(np.int32)).sum())
    scalar_div_off = int((vt / 65535.0 != vt / torch.full((), 65535.0, device=dev)).sum())
    report = {"checks": checks, "tolerance": "bitwise (card = CPU = int64 oracle)",
              "observed": {"float32_torch_sqrt_not_rn_of_2^20": torch_sqrt_off,
                           "quotients_by_python_number_off_ieee_of_2^20": scalar_div_off}}
    emit("fxp_raw", **report)
    return report


def _paper_ddpg(qat_delay: int, backend: str = "pallas"):
    """The paper's DDPG settings (`CONFIG.ddpg`: B = 128, Adam lr 1e-4,
    Q15.16 weights, 16-bit QAT) on `backend`, the QAT delay at `qat_delay`
    updates."""
    from repro_torch.configs.fixar_ddpg import CONFIG

    return dataclasses.replace(CONFIG.ddpg, backend=backend, qat_delay=qat_delay)


def _random_batch(gen: torch.Generator, dev, spec, n: int, mask_rows: int | None = None) -> dict:
    batch = {
        "obs": torch.randn(n, spec.obs_dim, generator=gen).to(dev),
        "action": (torch.rand(n, spec.act_dim, generator=gen) * 2 - 1).to(dev),
        "reward": torch.randn(n, generator=gen).to(dev),
        "next_obs": torch.randn(n, spec.obs_dim, generator=gen).to(dev),
        "done": (torch.rand(n, generator=gen) < 0.05).to(dev),
    }
    if mask_rows is not None:
        batch["mask"] = (torch.arange(n) < mask_rows).to(torch.float32).to(dev)
    return batch


def phase_update(gen: torch.Generator, dev, backend: str = "pallas") -> dict:
    """One `ddpg.update(backend=...)` on the card against the same update by
    the plain versions on the CPU, in the monitor phase and in the quant
    phase (Adam moments warm from earlier updates)."""
    from repro_torch.rl import ddpg
    from repro_torch.rl.envs import make

    spec = make("halfcheetah").spec
    cfg = _paper_ddpg(3, backend)
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
    emit("update" if backend == "pallas" else "update_fused", backend=backend, batch=cfg.batch_size,
         tolerance={"losses": {"rtol": 1e-4, "atol": 1e-5}, "nets": {"rtol": 1e-4, "atol": 2e-5}}, **report)
    return report


def _train_config(seed: int, **kw):
    """`configs/fixar_ddpg.CONFIG` cut in length (TRAIN_CUT), the QAT delay at
    `qat_delay_frac` of the updates; returns (env, cfg, qat_delay, reduced)."""
    from repro_torch.configs.fixar_ddpg import CONFIG
    from repro_torch.rl import loop
    from repro_torch.rl.envs import make

    cfg = loop.TrainConfig(total_steps=TRAIN_CUT["total_steps"], warmup_steps=TRAIN_CUT["warmup_steps"],
                           replay_capacity=100_000, seed=seed, eval_episodes=TRAIN_CUT["eval_episodes"], **kw)
    qat_delay = round(CONFIG.qat_delay_frac * (cfg.total_steps - cfg.warmup_steps + 1))
    reduced = {
        "total_steps": [CONFIG.total_steps, cfg.total_steps],
        "qat_delay": f"{CONFIG.qat_delay_frac} of the updates: {qat_delay}",
        "eval": f"{TRAIN_CUT['eval_episodes']} episodes once at the end (the paper: 10 every 5000 steps)",
    }
    return make(CONFIG.env), cfg, qat_delay, reduced


def _check_trained(agent, updates: int, what: str) -> str:
    require(int(agent.step) == updates, f"{what}: {int(agent.step)} updates, expected {updates}")
    phase = "quant" if bool(agent.qat.quantized_phase) else "monitor"
    require(phase == "quant" and int(agent.qat.step) == updates, f"{what} ended in the {phase} phase")
    for name in ("actor", "critic", "actor_target", "critic_target"):
        for layer in getattr(agent, name).values():
            require(all(bool(torch.isfinite(t).all()) for t in layer.values()), f"{what}: non-finite {name} params")
    return phase


def _steady(tracer, first: int) -> tuple[float, float]:
    """(steps/s over the timesteps from `first` on, p50 of their updates in
    ms) from the `loop.*` spans of `train_host`."""
    spans = [e for e in tracer.events() if e["args"]["step"] >= first]
    upd = [e["dur"] / 1e6 for e in spans if e["name"] == "loop.update"]
    steady_s = (max(e["ts"] + e["dur"] for e in spans) - min(e["ts"] for e in spans)) / 1e6
    return len(upd) / steady_s, statistics.median(upd) * 1e3


def _evaluate_and_serve(env, agent, dcfg, gen: torch.Generator, dev, seed: int) -> dict:
    """`evaluate` the trained agent, then serve TRAIN_CUT["requests"] threaded
    requests from it through `PolicyEngine.from_ddpg`, each reply checked
    against `ddpg.act` by the plain versions on the CPU."""
    from repro_torch.rl import ddpg, loop
    from repro_torch.serve.policy import BatcherConfig, PolicyEngine

    reward = float(loop.evaluate(env, agent, dcfg, torch.Generator(device=dev).manual_seed(seed + 7),
                                 TRAIN_CUT["eval_episodes"]))
    require(math.isfinite(reward), f"evaluate returned {reward}")
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
    return {"eval_reward": reward, "eval_episodes": TRAIN_CUT["eval_episodes"], "served": len(replies),
            "serve_max_abs_err": serve_err}


def _reset_counts() -> None:
    """Every kernel wrapper's count, and the graph replays, to 0."""
    from repro_torch.kernels.fxp_matmul.kernel import fxp_dense_cuda
    from repro_torch.kernels.fxp_mlp.kernel import (ddpg_actor_step_cuda, ddpg_critic_step_cuda, fxp_mlp_bwd_cuda,
                                                    fxp_mlp_fwd_cuda)
    from repro_torch.kernels.quantize.kernel import monitor_quant_cuda
    from repro_torch.rl import loop

    for fn in (fxp_dense_cuda, fxp_mlp_fwd_cuda, fxp_mlp_bwd_cuda, ddpg_critic_step_cuda, ddpg_actor_step_cuda,
               monitor_quant_cuda):
        fn.launches = 0
    fxp_mlp_fwd_cuda.residual_launches = 0
    loop.train_device.graph_replays = 0


def _counts() -> dict:
    from repro_torch.kernels.fxp_mlp.kernel import (ddpg_actor_step_cuda, ddpg_critic_step_cuda, fxp_mlp_bwd_cuda,
                                                    fxp_mlp_fwd_cuda)

    return {"fxp_mlp_fwd": fxp_mlp_fwd_cuda.launches, "fxp_mlp_fwd_residuals": fxp_mlp_fwd_cuda.residual_launches,
            "fxp_mlp_bwd": fxp_mlp_bwd_cuda.launches, "ddpg_critic_step": ddpg_critic_step_cuda.launches,
            "ddpg_actor_step": ddpg_actor_step_cuda.launches}


def _kernels_ran(run) -> tuple:
    """`run()` under `torch.profiler`; returns its result and the calls of
    the training kernels that ran on the card, counted by kernel name in the
    trace (CUDA-graph replays' too), keyed as `_counts` keys them: each
    wrapper call's first CUDA launch (kernel B's instance per call, with
    residuals or not; kernel 3's chain pass; kernel 4's critic pass and
    kernel 5's chain pass), kernel 4's target pass (`ddpg_critic_target`),
    and `reduce_update`, the second pass kernels 4 and 5 share."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        # the trace can lose what runs as it starts (a trace of kernel 6
        # lost its first kernel so; one run of this check lost two whole
        # replays of 1,000 on the H100): a sleep kernel, not counted, and a
        # host wait come first, so the run starts well inside the trace
        torch.cuda._sleep(50_000_000)
        torch.cuda.synchronize()
        time.sleep(0.05)
        out = run()
        # the trace loses kernels that end within a few ms of its stop (on
        # the H100 up to a replay and a half of 250): a ≈ 25 ms sleep kernel
        # and a host wait keep the run's last kernels well inside it
        torch.cuda._sleep(50_000_000)
        torch.cuda.synchronize()
        time.sleep(0.2)
    ran = dict.fromkeys(("fxp_mlp_fwd", "fxp_mlp_fwd_residuals", "fxp_mlp_bwd", "ddpg_critic_target",
                         "ddpg_critic_step", "ddpg_actor_step", "reduce_update"), 0)
    names = {"bwd_chain_kernel": "fxp_mlp_bwd", "ddpg_target_kernel": "ddpg_critic_target",
             "ddpg_critic_kernel": "ddpg_critic_step", "ddpg_actor_kernel": "ddpg_actor_step",
             "reduce_update_kernel": "reduce_update"}
    for e in prof.key_averages():
        if not str(e.device_type).endswith("CUDA"):
            continue
        fwd = re.search(r"fxp_mlp_fwd_kernel<\d+, (true|false),", e.key)  # <BM, SAVE, DEV_PHASE>
        if fwd:
            ran["fxp_mlp_fwd"] += e.count
            ran["fxp_mlp_fwd_residuals"] += e.count if fwd.group(1) == "true" else 0
        for kernel, key in names.items():
            ran[key] += e.count if kernel in e.key else 0
    return out, ran


def phase_train(gen: torch.Generator, dev, seed: int) -> dict:
    """The training main path with backend "pallas" (module docstring), with
    the launch counts of the `train_host` run and its throughput."""
    from repro_torch.obs import Tracer
    from repro_torch.rl import loop

    env, cfg, qat_delay, reduced = _train_config(seed)
    dcfg = _paper_ddpg(qat_delay)
    tracer = Tracer()
    _reset_counts()
    t0 = time.perf_counter()
    ts, info = loop.train_host(env, cfg, dcfg, device=dev, tracer=tracer)
    sync(dev)
    wall = time.perf_counter() - t0
    counts = _counts()
    launches = {"fxp_mlp_fwd": counts["fxp_mlp_fwd"], "fxp_mlp_bwd": counts["fxp_mlp_bwd"]}
    updates = cfg.total_steps - cfg.warmup_steps + 1
    phase = _check_trained(ts.agent, updates, "train")
    steps = cfg.total_steps * max(cfg.n_envs, 1)
    want = {"fxp_mlp_fwd": 5 * updates + cfg.total_steps, "fxp_mlp_bwd": 3 * updates}
    require(launches == want, f"train: launches {launches}, expected {want}")
    steady, p50 = _steady(tracer, cfg.warmup_steps - 1)
    report = {
        "env": env.spec.name, "backend": dcfg.backend, "batch": dcfg.batch_size, "reduced": reduced,
        "env_steps": steps, "updates": updates, "qat_delay": qat_delay, "phase_at_end": phase, "wall_s": wall,
        "env_steps_per_s": steps / wall, "updates_per_s": updates / wall, "update_ms_p50": p50,
        "steady_steps_per_s": steady, "times": info["times"], "launches": launches, "launches_expected": want,
        "cuda_launches": {"fxp_mlp_fwd": launches["fxp_mlp_fwd"], "fxp_mlp_bwd": 2 * launches["fxp_mlp_bwd"]},
        **_evaluate_and_serve(env, ts.agent, dcfg, gen, dev, seed),
    }
    emit("train", **report)
    return report


def phase_train_fused(gen: torch.Generator, dev, seed: int, pallas: dict) -> dict:
    """The slice-3 training path: the same cut configuration through
    `train_host` with backend "pallas_fused_step" (kernels 4 and 5 once per
    update each, kernel B once per timestep, kernel 3 and kernel B's
    residual mode never), then through `train_device`: the warmup window
    eagerly, the updating timesteps as replays of one captured CUDA graph,
    the QAT delay crossed inside the graph's window.  Wrapper counts there
    are the eager calls plus the one captured call, which records its
    launches and runs none; the replays run them.  So the same run is made
    again with its graph window under `torch.profiler`, which counts by
    name the kernels the replays ran: each replay must run kernels 4, 5
    and B once each, and the rerun must end on the same agent.  Both
    agents are evaluated and the graph-trained one is served."""
    from repro_torch.obs import Tracer
    from repro_torch.rl import loop

    env, cfg, qat_delay, reduced = _train_config(seed, eval_every=TRAIN_CUT["warmup_steps"])
    dcfg = _paper_ddpg(qat_delay, "pallas_fused_step")
    updates = cfg.total_steps - cfg.warmup_steps + 1
    steps = cfg.total_steps * max(cfg.n_envs, 1)

    # ---- train_host, fused backend ------------------------------------------
    tracer = Tracer()
    _reset_counts()
    t0 = time.perf_counter()
    ts_h, info = loop.train_host(env, cfg, dcfg, device=dev, tracer=tracer)
    sync(dev)
    wall_h = time.perf_counter() - t0
    host_counts = _counts()
    want_h = {"fxp_mlp_fwd": cfg.total_steps, "fxp_mlp_fwd_residuals": 0, "fxp_mlp_bwd": 0,
              "ddpg_critic_step": updates, "ddpg_actor_step": updates}
    require(host_counts == want_h, f"train_fused host: launches {host_counts}, expected {want_h}")
    _check_trained(ts_h.agent, updates, "train_fused host")
    steady_h, p50_h = _steady(tracer, cfg.warmup_steps - 1)

    # ---- train_device: eager warmup window, then graph replays -------------
    _reset_counts()
    t0 = time.perf_counter()
    ts_d, hist = loop.train_device(env, cfg, dcfg, device=dev, eval_fn=lambda *a: torch.zeros(()))
    sync(dev)
    wall_d = time.perf_counter() - t0
    dev_counts = _counts()
    replays = loop.train_device.graph_replays
    require(replays == updates - 1, f"train_device: {replays} graph replays, expected {updates - 1}")
    want_d = {"fxp_mlp_fwd": cfg.warmup_steps + 1, "fxp_mlp_fwd_residuals": 0, "fxp_mlp_bwd": 0,
              "ddpg_critic_step": 2, "ddpg_actor_step": 2}
    require(dev_counts == want_d, f"train_device: wrapper calls {dev_counts}, expected {want_d}")
    _check_trained(ts_d.agent, updates, "train_device")
    # the same run again, its graph window under the profiler (the capture
    # before it): the kernels the replays ran, by name
    win = loop._Window(loop.init_train_state(env, cfg, dcfg, device=dev), env, cfg, dcfg)
    win.run(0, cfg.warmup_steps)  # the first window, eager; its last step is the first update
    win._capture()  # records the updating timestep and runs none of it
    ran, parts = {}, []
    for first in range(cfg.warmup_steps, cfg.total_steps, 250):  # a trace of 250 replays is ≈ 120k kernels
        _, part = _kernels_ran(lambda first=first: win.run(first, min(250, cfg.total_steps - first)))
        ran = {k: ran.get(k, 0) + v for k, v in part.items()}
        parts.append(part["fxp_mlp_fwd"])
    want_ran = {"fxp_mlp_fwd": replays, "fxp_mlp_fwd_residuals": 0, "fxp_mlp_bwd": 0, "ddpg_critic_target": replays,
                "ddpg_critic_step": replays, "ddpg_actor_step": replays, "reduce_update": 2 * replays}
    require(ran == want_ran and loop.train_device.graph_replays == 2 * replays,
            f"train_device graph window: kernels that ran {ran}, expected {want_ran} "
            f"(kernel B by trace of 250 replays: {parts})")
    rerun_same = all(torch.equal(getattr(win.ts.agent, n)[layer][leaf], getattr(ts_d.agent, n)[layer][leaf])
                     for n in ("actor", "critic") for layer in getattr(ts_d.agent, n) for leaf in ("w", "b"))
    require(rerun_same, "train_device: the profiled rerun ended on another agent")
    # eager launches (the wrapper calls but the captured one) and the traced replays' kernels
    executed = {k: v - (1 if v else 0) + ran[k] for k, v in dev_counts.items()}
    require(hist["step"] == [cfg.warmup_steps, cfg.total_steps], f"train_device windows {hist['step']}")
    # the two drivers ran one program from one seed: how far apart they end
    drift = max(float((getattr(ts_d.agent, n)[layer][leaf] - getattr(ts_h.agent, n)[layer][leaf]).abs().max())
                for n in ("actor", "critic") for layer in getattr(ts_h.agent, n) for leaf in ("w", "b"))
    same_replay = bool(torch.equal(ts_d.buf.reward, ts_h.buf.reward))
    # had a replay drawn the captured step's numbers again (the generators
    # not registered), the rewards the two drivers stored would part ways
    require(same_replay and drift <= 8 * 2.0**-16,
            f"train_device and train_host parted: rewards equal {same_replay}, params {drift} apart")

    report = {
        "env": env.spec.name, "backend": dcfg.backend, "batch": dcfg.batch_size, "reduced": reduced,
        "env_steps": steps, "updates": updates, "qat_delay": qat_delay,
        "train_host": {
            "wall_s": wall_h, "env_steps_per_s": steps / wall_h, "updates_per_s": updates / wall_h,
            "steady_steps_per_s": steady_h, "update_ms_p50": p50_h, "times": info["times"], "launches": host_counts,
            **_evaluate_and_serve(env, ts_h.agent, dcfg, gen, dev, seed),
        },
        "train_device": {
            "wall_s": wall_d, "env_steps_per_s": steps / wall_d, "windows": hist["step"],
            "steady_steps_per_s": hist["ips"][-1], "updates_per_s_steady": hist["updates_per_s"][-1],
            "timestep_ms_steady": 1e3 / hist["ips"][-1], "train_reward": hist["train_reward"],
            "graph_replays": replays, "wrapper_calls": dev_counts, "captured_calls": 1,
            "replay_kernels_traced": ran, "executed": executed,
            "executed_how": "eager wrapper launches + kernels counted by name in a torch.profiler trace of the "
                            "graph window of a second, identical run (its agent bitwise the first's)",
            **_evaluate_and_serve(env, ts_d.agent, dcfg, gen, dev, seed),
        },
        "pallas": {"steady_steps_per_s": pallas["steady_steps_per_s"], "update_ms_p50": pallas["update_ms_p50"]},
        "device_vs_host_max_param_diff": drift, "device_vs_host_rewards_bitwise": same_replay,
    }
    emit("train_fused", **report)
    return report, ts_h.agent


def _host_batch(rng: np.random.Generator, spec, n: int) -> dict:
    """A host update request of `n` transitions (numpy, as producers send)."""
    return {
        "obs": (rng.normal(size=(n, spec.obs_dim)) * 2).astype(np.float32),
        "action": rng.uniform(-1, 1, size=(n, spec.act_dim)).astype(np.float32),
        "reward": rng.normal(size=(n,)).astype(np.float32),
        "next_obs": (rng.normal(size=(n, spec.obs_dim)) * 2).astype(np.float32),
        "done": rng.uniform(size=(n,)) < 0.05,
    }


def _on(batch: dict, dev) -> dict:
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


@contextlib.contextmanager
def _tally(acc: dict):
    """Add the wrapper launches made inside the block to `acc`."""
    before = _counts()
    try:
        yield
    finally:
        for k, v in _counts().items():
            acc[k] = acc.get(k, 0) + v - before[k]


def _same_state(a, b) -> str:
    """'' when two states are bitwise equal leaf by leaf (dtypes too), else
    the first leaf that differs."""
    from repro_torch import tree

    pa, pb = tree.flatten_with_path(a), tree.flatten_with_path(b)
    if [p for p, _ in pa] != [p for p, _ in pb]:
        return "the trees differ"
    for (path, x), (_, y) in zip(pa, pb):
        if x.dtype != y.dtype or not torch.equal(x, y):
            return path
    return ""


def _learner_case(state, batch: dict, cfg) -> dict:
    """A kernel-4/5 case (as `_step_case` makes them) from a learner's state
    and a padded host batch: what `ddpg.update(backend="pallas_fused_step")`
    hands the two kernels."""
    from repro_torch.core.qat import QATContext
    from repro_torch.kernels.fxp_mlp.ops import _hyper
    from repro_torch.optim import adam, fxp_adam
    from repro_torch.rl import ddpg

    dev = state.step.device
    require(cfg.fxp_weights and cfg.actor_lr == cfg.critic_lr and int(state.actor_opt.step) == int(state.critic_opt.step),
            "learner case: one set of step constants serves both kernels only with equal rates and steps")
    b = _on(batch, dev)
    wb = lambda p: ddpg._params_to_wb(p, len(ddpg.ACTOR_ACTS))  # noqa: E731
    deltas, zs = QATContext(state.qat).site_quant_params(ddpg.ACTOR_SITES + ddpg.CRITIC_SITES)
    w = b["mask"] if "mask" in b else torch.ones(b["obs"].shape[0], dtype=torch.float32, device=dev)
    consts = adam.step_constants(fxp_adam.FxpAdamConfig(lr=cfg.critic_lr), state.critic_opt.step + 1)
    return {
        "obs": b["obs"], "action": b["action"], "reward": b["reward"], "done": b["done"].to(torch.float32),
        "next_obs": b["next_obs"], "w": w,
        "actor": wb(state.actor), "actor_t": wb(state.actor_target), "actor_m": wb(state.actor_opt.mu),
        "actor_v": wb(state.actor_opt.nu), "critic": wb(state.critic), "critic_t": wb(state.critic_target),
        "critic_m": wb(state.critic_opt.mu), "critic_v": wb(state.critic_opt.nu),
        "deltas": deltas.contiguous(), "zs": zs.to(torch.float32).contiguous(),
        "hyper": _hyper(1.0 / torch.clamp(w.sum(), min=1.0), cfg.gamma, cfg.tau, consts),
        "kw": dict(actor_acts=ddpg.ACTOR_ACTS, critic_acts=ddpg.CRITIC_ACTS, n_bits=state.qat.config.n_bits,
                   qat=state.qat.config.enabled, fxp32_phase1=state.qat.config.fxp32_phase1, fxp_weights=True),
    }


def _max_err(a: dict, b: dict) -> float:
    from repro_torch import tree

    return max(float((x.double() - y.double()).abs().max()) for x, y in zip(tree.leaves(a), tree.leaves(b)))


def _http_get(url: str) -> tuple[int, str]:
    """(status, body) of a GET on the local telemetry endpoint."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=10.0) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as err:
        return err.code, err.read().decode()


# the wrapper launches one update makes, by mode (the `train` phase's and
# `train_fused`'s per-update counts)
LEARNER_PER_UPDATE = {
    "fused": {"fxp_mlp_fwd": 5, "fxp_mlp_bwd": 3, "ddpg_critic_step": 0, "ddpg_actor_step": 0},
    "fused_step": {"fxp_mlp_fwd": 0, "fxp_mlp_bwd": 0, "ddpg_critic_step": 1, "ddpg_actor_step": 1},
}


def _learner_streams(spec, cfg, dev, rng, seed: int, launches: dict) -> tuple[dict, dict]:
    """Parts 1 and 2 of the learner phase (`phase_learner`), per forced
    kernel mode; returns (report, the engines)."""
    from repro_torch.kernels.fxp_mlp import replay
    from repro_torch.rl import ddpg
    from repro_torch.train.learner import TRAIN_BACKENDS, LearnerEngine

    report, engines = {}, {}
    for mode in LEARNER_PER_UPDATE:
        state = ddpg.init(spec, cfg, generator=torch.Generator().manual_seed(seed + 30), device=dev)
        eng = LearnerEngine.from_ddpg(state, cfg, force_mode=mode)
        require(eng.batcher_config.buckets == LEARNER_BUCKETS and eng.device.type == "cuda",
                f"learner {mode}: buckets {eng.batcher_config.buckets} on {eng.device}")
        direct_cfg = dataclasses.replace(cfg, backend=TRAIN_BACKENDS[mode])
        # ---- 1. exact buckets: bitwise the direct calls on the same state sequence
        exact, want = [], state
        for rows in LEARNER_BUCKETS:
            batch, acc = _host_batch(rng, spec, rows), {}
            with _tally(acc):
                got_m = eng.run_update(batch)
            want, want_m = ddpg.update(want, _on(batch, dev), direct_cfg)
            sync(dev)
            diff = _same_state(eng.state, want)
            require(not diff, f"learner {mode} B={rows}: the streamed update differs from the direct call at {diff}")
            require(all(got_m[k] == float(v) for k, v in want_m.items()), f"learner {mode} B={rows}: metrics differ")
            require({k: acc[k] for k in LEARNER_PER_UPDATE[mode]} == LEARNER_PER_UPDATE[mode],
                    f"learner {mode} B={rows}: launches {acc}, expected {LEARNER_PER_UPDATE[mode]}")
            exact.append({"rows": rows, "launches": acc})
            launches.update({k: launches.get(k, 0) + v for k, v in acc.items()})
        # ---- 2. padded requests: bitwise the direct call on the engine's padded
        # batch; within the update contracts the unpadded call at its own rows
        padded_rep = []
        for rows in LEARNER_PADDED:
            batch, start = _host_batch(rng, spec, rows), eng.state
            bucket = eng.batcher_config.bucket_for(rows)
            padded = eng._pad(batch, rows, bucket)
            phase = "quant" if bool(start.qat.quantized_phase) else "monitor"
            with _tally(launches):
                eng.run_update(batch)
            want, _ = ddpg.update(start, _on(padded, dev), direct_cfg)
            unpadded, _ = ddpg.update(start, _on(batch, dev), direct_cfg)
            sync(dev)
            diff = _same_state(eng.state, want)
            require(not diff, f"learner {mode} rows={rows}: the padded update differs from the direct call at {diff}")
            errs = {"params": max(_max_err(getattr(eng.state, n), getattr(unpadded, n)) for n in ("actor", "critic")),
                    "targets": max(_max_err(getattr(eng.state, n), getattr(unpadded, n))
                                   for n in ("actor_target", "critic_target")),
                    "mu": max(_max_err(getattr(eng.state, n).mu, getattr(unpadded, n).mu)
                              for n in ("actor_opt", "critic_opt")),
                    "nu": max(_max_err(getattr(eng.state, n).nu, getattr(unpadded, n).nu)
                              for n in ("actor_opt", "critic_opt"))}
            require(errs["params"] <= replay.STEP_TOL["params"][0] and errs["targets"] <= replay.STEP_TOL["targets"][0],
                    f"learner {mode} rows={rows} (bucket {bucket}, {phase}): the padded update is {errs} from the "
                    "unpadded one: a zero-weight row did not add exactly zero")
            entry = {"rows": rows, "bucket": bucket, "phase": phase, "max_abs_vs_unpadded": errs}
            if mode == "fused_step":
                # the moments: kernels 4 and 5 on this padded case against their
                # twins, through the float64 operand replay, as kernel_step holds them
                pair = _step_pair(_learner_case(start, padded, cfg), bucket, phase, f"learner rows={rows}", edge=True,
                                  moved=False)
                entry["kernel_step_check"] = {name: {"max_abs": res["max_abs"], "twin_moved_least": res["moved"],
                                                     "replay": res["replay"]} for name, (_, res) in pair.items()}
            padded_rep.append(entry)
        batch, start = _host_batch(rng, spec, LEARNER_CHUNKED), eng.state
        with _tally(launches):
            got_m = eng.run_update(batch)
        want, cap = start, eng.batcher_config.max_batch
        for lo in range(0, LEARNER_CHUNKED, cap):
            n = min(cap, LEARNER_CHUNKED - lo)
            part = {k: v[lo : lo + n] for k, v in batch.items()}
            want, _ = ddpg.update(want, _on(eng._pad(part, n, eng.batcher_config.bucket_for(n)), dev), direct_cfg)
        sync(dev)
        diff = _same_state(eng.state, want)
        require(got_m["chunks"] == 3 and not diff,
                f"learner {mode} rows={LEARNER_CHUNKED}: {got_m['chunks']} chunks, state differs at {diff!r}")
        report[mode] = {"exact": exact, "padded": padded_rep,
                        "chunked": {"rows": LEARNER_CHUNKED, "chunks": [128, 128, 44], "bitwise": True},
                        "updates": int(eng.state.step)}
        engines[mode] = eng
    return report, engines


def _learner_threads(spec, cfg, dev, rng, seed: int, launches: dict) -> dict:
    """Parts 3 and 5: producer threads into the adaptive learner, its
    registry and health over HTTP, the SLO rules and a fleet view."""
    from repro_torch.obs import FleetAggregator, Observability, SLOWatchdog, as_wire, default_rules
    from repro_torch.rl import ddpg
    from repro_torch.runtime.engine import BatcherConfig
    from repro_torch.train.learner import LearnerEngine

    rows = [int(r) for r in rng.integers(LEARNER_ROWS[0], LEARNER_ROWS[1] + 1, size=LEARNER_REQUESTS)]
    batches = [_host_batch(rng, spec, r) for r in rows]
    obs = Observability(serve_http=0)
    try:
        state = ddpg.init(spec, cfg, generator=torch.Generator().manual_seed(seed + 31), device=dev)
        eng = LearnerEngine.from_ddpg(state, cfg, obs=obs, batcher=BatcherConfig(buckets=LEARNER_BUCKETS,
                                                                                 max_wait_ms=5.0))
        futs, lock = [], threading.Lock()

        def producer(chunk):
            for b in chunk:
                f = eng.submit(b)
                with lock:
                    futs.append(f)

        with _tally(launches):
            warmed = eng.warmup()  # every (bucket, mode) on this thread: no build or first launch on the drain thread
            eng.start()
            code_live, body = _http_get(obs.server.url + "/healthz")
            live = json.loads(body)
            require(code_live == 200 and live["checks"]["learner"]["training"] is True,
                    f"learner /healthz while training: {code_live} {live}")
            threads = [threading.Thread(target=producer, args=(batches[i::LEARNER_THREADS],))
                       for i in range(LEARNER_THREADS)]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
                require(not t.is_alive(), "learner: a producer thread did not finish")
            results = [f.result(timeout=600) for f in futs]
            wall = time.perf_counter() - t0
            eng.stop()
        st = eng.stats()
        finite = all(bool(torch.isfinite(x).all()) for x in (*eng.state.actor["l0"].values(),
                                                            *eng.state.critic["l2"].values()))
        require(len(results) == LEARNER_REQUESTS and st["requests"] == LEARNER_REQUESTS and
                st["transitions"] == sum(rows) and finite and int(eng.state.step) == st["updates"],
                f"learner threads: {len(results)} results, stats {st['requests']} requests "
                f"{st['transitions']} transitions (submitted {sum(rows)}), finite {finite}")
        # ---- 5. fleet telemetry
        code, text = _http_get(obs.server.url + "/metrics")
        series = {ln.rsplit(" ", 1)[0]: ln.rsplit(" ", 1)[1] for ln in text.splitlines() if ln and ln[0] != "#"}
        want = {"learner_requests": LEARNER_REQUESTS, "learner_transitions": sum(rows),
                "learner_updates": st["updates"]}
        require(code == 200 and all(float(series.get(k, "nan")) == v for k, v in want.items()),
                f"learner /metrics: {code}, {[(k, series.get(k)) for k in want]}")
        code_after, body = _http_get(obs.server.url + "/healthz")
        health = json.loads(body)
        require(code_after == (200 if health["ok"] else 503) and health["checks"]["learner"]["training"] is False
                and health["checks"]["learner"]["updates"] == st["updates"], f"learner /healthz after: {health}")
        alerts = SLOWatchdog(default_rules()).evaluate(obs.registry)
        fleet = FleetAggregator()
        host = fleet.ingest(as_wire(obs.registry))
        require(fleet.merged().counter("learner.updates").value == st["updates"], "fleet view lost the learner's updates")
    finally:
        obs.close()
    return {
        "threads": LEARNER_THREADS, "requests": LEARNER_REQUESTS, "rows": {"min": min(rows), "max": max(rows),
                                                                           "sum": sum(rows)},
        "warmed": warmed, "wall_s": wall, "updates": st["updates"], "batch_occupancy": st["batch_occupancy"],
        "p50_ms": st["p50_ms"], "p99_ms": st["p99_ms"], "mode_histogram": st["mode_histogram"],
        "cost_model": st["cost_model"], "dispatch_audit_drift": st["dispatch_audit"]["drift_factor"],
        "telemetry": {"metrics_status": code, "prometheus_series": len(series),
                      "healthz_while_training": code_live, "healthz_after": code_after,
                      "healthz_ok_after": health["ok"], "slo_alerts": [a["rule"] for a in alerts],
                      "fleet_host": host},
    }


def _learner_train_host(dev, seed: int, fused_agent, launches: dict) -> dict:
    """Part 4: `train_fused`'s `train_host` run again through a learner
    forced to "fused_step": its final agent bitwise that run's."""
    from repro_torch.rl import ddpg, loop
    from repro_torch.train.learner import LearnerEngine

    env, cfg, qat_delay, _ = _train_config(seed, eval_every=TRAIN_CUT["warmup_steps"])
    dcfg = _paper_ddpg(qat_delay, "pallas_fused_step")
    seed_state = ddpg.init(env.spec, dcfg, generator=torch.Generator().manual_seed(seed + 32), device=dev)
    learner = LearnerEngine.from_ddpg(seed_state, dcfg, force_mode="fused_step")
    acc = {}
    t0 = time.perf_counter()
    with _tally(acc):
        ts, info = loop.train_host(env, cfg, dcfg, device=dev, learner=learner)
        sync(dev)
    wall = time.perf_counter() - t0
    updates = cfg.total_steps - cfg.warmup_steps + 1
    want = {"fxp_mlp_fwd": cfg.total_steps, "fxp_mlp_fwd_residuals": 0, "fxp_mlp_bwd": 0,
            "ddpg_critic_step": updates, "ddpg_actor_step": updates}
    require(acc == want, f"learner train_host: launches {acc}, expected {want}")
    diff = _same_state(ts.agent, fused_agent)
    require(not diff and ts.agent is learner.state,
            f"train_host(learner=) ended on another agent than train_fused's train_host: {diff}")
    launches.update({k: launches.get(k, 0) + v for k, v in acc.items()})
    st = learner.stats()
    return {"env_steps": cfg.total_steps, "updates": updates, "wall_s": wall, "env_steps_per_s": cfg.total_steps / wall,
            "times": info["times"], "learner_updates": st["updates"], "mode_histogram": st["mode_histogram"],
            "bitwise_train_fused_agent": True, "launches": acc}


def _learner_checkpoint(spec, cfg, dev, rng, seed: int, state) -> dict:
    """Part 6: a learner's state saved and restored on the card into a
    fresh template, bitwise; one more update from each, bitwise."""
    import shutil

    from repro_torch.checkpoint import ckpt
    from repro_torch.rl import ddpg
    from repro_torch.train.learner import LearnerEngine

    root = REPO / "build" / "learner_ckpt"
    shutil.rmtree(root, ignore_errors=True)
    try:
        path = ckpt.save(root, int(state.step), state, extra={"mode": "fused_step"})
        manifest = json.loads((path / "manifest.json").read_text())
        template = ddpg.init(spec, cfg, generator=torch.Generator().manual_seed(seed + 33), device=dev)
        restored, step, extra = ckpt.restore(root, template, device=dev)
        diff = _same_state(restored, state)
        require(not diff and step == int(state.step) and extra == {"mode": "fused_step"},
                f"checkpoint: restored state differs at {diff!r} (step {step}, extra {extra})")
        batch = _host_batch(rng, spec, 128)
        a, b = (LearnerEngine.from_ddpg(s, cfg, force_mode="fused_step") for s in (state, restored))
        a.run_update(batch)
        b.run_update(batch)
        diff = _same_state(a.state, b.state)
        require(not diff, f"checkpoint: an update from the restored state differs at {diff}")
        dtypes = sorted({leaf["dtype"] for leaf in manifest["leaves"]})
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {"leaves": len(manifest["leaves"]), "dtypes": dtypes, "step": step, "restored_bitwise": True,
            "next_update_bitwise": True}


def _learner_throughput(spec, cfg, dev, rng, seed: int, launches: dict) -> dict:
    """Part 7: per forced mode at bucket 128, updates/s and train IPS of
    the learner, beside direct `ddpg.update` calls on the same host
    batches, alternating update by update (so the learner's own cost per
    update); then 16 requests of 8 rows coalesced into one bucket-128
    update against 16 direct B = 8 updates, per kernel mode."""
    from repro_torch.rl import ddpg
    from repro_torch.runtime.engine import BatcherConfig
    from repro_torch.train.learner import TRAIN_BACKENDS, LearnerEngine

    per_mode = {}
    for mode in ("fused_step", "fused", "jnp"):
        state = ddpg.init(spec, cfg, generator=torch.Generator().manual_seed(seed + 34), device=dev)
        eng = LearnerEngine.from_ddpg(state, cfg, force_mode=mode)
        direct_cfg = dataclasses.replace(cfg, backend=TRAIN_BACKENDS[mode])
        eng.warmup(buckets=(128,))
        ddpg.update(state, _on(_host_batch(rng, spec, 128), dev), direct_cfg)
        sync(dev)
        eng.reset_stats()
        direct, t_eng, t_dir = state, [], []
        for _ in range(LEARNER_TIMED["updates"]):
            batch = _host_batch(rng, spec, 128)
            t0 = time.perf_counter()
            with _tally(launches):
                eng.run_update(batch)
            t_eng.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            direct, metrics = ddpg.update(direct, _on(batch, dev), direct_cfg)
            float(metrics["critic_loss"])  # the learner reads its metrics on the host too
            sync(dev)
            t_dir.append(time.perf_counter() - t0)
        require(not _same_state(eng.state, direct), f"learner {mode}: timed stream parted from the direct calls")
        st = eng.stats()
        med_e, med_d = statistics.median(t_eng), statistics.median(t_dir)
        per_mode[mode] = {"bucket": 128, "updates": LEARNER_TIMED["updates"],
                          "updates_per_s_device": st["updates_per_s_device"], "train_ips_device": st["train_ips_device"],
                          "updates_per_s_wall": len(t_eng) / sum(t_eng), "train_ips_wall": 128 * len(t_eng) / sum(t_eng),
                          "update_ms_p50": med_e * 1e3, "direct_update_ms_p50": med_d * 1e3,
                          "learner_overhead_ms_p50": (med_e - med_d) * 1e3}
    coalesced = {}
    n_req, rows = LEARNER_COALESCE
    for mode in ("fused_step", "fused"):
        state = ddpg.init(spec, cfg, generator=torch.Generator().manual_seed(seed + 35), device=dev)
        eng = LearnerEngine.from_ddpg(state, cfg, force_mode=mode,
                                      batcher=BatcherConfig(buckets=LEARNER_BUCKETS, max_wait_ms=50.0))
        direct_cfg = dataclasses.replace(cfg, backend=TRAIN_BACKENDS[mode])
        eng.warmup(buckets=(8, 128))
        direct, t_coal, t_dir = state, [], []
        eng.start()
        try:
            for _ in range(LEARNER_TIMED["rounds"]):
                reqs = [_host_batch(rng, spec, rows) for _ in range(n_req)]
                t0 = time.perf_counter()
                with _tally(launches):
                    futs = [eng.submit(r) for r in reqs]
                    for f in futs:
                        f.result(timeout=120)
                t_coal.append(time.perf_counter() - t0)
                t0 = time.perf_counter()
                for r in reqs:
                    direct, metrics = ddpg.update(direct, _on(r, dev), direct_cfg)
                    float(metrics["critic_loss"])
                sync(dev)
                t_dir.append(time.perf_counter() - t0)
        finally:
            eng.stop()
        st = eng.stats()
        med_c, med_d = statistics.median(t_coal), statistics.median(t_dir)
        coalesced[mode] = {
            "requests": n_req, "rows": rows, "rounds": LEARNER_TIMED["rounds"],
            "coalesced_updates": st["updates"], "batch_occupancy": st["batch_occupancy"],
            "coalesced": {"updates_per_s": 1.0 / med_c * st["updates"] / LEARNER_TIMED["rounds"],
                          "train_ips": n_req * rows / med_c, "round_ms_p50": med_c * 1e3},
            "direct_b8": {"updates_per_s": n_req / med_d, "train_ips": n_req * rows / med_d,
                          "round_ms_p50": med_d * 1e3},
            "train_ips_ratio": med_d / med_c,
        }
    return {"per_mode": per_mode, "coalesce_16x8": coalesced}


def phase_learner(dev, seed: int, fused_agent) -> dict:
    """The learner engine (`train.learner.LearnerEngine`) at the paper's
    nets on the card (module docstring, phase 16).  Fails on any part."""
    from repro_torch.rl.envs import make

    spec = make("halfcheetah").spec
    cfg = _paper_ddpg(4, "pallas_fused_step")  # the QAT delay crossed inside part 2
    rng = np.random.default_rng(seed + 18)  # its own stream: later phases keep their inputs
    launches: dict = {}
    streams, engines = _learner_streams(spec, cfg, dev, rng, seed, launches)
    threads = _learner_threads(spec, cfg, dev, rng, seed, launches)
    host = _learner_train_host(dev, seed, fused_agent, launches)
    checkpoint = _learner_checkpoint(spec, cfg, dev, rng, seed, engines["fused_step"].state)
    throughput = _learner_throughput(spec, cfg, dev, rng, seed, launches)
    for name in ("fxp_mlp_fwd", "fxp_mlp_bwd", "ddpg_critic_step", "ddpg_actor_step"):
        require(launches.get(name, 0) > 0, f"learner: kernel {name} never launched on the learner's path")
    report = {"nets": {"actor": list(ACTOR_DIMS), "critic": list(CRITIC_DIMS)}, "buckets": list(LEARNER_BUCKETS),
              "streams": streams, "threads": threads, "train_host": host, "checkpoint": checkpoint,
              "throughput": throughput, "launches": launches,
              "tolerance": {"streams": "bitwise", "padded_vs_unpadded": {"params": 2.0**-16, "targets": 1e-6},
                            "fused_step_moments": "kernel_step's check (replay.check_step) on the padded case"}}
    emit("learner", **report)
    return report


def _profile(run, steps: int, wall_per: str) -> dict:
    """`torch.profiler` over `run()` (`steps` steps): host wall and device
    busy time per step (so the device's idle share), kernels and CUDA
    runtime calls per step, the costliest kernels and host ops."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    def dev_us(e) -> float:
        return float(getattr(e, "self_device_time_total", 0.0) or getattr(e, "self_cuda_time_total", 0.0))

    events = prof.key_averages()
    kernels = [e for e in events if str(e.device_type).endswith("CUDA")]
    device_us = sum(dev_us(e) for e in kernels)
    runtime = sorted((e for e in events if e.key.startswith("cuda")), key=lambda e: -e.count)
    host_ops = sorted((e for e in events if not str(e.device_type).endswith("CUDA")),
                      key=lambda e: -e.self_cpu_time_total)
    per = 1.0 / steps
    return {
        "steps": steps, f"wall_ms_per_{wall_per}": wall * 1e3 * per,
        f"device_busy_ms_per_{wall_per}": device_us / 1e3 * per if device_us else None,
        "device_idle_share": 1.0 - device_us / 1e6 / wall if device_us else None,
        f"kernels_per_{wall_per}": sum(e.count for e in kernels) * per,
        f"runtime_calls_per_{wall_per}": {e.key: e.count * per for e in runtime[:8]},
        f"top_kernels_ms_per_{wall_per}": {e.key[:60]: dev_us(e) / 1e3 * per
                                           for e in sorted(kernels, key=lambda e: -dev_us(e))[:8]},
        f"top_host_ops_ms_per_{wall_per}": {e.key[:60]: e.self_cpu_time_total / 1e3 * per for e in host_ops[:10]},
    }


def phase_profile(gen: torch.Generator, dev, updates: int = 20) -> dict:
    """Where the time goes: `torch.profiler` over `updates` calls of
    `ddpg.update` at B = 128 with backend "pallas" and with
    "pallas_fused_step" (the QAT delay halfway, so both phases), and over
    `updates` replays of `train_device`'s captured timestep (act, env step,
    replay store and sample, fused update); then the host wall time of
    single synchronised replays (p50)."""
    from repro_torch.rl import ddpg, loop
    from repro_torch.rl.envs import make

    spec = make("halfcheetah").spec
    report = {"updates": updates, "batch": _paper_ddpg(0).batch_size,
              "note": "the profiler's own cost is in the wall time; device time is the sum of kernel times"}
    for backend in ("pallas", "pallas_fused_step"):
        cfg = _paper_ddpg(3 + updates // 2, backend)
        state = ddpg.init(spec, cfg, generator=gen, device=dev)
        batches = [_random_batch(gen, dev, spec, cfg.batch_size) for _ in range(updates + 3)]
        for b in batches[:3]:
            state, _ = ddpg.update(state, b, cfg)
        sync(dev)
        box = [state]

        def run(box=box, batches=batches, cfg=cfg):
            for b in batches[3:]:
                box[0], _ = ddpg.update(box[0], b, cfg)

        report[backend] = _profile(run, updates, "update")
        require(bool(box[0].qat.quantized_phase), f"profile {backend}: the QAT delay was not crossed")

    # the captured timestep of train_device
    env = make("halfcheetah")
    cfg = loop.TrainConfig(total_steps=10**6, warmup_steps=256, replay_capacity=100_000, seed=1)
    dcfg = _paper_ddpg(updates // 2, "pallas_fused_step")
    win = loop._Window(loop.init_train_state(env, cfg, dcfg, device=dev), env, cfg, dcfg)
    win.run(0, cfg.warmup_steps + 1)  # the warmup, the eager updating step, the capture and one replay
    report["graph_timestep"] = _profile(lambda: win.run(cfg.warmup_steps + 1, updates), updates, "timestep")
    times = []
    for i in range(50):
        t0 = time.perf_counter()
        win.run(cfg.warmup_steps + 1 + updates + i, 1)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    report["graph_timestep"]["synced_timestep_ms_p50"] = statistics.median(times)
    require(bool(win.ts.agent.qat.quantized_phase), "profile: the graph's QAT delay was not crossed")
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


def _pass_us(fn, calls: int = 50) -> dict:
    """Device µs per call of each pass of kernels 3, 4 and 5 that `fn`
    launches (the chain passes and pass 2), by kernel name in a
    torch.profiler trace of `calls` back-to-back calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda._sleep(50_000_000)  # keeps the last calls' kernels inside the trace (`_kernels_ran`)
        torch.cuda.synchronize()
        time.sleep(0.2)
    out = {}
    for e in prof.key_averages():
        us = float(getattr(e, "self_device_time_total", 0.0) or getattr(e, "self_cuda_time_total", 0.0))
        # (critic_chain_kernel, actor_chain_kernel: the chain passes before PR 16, timed by tools/ab_times.py)
        for name in ("ddpg_target_kernel", "ddpg_critic_kernel", "ddpg_actor_kernel", "reduce_update_kernel",
                     "critic_chain_kernel", "actor_chain_kernel", "bwd_chain_kernel", "bwd_dw_kernel"):
            if name in e.key:
                out[name] = out.get(name, 0.0) + us / calls
    return out


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
    extra = _extra(gen)
    for batch in TIME_BATCHES:
        g = extra if batch == 8 else gen  # B = 8 joined the rows in PR 15
        x = (torch.randn(batch, ACTOR_DIMS[0], generator=g) * 2).to(dev)
        # per-layer inputs of the chain, so each layer is timed on its own shape
        inputs = [x]
        for (w, b), a in zip(layers[:-1], acts):
            inputs.append(ref_fxp_dense(inputs[-1], w, b, activation=a))
        limbs = [limb_split(xi) for xi in inputs]
        for full in (True, False):
            passes = 2 if full else 1
            macs = sum(batch * w.shape[0] * w.shape[1] for w in ws)
            phase = "full" if full else "half"

            # kernel A: the three-layer chain of the `layer` mode, then each layer
            def chain_kernel(sel=range(len(layers))):
                for i in sel:
                    fxp_dense_cuda(inputs[i], *layers[i], full_precision=full, activation=acts[i])

            def chain_plain(sel=range(len(layers))):
                for i in sel:
                    ref_fxp_dense(inputs[i], *layers[i], full_precision=full, activation=acts[i])

            def chain_library(sel=range(len(layers))):
                for i in sel:
                    (hi, lo), (w, b) = limbs[i], layers[i]
                    acc = torch.addmm(b, hi, w)
                    if full:
                        acc = torch.addmm(acc, lo, w)
                    act_fn[acts[i]](acc)

            for sel, shape in [(range(len(layers)), "chain 17-400-300-6")] + [
                    ((i,), f"layer {ws[i].shape[0]}x{ws[i].shape[1]}") for i in range(len(layers))]:
                a_bytes = 4 * sum(inputs[i].numel() + ws[i].numel() + bs[i].numel() + batch * ws[i].shape[1]
                                  for i in sel)
                a_bound, a_by = _bound_ms(a_bytes, 2 * passes * sum(batch * ws[i].numel() for i in sel), dev_info)
                rows.append({
                    "kernel": "fxp_dense", "shape": shape, "batch": batch, "phase": phase,
                    "ms": device_time_ms(lambda: chain_kernel(sel), 100),
                    "plain_ms": device_time_ms(lambda: chain_plain(sel), 20),
                    "library_ms": device_time_ms(lambda: chain_library(sel), 20),
                    "bound_ms": a_bound, "bound_by": a_by, "launches_per_call": len(sel),
                })

            # kernel B: the whole network in one launch, QAT sites on; bytes:
            # x, the parameters and deltas/zs read once, y and the 2·L site
            # extrema (the function's outputs) written once
            kw = dict(activations=acts, quant=not full, qat=True, n_bits=16, fxp32_phase1=True)
            b_bytes = 4 * (x.numel() + n_params + batch * ACTOR_DIMS[-1] + 2 * len(ws) + 2 * len(ws))
            b_bound, b_by = _bound_ms(b_bytes, 2 * passes * macs, dev_info)
            b_row = {
                "kernel": "fxp_mlp_fwd", "shape": "17-400-300-6", "batch": batch,
                "phase": "monitor (full)" if full else "quant (half)",
                "ms": device_time_ms(lambda: fxp_mlp_fwd_cuda(x, ws, bs, deltas, zs, **kw), 100),
                "plain_ms": device_time_ms(lambda: ref_mlp_forward(x, ws, bs, deltas, zs, **kw), 20),
                "library_ms": None,
                "bound_ms": b_bound, "bound_by": b_by, "launches_per_call": 1,
            }
            rows.append(b_row)
            if batch == 1:
                # the device-phase instance: the launch a captured timestep replays when acting
                phase_t = torch.full((1,), int(not full), dtype=torch.int32, device=dev)
                rows.append({**b_row, "shape": "17-400-300-6, device phase",
                             "ms": device_time_ms(lambda: fxp_mlp_fwd_cuda(x, ws, bs, deltas, zs, phase=phase_t,
                                                                           **kw), 100)})
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
            f_bytes = 4 * (x.numel() + w_elems + b_elems + batch * dims[-1] + 2 * len(nws) + 2 * len(nws)
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
                # a long sleep: the host may take longer to enqueue a call than the card to run it
                "ms": device_time_ms(lambda: fxp_mlp_bwd_cuda(g, x, nws, qs, hs, nd, nz, **kw), 100,
                                     sleep_cycles=400_000_000),
                "plain_ms": device_time_ms(lambda: ref_mlp_backward(g, x, nws, qs, hs, nd, nz, **kw), 20),
                "library_ms": None, "bound_ms": k_bound, "bound_by": k_by, "launches_per_call": 1,
                "cuda_launches_per_call": 2,
                "pass_us": _pass_us(lambda: fxp_mlp_bwd_cuda(g, x, nws, qs, hs, nd, nz, **kw)),
            })
    # kernels 4 and 5 at the training batch: bytes each input read once and
    # each output written once; operations the forwards (2 passes in the
    # monitor phase), the backward products this step needs, and ≈ 23 f32
    # operations a parameter in the epilogue (projections, Adam, soft update)
    from repro_torch.kernels.fxp_mlp import kernel as step_kernel
    from repro_torch.kernels.fxp_mlp.kernel import ddpg_actor_step_cuda, ddpg_critic_step_cuda
    from repro_torch.kernels.fxp_mlp.ref import ref_ddpg_actor_step, ref_ddpg_critic_step

    (a_dims, _), (c_dims, _) = NETS["actor"], NETS["critic"]
    obs, act = a_dims[0], a_dims[-1]
    macs = lambda d: sum(k * n for k, n in zip(d[:-1], d[1:]))  # noqa: E731
    elems = lambda d: macs(d) + sum(d[1:])  # noqa: E731  parameters of a net
    # monitor rows; a tree before PR 16 (tools/ab_times.py --smoke) wrote one per 8 rows
    rows_of = getattr(step_kernel, "step_monitor_rows", lambda m, a, c, w: -(-m // 8))
    rows4, rows5 = (rows_of(batch, a_dims, c_dims, w) for w in ("critic", "actor"))
    c = _step_case(gen, dev, batch, 0)
    for case in ("monitor", "quant"):
        quant = case == "quant"
        passes = 1 if quant else 2
        phase_t = torch.full((1,), int(quant), dtype=torch.int32, device=dev)
        shared = 4 * (12 + 12 + 1)  # deltas, zs, hyper, phase
        flops4 = (2 * batch * passes * (macs(a_dims) + 2 * macs(c_dims))
                  + 2 * batch * (2 * macs(c_dims) - c_dims[0] * c_dims[1]) + 23 * elems(c_dims))
        bytes4 = 4 * (batch * (2 * obs + act + 3) + elems(a_dims) + 8 * elems(c_dims) + rows4 * 8) + shared
        flops5 = (2 * batch * passes * (macs(a_dims) + macs(c_dims))
                  + 2 * batch * (macs(c_dims) - c_dims[0] * c_dims[1] + act * c_dims[1])
                  + 2 * batch * (2 * macs(a_dims) - a_dims[0] * a_dims[1]) + 23 * elems(a_dims))
        bytes5 = 4 * (batch * (obs + 1) + 8 * elems(a_dims) + elems(c_dims) + rows5 * 13) + shared
        for name, kernel, twin, args, flops, nbytes in (
            ("ddpg_critic_step", ddpg_critic_step_cuda, ref_ddpg_critic_step, _critic_args(c), flops4, bytes4),
            ("ddpg_actor_step", ddpg_actor_step_cuda, ref_ddpg_actor_step, _actor_args(c, c["critic"]), flops5,
             bytes5),
        ):
            bound, by = _bound_ms(nbytes, flops, dev_info)
            rows.append({
                "kernel": name, "shape": "actor 17-400-300-6, critic 23-400-300-1", "batch": batch, "phase": case,
                # the host takes longer to enqueue a call than the card to run
                # it: a long sleep lets the host enqueue all 100 first
                "ms": device_time_ms(lambda: kernel(*args, phase_t, **c["kw"]), 100, sleep_cycles=400_000_000),
                # ≈ 500 PyTorch ops a call: few calls behind a long sleep
                "plain_ms": device_time_ms(lambda: twin(*args, quant, **c["kw"]), 5, sleep_cycles=400_000_000),
                "library_ms": None, "bound_ms": bound, "bound_by": by, "flops": flops, "bytes": nbytes,
                "launches_per_call": 1, "cuda_launches_per_call": STEP_CUDA_LAUNCHES[name],
                "pass_us": _pass_us(lambda: kernel(*args, phase_t, **c["kw"])),
            })
    # kernel 6 at the per-layer path's widest site (B × 400) at the serving
    # (512) and training (128) batches, and one sweep larger than L2; bytes:
    # x read once, y written once, the scalars; operations a element, from
    # the code: min and max, then the projection (monitor: ×2^16, two clip
    # compares, rint, ÷2^16; quant: ÷delta, rint, +z, two clip compares,
    # −z, ×delta)
    from repro_torch.kernels.quantize import ref_monitor_quant
    from repro_torch.kernels.quantize.kernel import monitor_quant_cuda

    for shape in ((512, 400), (128, 400), (1 << 24,)):
        x = (torch.randn(*shape, generator=gen) * 4).to(dev).reshape(-1)
        n = x.numel()
        for case in ("monitor", "quant"):
            quant = case == "quant"
            a_min, a_max = torch.full((1,), -3.0, device=dev), torch.full((1,), 3.5, device=dev)
            phase_t = torch.full((1,), int(quant), dtype=torch.int32, device=dev)
            phase_b = torch.full((), quant, dtype=torch.bool, device=dev)
            bound, by = _bound_ms(8 * n + 4 * 5, (2 + (7 if quant else 5)) * n, dev_info)
            rows.append({
                "kernel": "fxp_monitor_quant", "shape": "x".join(map(str, shape)), "batch": shape[0], "phase": case,
                "ms": device_time_ms(lambda: monitor_quant_cuda(x, a_min, a_max, phase_t), 100),
                "plain_ms": device_time_ms(lambda: ref_monitor_quant(x, a_min, a_max, phase_b), 20),
                "library_ms": None, "library_note_aminmax_ms": device_time_ms(lambda: torch.aminmax(x), 100),
                "bound_ms": bound, "bound_by": by, "launches_per_call": 1, "cuda_launches_per_call": 1,
            })
    emit("times", card=dev_info["nvidia_smi"], rows=rows,
         note="device time of back-to-back calls, operands warm in L2; library_ms for fxp_dense is "
              "torch.addmm on the precomputed hi and lo limbs plus the activation; fxp_mlp_fwd and "
              "fxp_mlp_bwd have no single PyTorch call computing their function (the backward is two "
              "products and three masks per layer, walked in order), nor do ddpg_critic_step and "
              "ddpg_actor_step (a whole DDPG half-update), nor does fxp_monitor_quant (a reduction and a "
              "phase-selected projection): its library_note_aminmax_ms is torch.aminmax on the same tensor, "
              "the reduction alone")
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


# --------------------------------------------------------------------------
# slices 9 and 10: the serving mesh, the rules, and the LM zoo
# --------------------------------------------------------------------------

MESH_BUCKETS = (1, 8, 128)
RULE_ARCHS = ("qwen2_0_5b", "gemma3_1b", "moonshot_v1_16b_a3b", "rwkv6_1_6b", "recurrentgemma_2b", "dbrx_132b")
RULE_CACHE = (128, 32_768)  # the reference's decode_32k cell: batch, cache length
LM_ARCHS = ("qwen2_0_5b", "gemma3_1b", "moonshot_v1_16b_a3b", "rwkv6_1_6b", "recurrentgemma_2b", "dbrx_132b")
# depth cut only where one card's 80 GB forces it (the float32 tree beside its bf16 serving copy)
LM_LAYERS = {"moonshot_v1_16b_a3b": 12, "dbrx_132b": 2}
# 700: gemma3's masked local path (1024 takes the banded one); 2304: past recurrentgemma's 2048 window, so
# its ring wraps in the prefill (the masked local path: banded needs S >= 2 windows, a multiple of one)
LM_PROMPTS = {"qwen2_0_5b": (128, 1024), "gemma3_1b": (128, 700, 1024), "moonshot_v1_16b_a3b": (128, 1024),
              "rwkv6_1_6b": (128, 1024), "recurrentgemma_2b": (128, 1024, 2304), "dbrx_132b": (128, 1024)}
LM_GEN_NEW = 16
LM_REQUESTS = dict(lanes=4, n=8, prompt=(64, 1024), max_new=(16, 32))
LM_MAX_NEW_NEW = (8, 16)  # slice 10's models: fewer new tokens a request, the same prompt mix
LM_NO_ENGINE = ("dbrx_132b",)  # the few-large-experts MoE shape: decode against forward and decode ms only
LM_MAX_SEQ = 1024 + 32
LM_DECODE_LANES = (1, 4, 16)
LM_PARITY_PROMPT = 16  # decode against the full forward
LM_PARITY_PROMPT_MOE = 8  # B·S <= 8: capacity 8 holds every pair, so the forward drops none
LM_F32_PROMPT = 64  # float32, card against CPU
LM_F32_LAYERS = {"qwen2_0_5b": None, "moonshot_v1_16b_a3b": 1, "rwkv6_1_6b": 1, "recurrentgemma_2b": 3}
LM_RWKV_REFUSED = 200  # > 128 and no multiple of 128: the reference's chunk rule refuses it
LM_TOL = 0.05  # the reference's decode contract: max|Δ| < 0.05·scale + 0.05 (tests/test_archs.py:77-78)
LM_F32_TOL = 1e-3  # float32 card against CPU: max|Δ| <= 1e-3·scale + 1e-3


def _shard_counts(specs, shapes, rules, mesh) -> dict:
    """Leaves the rules shard (some dim on a mesh axis) and replicate, and
    the float32 bytes one device of `mesh` would hold."""
    from repro_torch.core import parallelism as par

    counts = {"sharded": 0, "replicated": 0, "bytes_per_device": 0}

    def visit(logical, shape):
        spec = rules.mesh_axes(logical.axes, tuple(shape.shape), mesh)
        split = 1
        for entry in spec:
            for ax in ((entry,) if isinstance(entry, str) else entry or ()):
                split *= mesh.shape[ax]
        counts["sharded" if split > 1 else "replicated"] += 1
        counts["bytes_per_device"] += shape.numel() * shape.element_size() // split
        return spec

    par.map_logical(visit, specs, shapes)
    return counts


def phase_mesh(gen: torch.Generator, dev) -> dict:
    """`PolicyEngine(mesh=make_serve_mesh())` on the card bitwise the
    `mesh=None` engine at buckets 1, 8 and 128 in every mode; the serve and
    train rules over the params and decode caches of `RULE_ARCHS` at their
    full configs (dbrx-132b's 132B params among them) on the reference's
    (16, 16) production layout (shapes only: `FakeTensorMode` builds the
    trees without memory, as `jax.eval_shape`)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs import registry
    from repro_torch.core import parallelism as par
    from repro_torch.launch.mesh import make_production_mesh, make_serve_mesh
    from repro_torch.models import transformer as T
    from repro_torch.rl import ddpg
    from repro_torch.serve.policy import BatcherConfig, PolicyEngine

    mesh = make_serve_mesh(device=dev)  # on the card: every visible CUDA device
    require(mesh.devices is not None and (dev.type != "cuda" or mesh.size == torch.cuda.device_count()),
            f"serve mesh {mesh!r}")
    actor = ddpg.init_actor(ACTOR_DIMS[0], ACTOR_DIMS[-1], generator=gen, device=dev)
    frozen = _calibrate(actor, gen, dev)
    serve = {}
    for mode in ("fused", "layer", "jnp"):
        batcher = BatcherConfig(buckets=MESH_BUCKETS)
        on_mesh = PolicyEngine(actor, frozen, device=dev, force_mode=mode, batcher=batcher, mesh=mesh)
        plain = PolicyEngine(actor, frozen, device=dev, force_mode=mode, batcher=batcher)
        for b in MESH_BUCKETS:
            obs = (torch.randn(b, ACTOR_DIMS[0], generator=gen) * 2).numpy()
            got, want = on_mesh.run_batch(obs), plain.run_batch(obs)
            require(got.shape == (b, ACTOR_DIMS[-1]) and np.array_equal(got, want),
                    f"mesh {mode} B={b}: not bitwise the mesh=None engine (max |Δ| {np.abs(got - want).max()})")
            serve[f"{mode}/{b}"] = "bitwise"
        on_mesh.close()
        plain.close()

    layout = make_production_mesh()
    require(layout.is_layout_only or layout.size == torch.cuda.device_count(), f"layout {layout!r}")
    rules = {}
    for arch in RULE_ARCHS:
        cfg = registry.get(arch)
        with FakeTensorMode():
            p_shapes = T.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
            c_shapes = T.init_cache(cfg, *RULE_CACHE, device="cpu")
        hints = {"prefer_head_dim": cfg.n_kv_heads % layout.shape["model"] != 0}
        rules[arch] = {"serve_hints": hints}
        for phase, r in (("serve", par.serve_rules(layout, **hints)), ("train", par.train_rules(layout))):
            rules[arch][phase] = {"params": _shard_counts(T.param_specs(cfg), p_shapes, r, layout),
                                  "cache": _shard_counts(T.cache_specs(cfg), c_shapes, r, layout)}
            require(rules[arch][phase]["params"]["sharded"] > 0, f"{arch} {phase}: the rules shard no param")
    emit("mesh", serve_mesh={"shape": mesh.shape, "devices": [str(d) for d in mesh.devices]},
         buckets=list(MESH_BUCKETS), serve=serve, layout=layout.shape, cache_cell=list(RULE_CACHE), rules=rules)
    return rules


def _wall_ms(fn, dev, reps: int = 3) -> float:
    """Median host wall time of a synchronous call (the card drained before
    and after), after one warmup call."""
    fn()
    sync(dev)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _lm_decode_vs_forward(params, cfg, gen, dev) -> dict:
    """Token-by-token decode against the full forward on one prompt (for an
    MoE model 8 tokens, where the forward's capacity drops no pair)."""
    from repro_torch.models import transformer as T

    n = LM_PARITY_PROMPT_MOE if cfg.is_moe else LM_PARITY_PROMPT
    toks = torch.randint(0, cfg.vocab_size, (1, n), generator=gen).to(dev)
    full, _ = T.forward(params, {"tokens": toks}, cfg)
    cache = T.init_cache(cfg, 1, n, device=dev)
    dec = torch.cat([T.decode_step(params, toks[:, i:i + 1], cache, i, cfg)[0] for i in range(n)], 1)
    full, dec = full.float(), dec.float()
    require(bool(torch.isfinite(full).all()) and bool(torch.isfinite(dec).all()), "decode/forward: non-finite logits")
    err, scale = float((dec - full).abs().max()), float(full.abs().max())
    require(err < LM_TOL * scale + LM_TOL, f"decode against forward: max |Δ| {err} >= {LM_TOL}·{scale} + {LM_TOL}")
    return {"max_abs": err, "scale": scale, "limit": LM_TOL * scale + LM_TOL, "tokens": n}


class _Recorded:
    """A histogram that also keeps every value it observes."""

    def __init__(self, hist):
        self.hist, self.values = hist, []

    def observe(self, v) -> None:
        self.values.append(v)
        self.hist.observe(v)

    def __getattr__(self, name):
        return getattr(self.hist, name)


def _lm_engine_run(params, cfg, dev, prompts, max_new, record: bool):
    """One `generate_batch` through a fresh 4-lane engine.  With `record`,
    the engine's prefill and decode calls are wrapped to keep each lane's
    logits (on the card) per request, and the admissions made while other
    lanes were decoding are counted."""
    from repro_torch.serve.lm import LMEngine

    eng = LMEngine(params, cfg, lanes=LM_REQUESTS["lanes"], max_seq=LM_MAX_SEQ, device=dev)
    logits: dict = {}
    mid = [0]
    eng._m_ttft = _Recorded(eng._m_ttft)  # TTFT exactly: the histogram's quantiles are bucketed
    if record:
        prefill, decode = eng._prefill, eng._decode

        def rec_prefill(tokens, cache):
            last, cache = prefill(tokens, cache)
            logits[tokens[0].cpu().numpy().tobytes()] = [last[0].float().clone()]
            mid[0] += bool(eng._active) and eng._metrics.calls > 0  # others mid-decode
            return last, cache

        def rec_decode(tokens, cache, pos):
            out, cache = decode(tokens, cache, pos)
            for lane, st in eng._active.items():
                logits[st.req.prompt.tobytes()].append(out[lane, -1].float().clone())
            return out, cache

        eng._prefill, eng._decode = rec_prefill, rec_decode
    t0 = time.perf_counter()
    outs = eng.generate_batch(prompts, max_new)
    stats = {**eng.stats(), "wall_s": time.perf_counter() - t0,
             "ttft_ms": sorted(v * 1e3 for v in eng._m_ttft.values)}
    eng.close()
    return outs, stats, logits, mid[0]


def _lm_lanes_vs_b1(params, cfg, dev, prompts, max_new, outs, logits) -> dict:
    """Each lane's logits against the B = 1 path on the same tokens (the
    request's prompt, then its own emitted tokens, teacher-forced): within
    LM_TOL·scale + LM_TOL at every step; a token may differ from the B = 1
    argmax only where B = 1's top-2 margin is within that tolerance (a
    flip).  Also each request against `generate` at B = 1: equal, or
    parting from it exactly at its first flip (B = 1's argmax there is
    `generate`'s token, so after an admitted flip the two streams go on
    from different tokens)."""
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import generate

    worst, flips, steps, gen_equal, gen_parted, margins = 0.0, 0, 0, 0, 0, []
    for prompt, n, out in zip(prompts, max_new, outs):
        first_flip = None
        s = len(prompt)
        require(out.shape == (s + n,) and np.array_equal(out[:s], prompt), "engine: reply is not prompt + tokens")
        lane = logits[prompt.tobytes()]
        require(len(lane) == n, f"engine: {len(lane)} logit rows recorded for {n} tokens")
        toks = torch.from_numpy(out).to(dev)[None]
        cache = T.init_cache(cfg, 1, LM_MAX_SEQ, device=dev)
        b1, cache = T.prefill(params, {"tokens": toks[:, :s]}, cfg, cache=cache)
        for k in range(n):
            if k:
                b1 = T.decode_step(params, toks[:, s + k - 1:s + k], cache, s + k - 1, cfg)[0][:, -1]
            ref = b1[0].float()
            require(bool(torch.isfinite(lane[k]).all()) and bool(torch.isfinite(ref).all()), "lm: non-finite logits")
            err, scale = float((lane[k] - ref).abs().max()), float(ref.abs().max())
            limit = LM_TOL * scale + LM_TOL
            require(err <= limit, f"lane logits against B = 1: max |Δ| {err} > {limit} at token {k}")
            worst = max(worst, err / limit)
            top2 = torch.topk(ref, 2).values
            margin = float(top2[0] - top2[1])
            if int(torch.argmax(ref)) != int(out[s + k]):
                flips += 1
                margins.append(margin)
                first_flip = k if first_flip is None else first_flip
                require(margin <= limit, f"token {k} differs from B = 1 at a top-2 margin {margin} > {limit}")
            steps += 1
        want = generate(params, cfg, prompt[None], n)[0].cpu().numpy()
        parted = np.flatnonzero(want != out)
        if parted.size == 0:
            gen_equal += 1
        else:
            require(parted[0] == s + first_flip if first_flip is not None else False,
                    f"request of {s} tokens parts from B = 1 generate at token {parted[0] - s}, not at a flip "
                    f"(first flip: {first_flip})")
            gen_parted += 1
    return {"tokens": steps, "flips": flips, "flip_margins": margins, "worst_err_over_limit": worst,
            "requests_equal_to_generate": gen_equal, "requests_parting_at_a_flip": gen_parted,
            "requests": len(prompts)}


def _lm_decode_ms(params, cfg, dev, lanes: int, steps: int = 5) -> float:
    from repro_torch.models import transformer as T

    cache = T.init_cache(cfg, lanes, LM_MAX_SEQ, device=dev)
    tokens = torch.zeros((lanes, 1), dtype=torch.int32, device=dev)
    pos = torch.full((lanes,), LM_MAX_SEQ // 2, dtype=torch.int64, device=dev)  # half the cache filled

    def run():
        for _ in range(steps):
            T.decode_step(params, tokens, cache, pos, cfg)

    with torch.inference_mode():
        return _wall_ms(run, dev, reps=2) / steps


def _lm_profile(params, cfg, dev, steps: int = 5) -> dict:
    """`torch.profiler` over `steps` decode steps at 4 lanes and over three
    1024-token prefills: wall and device-busy ms, the device's idle share,
    kernels per call."""
    from repro_torch.models import transformer as T

    cache = T.init_cache(cfg, 4, LM_MAX_SEQ, device=dev)
    tokens = torch.zeros((4, 1), dtype=torch.int32, device=dev)
    pos = torch.full((4,), LM_MAX_SEQ // 2, dtype=torch.int64, device=dev)
    prompt = torch.zeros((1, 1024), dtype=torch.int32, device=dev)
    with torch.inference_mode():
        T.decode_step(params, tokens, cache, pos, cfg)
        T.prefill(params, {"tokens": prompt}, cfg)
        torch.cuda.synchronize()
        decode = _profile(lambda: [T.decode_step(params, tokens, cache, pos, cfg) for _ in range(steps)], steps,
                          "step")
        prefill = _profile(lambda: [T.prefill(params, {"tokens": prompt}, cfg) for _ in range(3)], 3, "call")
    keep = ("wall_ms_per", "device_busy_ms_per", "device_idle_share", "kernels_per", "top_kernels_ms_per")
    return {name: {k: v for k, v in prof.items() if k.startswith(keep)}
            for name, prof in (("decode_lanes4", decode), ("prefill_1024", prefill))}


def _lm_f32_card_vs_cpu(params, cfg, gen, dev) -> dict:
    """The same float32 weights (TF32 off) on the card and on the CPU: one
    64-token prompt's logits within LM_F32_TOL·scale + LM_F32_TOL."""
    from repro_torch import tree
    from repro_torch.models import transformer as T

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    toks = torch.randint(0, cfg.vocab_size, (1, LM_F32_PROMPT), generator=gen)
    with torch.inference_mode():
        card, _ = T.forward(params, {"tokens": toks.to(dev)}, cfg32)
        cpu_params = tree.tree_map(lambda t: t.cpu(), params)
        host, _ = T.forward(cpu_params, {"tokens": toks}, cfg32)
    card = card.cpu()
    require(card.dtype == torch.float32 and bool(torch.isfinite(card).all()), "f32 forward: non-finite logits")
    err, scale = float((card - host).abs().max()), float(host.abs().max())
    limit = LM_F32_TOL * scale + LM_F32_TOL
    require(err <= limit, f"float32 card against CPU: max |Δ| {err} > {limit}")
    return {"max_abs": err, "scale": scale, "limit": limit, "tf32": torch.backends.cuda.matmul.allow_tf32,
            "n_layers": cfg.n_layers}


def _lm_seed(gen: torch.Generator) -> int:
    return int(torch.randint(0, 2**31, (1,), generator=gen))


def _lm_config(arch: str):
    from repro_torch.configs import registry

    cfg = registry.get(arch)
    return dataclasses.replace(cfg, n_layers=LM_LAYERS[arch]) if arch in LM_LAYERS else cfg


def _lm_prompt_lens(arch: str, rng: np.random.Generator, n: int) -> list:
    """The engine mix's prompt lengths; RWKV-6 takes only lengths its chunk
    rule accepts (≤ 128, or a multiple of 128: rounded down)."""
    lo, hi = LM_REQUESTS["prompt"]
    lens = [int(v) for v in rng.integers(lo, hi + 1, size=n)]
    return [v // 128 * 128 if arch == "rwkv6_1_6b" and v > 128 else v for v in lens]


def _lm_f32_period(arch: str, gen: torch.Generator, dev) -> dict:
    """One pattern period of the arch at full width, float32 (TF32 off):
    the card's forward against the CPU's on the same weights."""
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(_lm_config(arch), n_layers=LM_F32_LAYERS[arch], dtype="float32")
    params = T.init_params(torch.Generator(device=dev).manual_seed(_lm_seed(gen)), cfg, device=dev)
    out = _lm_f32_card_vs_cpu(params, cfg, gen, dev)
    del params
    return out


def _lm_rwkv_refused(params, cfg, dev) -> str:
    """`generate` on a prompt the chunk rule refuses raises, naming it."""
    from repro_torch.serve.engine import generate

    try:
        generate(params, cfg, torch.zeros((1, LM_RWKV_REFUSED), dtype=torch.int32, device=dev), 2)
    except ValueError as err:
        require("not divisible by chunk" in str(err), f"rwkv6 {LM_RWKV_REFUSED}: {err}")
        return str(err)
    raise SmokeFailure(f"rwkv6: a {LM_RWKV_REFUSED}-token prompt was not refused")


def _lm_launches() -> dict:
    """The six ported kernels' wrapper counts (kernel B's residual mode too)."""
    from repro_torch.kernels.fxp_matmul.kernel import fxp_dense_cuda
    from repro_torch.kernels.quantize.kernel import monitor_quant_cuda

    return {**_counts(),
            "fxp_dense": fxp_dense_cuda.launches, "fxp_monitor_quant": monitor_quant_cuda.launches}


def _lm_weight_read(params, cfg) -> int:
    """Bytes of the serving tree one decode step reads: every leaf (the MoE
    dense dispatch runs every expert), an untied embedding table only for
    its gathered rows (not counted)."""
    from repro_torch import tree

    total = sum(t.numel() * t.element_size() for t in tree.leaves(params))
    if not cfg.tie_embeddings:
        emb = params["embed"]["embedding"]
        total -= emb.numel() * emb.element_size()
    return total


def _lm_model(arch: str, gen: torch.Generator, dev, rng: np.random.Generator, dev_info: dict) -> dict:
    """One model of the LM zoo at full width (depth cut per `LM_LAYERS`):
    random float32 weights from the seed, cast once to the serving tree
    (bf16 compute, as the configs say), the float32 tree then freed."""
    from repro_torch import tree
    from repro_torch.configs import registry
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import generate

    cfg = _lm_config(arch)
    gc.collect()  # the previous model's engine may hold its params in a reference cycle
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    row = {"name": cfg.name, "n_layers": cfg.n_layers, "config_layers": registry.get(arch).n_layers,
           "compute_dtype": str(cfg.compute_dtype)}
    if arch in LM_F32_LAYERS and LM_F32_LAYERS[arch] is not None:
        row["f32_card_vs_cpu"] = _lm_f32_period(arch, gen, dev)
    params32 = T.init_params(torch.Generator(device=dev).manual_seed(_lm_seed(gen)), cfg, device=dev)
    row["params"] = sum(t.numel() for t in tree.leaves(params32))
    row["config_params"] = cfg.total_params()
    if arch in LM_F32_LAYERS and LM_F32_LAYERS[arch] is None:
        row["f32_card_vs_cpu"] = _lm_f32_card_vs_cpu(params32, cfg, gen, dev)
    params = T.serving_params(params32, cfg)  # frozen: cast once
    del params32
    read = _lm_weight_read(params, cfg)
    row["decode_weight_read"] = {"bytes": read, "bound_ms": read / dev_info["peak_bytes_per_s"] * 1e3
                                 if "peak_bytes_per_s" in dev_info else None}
    with torch.inference_mode():
        row["decode_vs_forward"] = _lm_decode_vs_forward(params, cfg, gen, dev)
        row["prefill_ms"], row["generate"] = {}, {}
        for s in LM_PROMPTS[arch]:
            prompt = torch.randint(0, cfg.vocab_size, (1, s), generator=gen).to(dev)
            cache = T.init_cache(cfg, 1, s, device=dev)
            last, _ = T.prefill(params, {"tokens": prompt}, cfg, cache=cache)
            require(bool(torch.isfinite(last.float()).all()), f"{arch} prefill {s}: non-finite logits")
            row["prefill_ms"][s] = _wall_ms(lambda: T.prefill(params, {"tokens": prompt}, cfg,
                                                              cache=T.init_cache(cfg, 1, s, device=dev)), dev)
            out = generate(params, cfg, prompt, LM_GEN_NEW)
            require(out.shape == (1, s + LM_GEN_NEW) and bool(((out >= 0) & (out < cfg.vocab_size)).all())
                    and torch.equal(out[:, :s], prompt.to(torch.int32)), f"{arch} generate {s}: bad tokens")
            row["generate"][s] = out[0, s:].tolist()
        if arch == "rwkv6_1_6b":
            row["rwkv_refused"] = {"prompt": LM_RWKV_REFUSED, "error": _lm_rwkv_refused(params, cfg, dev)}
    row["decode_ms_per_step"] = {lanes: _lm_decode_ms(params, cfg, dev, lanes) for lanes in LM_DECODE_LANES}
    if dev.type == "cuda":
        row["profile"] = _lm_profile(params, cfg, dev)

    if arch not in LM_NO_ENGINE:
        n_req = LM_REQUESTS["n"]
        lo, hi = LM_REQUESTS["max_new"] if arch in ("qwen2_0_5b", "gemma3_1b") else LM_MAX_NEW_NEW
        prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32) for n in _lm_prompt_lens(arch, rng, n_req)]
        max_new = [int(n) for n in rng.integers(lo, hi + 1, size=n_req)]
        outs, _, logits, mid = _lm_engine_run(params, cfg, dev, prompts, max_new, record=True)
        require(mid >= 1, f"{arch}: no admission happened in the middle of a decode")
        with torch.inference_mode():
            row["engine_vs_b1"] = _lm_lanes_vs_b1(params, cfg, dev, prompts, max_new, outs, logits)
        row["engine_vs_b1"]["admissions_mid_decode"] = mid
        del logits
        outs2, stats, _, _ = _lm_engine_run(params, cfg, dev, prompts, max_new, record=False)
        require(all(np.array_equal(a, b) for a, b in zip(outs, outs2)), f"{arch}: engine runs disagree")
        row["engine"] = {"prompt_lens": [len(p) for p in prompts], "max_new": max_new,
                         "generated_tokens_per_s": stats["tokens"] / stats["wall_s"],
                         **{k: stats[k] for k in ("requests", "admitted", "evicted", "tokens", "decode_steps",
                                                  "wall_s", "tokens_per_s_device", "ttft_ms", "ttft_p50_ms",
                                                  "ttft_p99_ms", "p50_ms", "p99_ms", "decode_occupancy")}}
        require(stats["requests"] == n_req and stats["tokens"] == sum(max_new), f"{arch}: {stats}")
    row["peak_memory_bytes"] = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    row["seconds"] = time.perf_counter() - t0
    del params
    return row


def phase_lm(gen: torch.Generator, dev, dev_info: dict) -> dict:
    """The LM zoo's serving path at full width, random weights from the
    seed, bf16 compute (the configs' own), one model at a time: qwen2-0.5b
    and gemma3-1b (attention), moonshot-v1-16b-a3b (MoE, 12 of 48 layers),
    rwkv6-1.6b (RWKV-6), recurrentgemma-2b (RG-LRU + local attention) and
    dbrx-132b (MoE, 2 of 40 layers).  One line per model; the six ported
    kernels' counts are set to 0 before the first and must read 0 after
    the last (the reference's LM path calls no Pallas kernel)."""
    _reset_counts()
    report = {}
    rng = np.random.default_rng(_lm_seed(gen))
    for arch in LM_ARCHS:
        report[arch] = _lm_model(arch, gen, dev, rng, dev_info)
        emit("lm", model=arch, nvidia_smi=dev_info["nvidia_smi"],
             tolerance={"decode": f"{LM_TOL}·scale + {LM_TOL}", "f32_card_vs_cpu": f"{LM_F32_TOL}·scale + {LM_F32_TOL}"},
             **report[arch])
    launches = _lm_launches()
    require(not any(launches.values()), f"lm: a ported kernel ran on the LM path: {launches}")
    emit("lm_launches", archs=list(LM_ARCHS), launches=launches)
    return {"models": report, "launches": launches}


# the lm_train phase: demo-100m at full width and depth through the train CLI
LM_TRAIN_ARCH = "demo_100m"
LM_TRAIN_CLI = dict(batch=8, seq=1024, qat_delay=30, steps=70, ckpt_every=30)
LM_TRAIN_TIMED = 5  # steps timed for the step ms (the first 2 not counted)
LM_TRAIN_VARIANTS = {"ce_chunk_256": dict(ce_chunk=256), "remat_none": dict(remat="none")}
LM_TRAIN_PROFILED = 3
LM_TRAIN_LEARNER_STEPS = 4
# one full-width train step per family, float32, card against CPU: one
# pattern period each, B = 1, S = 128 (RWKV-6's chunk), QAT in the monitor phase
LM_TRAIN_FAMILIES = {"qwen2_0_5b": 1, "moonshot_v1_16b_a3b": 1, "rwkv6_1_6b": 1, "recurrentgemma_2b": 3}
LM_TRAIN_F32 = dict(batch=1, seq=128)
LM_TRAIN_F32_TOL = 1e-3  # loss 1e-3·|loss| + 1e-3; each grad leaf 1e-3·max|g_leaf| + 1e-6
BF16_DENSE_PEAK = 989e12  # H100 SXM data sheet, dense bf16 (PERF.md §3)


def _lm_train_cli(dev, *extra) -> tuple:
    """`repro_torch.launch.train.main` with the phase's arguments; its log
    lines go to a buffer (the records come back with the state)."""
    import io

    from repro_torch.launch.train import main as train_main

    c = LM_TRAIN_CLI
    argv = ["--arch", LM_TRAIN_ARCH, "--device", str(dev), "--batch", str(c["batch"]),
            "--seq", str(c["seq"]), "--qat", "--qat-delay", str(c["qat_delay"]), "--log-every", "1", *extra]
    with contextlib.redirect_stdout(io.StringIO()) as out:
        state, records = train_main(argv)
    return state, records, out.getvalue()


def _lm_train_config():
    from repro_torch.configs import registry

    return dataclasses.replace(registry.get(LM_TRAIN_ARCH), qat=True, qat_delay=LM_TRAIN_CLI["qat_delay"])


def _bitwise_trees(a, b) -> list:
    """Paths of the leaves where two states differ (empty: bitwise equal)."""
    from repro_torch import tree

    return [pa for (pa, x), (_, y) in zip(tree.flatten_with_path(a), tree.flatten_with_path(b))
            if not torch.equal(x, y)]


def _lm_train_resume(dev) -> dict:
    """The CLI's runs under `torch.use_deterministic_algorithms(True)`: 70
    steps checkpointed every 30 and at the end; then the step-70 checkpoint
    is deleted, as a run preempted after step 60 leaves the directory, and
    the same command resumes from step 60.  Checks the loss falling (the
    reference's rule), the phase flip at the delay, the ranges frozen from
    then on, finite params, and the resumed state bitwise the uninterrupted
    one."""
    import shutil

    from repro_torch import tree
    from repro_torch.checkpoint import ckpt

    c = LM_TRAIN_CLI
    ckdir = REPO / "build" / "lm_train_ckpt"
    shutil.rmtree(ckdir, ignore_errors=True)
    steps = ["--steps", str(c["steps"]), "--ckpt-dir", str(ckdir), "--ckpt-every", str(c["ckpt_every"])]
    resume_from = c["steps"] // c["ckpt_every"] * c["ckpt_every"]
    t0 = time.perf_counter()
    torch.use_deterministic_algorithms(True)
    try:
        whole, rec, _ = _lm_train_cli(dev, *steps)
        at_delay, _, _ = ckpt.restore(ckdir, whole, step=c["qat_delay"])
        at_resume, _, _ = ckpt.restore(ckdir, whole, step=resume_from)
        shutil.rmtree(ckdir / f"step_{c['steps']:08d}")
        resumed, rec_r, log_r = _lm_train_cli(dev, *steps, "--resume")
    finally:
        torch.use_deterministic_algorithms(False)
    wall = time.perf_counter() - t0
    losses = [r["loss"] for r in rec]
    require(len(rec) == c["steps"] and [r["step"] for r in rec] == list(range(1, c["steps"] + 1)), "lm_train: log")
    first5, last5 = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    require(last5 < first5 - 0.2, f"lm_train: the loss did not fall: first 5 {first5}, last 5 {last5}")
    phases = [r["quant_phase"] for r in rec]
    require(phases == [int(r["step"] > c["qat_delay"]) for r in rec],
            f"lm_train: quant_phase does not flip at step {c['qat_delay']}: {phases}")
    require(c["qat_delay"] % c["ckpt_every"] == 0, "the delay's checkpoint is the frozen ranges'")
    ranges = tree.leaves(whole.ranges)
    require(all(bool(torch.isfinite(t.float()).all()) for t in ranges), "lm_train: a range leaf is not finite")
    for what, later in ((f"step {resume_from}", at_resume.ranges), (f"step {c['steps']} (resumed)", resumed.ranges),
                        (f"step {c['steps']}", whole.ranges)):
        moved = _bitwise_trees(at_delay.ranges, later)
        require(not moved, f"lm_train: ranges moved after the delay, {what}: {moved[:4]}")
    require(all(bool(torch.isfinite(t).all()) for t in tree.leaves(whole.params)), "lm_train: a param is not finite")
    require(f"resumed from step {resume_from}" in log_r, f"lm_train: the second run did not resume: {log_r[:200]}")
    differ = _bitwise_trees(resumed, whole)
    require(not differ, f"lm_train: the resumed step-{c['steps']} state is not the uninterrupted run's: {differ[:6]}")
    require([r["loss"] for r in rec_r] == [r["loss"] for r in rec[resume_from:]], "lm_train: resumed losses differ")
    shutil.rmtree(ckdir, ignore_errors=True)
    return {"steps": c["steps"], "resumed_from": resume_from, "checkpoint_every": c["ckpt_every"],
            "losses": losses, "loss_first5_mean": first5, "loss_last5_mean": last5,
            "loss_rule": "mean(last 5) < mean(first 5) - 0.2 (tests/test_system.py:57)",
            "quant_phase_flips_at_step": c["qat_delay"] + 1, "ranges_after_delay": "bitwise frozen",
            "resumed_vs_uninterrupted": "bitwise", "deterministic_algorithms": True,
            "deterministic_refusals": [], "cli_s_per_step": [r["s_per_step"] for r in rec],
            "wall_s_two_runs": wall}, whole


def _lm_train_flops(cfg, batch: int, seq: int, n_params: int) -> float:
    """Model FLOPs of one training step: 6·N·tokens (N every param, the
    tied embedding once: it is the head's product) plus causal attention,
    6·L·B·S²·H·hd (QKᵀ and PV over the causal half, forward and backward)."""
    return 6.0 * n_params * batch * seq + 6.0 * cfg.n_layers * batch * seq * seq * cfg.n_heads * cfg.hd


def _lm_train_timed(cfg, dev, batches, *, remat: str | None = None, ce_chunk: int = 0,
                    profile: bool = False) -> dict:
    """Host wall ms of `LM_TRAIN_TIMED` steps from a fresh state, each
    ending in a device sync (the first 2 not counted), and the peak device
    memory over them; with `profile`, a profiler pass over
    `LM_TRAIN_PROFILED` more."""
    from repro_torch.optim import adam, schedule
    from repro_torch.train.step import init_state, make_train_step

    cfg = dataclasses.replace(cfg, remat=remat or cfg.remat)
    opt = adam.AdamConfig(lr=3e-4, grad_clip_norm=1.0,
                          schedule=schedule.warmup_cosine(50, LM_TRAIN_CLI["steps"]))
    step = make_train_step(cfg, opt, ce_chunk=ce_chunk)
    state = init_state(torch.Generator(device=dev).manual_seed(1), cfg, device=dev)
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    ms = []
    for i in range(LM_TRAIN_TIMED):
        sync(dev)
        t0 = time.perf_counter()
        state, metrics = step(state, batches[i % len(batches)])
        sync(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
        require(bool(torch.isfinite(metrics["loss"])), "lm_train: a timed step's loss is not finite")
    out = {"ms": ms, "ms_p50": statistics.median(ms[2:]), "remat": cfg.remat, "ce_chunk": ce_chunk,
           "peak_memory_bytes": torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None}
    if profile and dev.type == "cuda":
        prof = _profile(lambda: [step(state, batches[i % len(batches)]) for i in range(LM_TRAIN_PROFILED)],
                        LM_TRAIN_PROFILED, "step")
        out["profile"] = {k: v for k, v in prof.items() if not k.startswith("runtime_calls")}
    return out


def _lm_train_family(arch: str, gen: torch.Generator, dev) -> dict:
    """One pattern period of the arch at full width, float32 (TF32 off),
    QAT in the monitor phase: `train.step.value_and_grad` on the card
    against the CPU on the same params (through `convert`) and the same
    numpy batch — the loss, every gradient leaf and the new ranges."""
    from repro_torch import convert, tree
    from repro_torch.models import transformer as T
    from repro_torch.train.step import value_and_grad

    cfg = dataclasses.replace(_lm_config(arch), n_layers=LM_TRAIN_FAMILIES[arch], dtype="float32", qat=True)
    host = convert.lm_params_to_numpy(T.init_params(torch.Generator(device=dev).manual_seed(_lm_seed(gen)), cfg,
                                                    device=dev))
    rng = np.random.default_rng(_lm_seed(gen))
    b, s = LM_TRAIN_F32["batch"], LM_TRAIN_F32["seq"]
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    out = {}
    for where in (dev, torch.device("cpu")):
        params = convert.lm_params_from_numpy(host, device=where)
        t0 = time.perf_counter()
        loss, extras, grads = value_and_grad(cfg, params, T.init_ranges(cfg, device=where),
                                             {k: torch.from_numpy(v).to(where) for k, v in batch.items()},
                                             torch.tensor(False, device=where))
        out[where.type] = (float(loss), [g.cpu() for g in tree.leaves(grads)], tree.leaves(extras["ranges"]),
                           time.perf_counter() - t0)
        del params, grads, extras
        gc.collect()
        if where.type == "cuda":
            torch.cuda.empty_cache()
    (loss, grads, ranges, card_s), (want, want_grads, want_ranges, cpu_s) = out[dev.type], out["cpu"]
    tol = LM_TRAIN_F32_TOL
    require(abs(loss - want) <= tol * abs(want) + tol, f"{arch} train step: loss {loss} against the CPU's {want}")
    worst, paths = 0.0, [p for p, _ in tree.flatten_with_path(host)]
    for path, g, w in zip(paths, grads, want_grads):  # float32 differences: ≤ an ulp off, far below the bound
        require(bool(torch.isfinite(g).all()), f"{arch} {path}: non-finite gradient")
        err, scale = float((g - w).abs().max()), float(w.abs().max())
        require(err <= tol * scale + 1e-6, f"{arch} {path}: gradient max |Δ| {err} > {tol}·{scale} + 1e-6")
        worst = max(worst, err / (tol * scale + 1e-6))
    for r, w in zip(ranges, want_ranges):
        compare(r.cpu().float(), w.float(), 2e-5, f"{arch} ranges")
    return {"n_layers": cfg.n_layers, "params": sum(a.size for a in tree.leaves(host)), "loss": loss,
            "loss_cpu": want, "grad_leaves": len(grads), "worst_grad_err_over_limit": worst,
            "card_s": card_s, "cpu_s": cpu_s}


def _lm_train_learner(cfg, dev, host_batches: list) -> dict:
    """`LEARNER_STEPS` demo-100m steps through `LearnerEngine(
    learner_update_fns(...), pad_policy="exact")` against as many direct
    calls of the same step on the same batches, from the same fresh state,
    under deterministic algorithms: bitwise."""
    from repro_torch.optim import adam
    from repro_torch.runtime.engine import BatcherConfig
    from repro_torch.train.learner import LearnerEngine
    from repro_torch.train.step import init_state, learner_update_fns

    fns = learner_update_fns(cfg, adam.AdamConfig(lr=3e-4, grad_clip_norm=1.0))
    fresh = lambda: init_state(torch.Generator(device=dev).manual_seed(2), cfg, device=dev)  # noqa: E731
    torch.use_deterministic_algorithms(True)
    try:
        eng = LearnerEngine(fresh(), fns, dims=[cfg.d_model, cfg.vocab_size], force_mode="jnp", pad_policy="exact",
                            batcher=BatcherConfig(buckets=(LM_TRAIN_CLI["batch"],)))
        streamed = [eng.run_update(b) for b in host_batches]
        direct, losses = fresh(), []
        for b in host_batches:
            direct, m = fns["jnp"](direct, {k: torch.from_numpy(v).to(dev) for k, v in b.items()})
            losses.append(float(m["loss"]))
        differ = _bitwise_trees(eng.state, direct)
        eng.close()
    finally:
        torch.use_deterministic_algorithms(False)
    require([m["loss"] for m in streamed] == losses, f"lm_train learner: losses {streamed} against {losses}")
    require(not differ, f"lm_train learner: the streamed state differs from direct calls at {differ[:6]}")
    return {"steps": len(host_batches), "bucket": LM_TRAIN_CLI["batch"], "state": "bitwise direct calls",
            "losses": losses, "modes": sorted({m["mode"] for m in streamed})}


def phase_lm_train(gen: torch.Generator, dev, dev_info: dict) -> dict:
    """LM training at full width (module docstring): demo-100m through the
    train CLI (70 steps, resumed from 60, deterministic), its step ms, tokens/s,
    MFU, peak memory and a profiler pass, the ce_chunk and remat variants,
    the learner path, and one float32 step per family card against CPU.
    The six ported kernels' counts are set to 0 before and must read 0
    after (the reference's LM training path calls no Pallas kernel)."""
    from repro_torch import tree
    from repro_torch.data.synthetic import DataConfig, make_batch
    from repro_torch.models.config import ShapeConfig

    _reset_counts()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    c = LM_TRAIN_CLI
    cfg = _lm_train_config()
    report = {"model": cfg.name, "config": {"n_layers": cfg.n_layers, "d_model": cfg.d_model, "n_heads": cfg.n_heads,
                                            "n_kv_heads": cfg.n_kv_heads, "d_ff": cfg.d_ff,
                                            "vocab_size": cfg.vocab_size, "dtype": cfg.dtype, "remat": cfg.remat},
              "batch": c["batch"], "seq": c["seq"], "qat_delay": c["qat_delay"]}
    seconds = {}
    t0 = time.perf_counter()
    report["cli"], state = _lm_train_resume(dev)
    seconds["cli"] = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree.leaves(state.params))
    del state
    shape = ShapeConfig("lm_train", "train", c["seq"], c["batch"])
    host = [{k: v.numpy() for k, v in make_batch(DataConfig(seed=5), cfg, shape, i, device="cpu").items()}
            for i in range(LM_TRAIN_LEARNER_STEPS)]
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in b.items()} for b in host]
    t0 = time.perf_counter()
    timed = _lm_train_timed(cfg, dev, batches, profile=True)
    seconds["timed_and_profile"] = time.perf_counter() - t0
    flops = _lm_train_flops(cfg, c["batch"], c["seq"], n_params)
    tokens = c["batch"] * c["seq"]
    report.update(params=n_params, model_flops_per_step=flops, step_ms_p50=timed["ms_p50"],
                  tokens_per_s=tokens / timed["ms_p50"] * 1e3,
                  mfu=flops / (timed["ms_p50"] / 1e3) / BF16_DENSE_PEAK, mfu_peak="989 TFLOP/s dense bf16",
                  peak_memory_bytes=timed["peak_memory_bytes"], step_ms=timed["ms"], profile=timed.get("profile"),
                  bound_ms_at_peak=flops / BF16_DENSE_PEAK * 1e3)
    report["variants"] = {"default": {k: timed[k] for k in ("ms_p50", "peak_memory_bytes", "remat", "ce_chunk")}}
    t0 = time.perf_counter()
    for name, kw in LM_TRAIN_VARIANTS.items():
        v = _lm_train_timed(cfg, dev, batches, **kw)
        report["variants"][name] = {k: v[k] for k in ("ms", "ms_p50", "peak_memory_bytes", "remat", "ce_chunk")}
    seconds["variants"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    report["learner"] = _lm_train_learner(cfg, dev, host)
    seconds["learner"] = time.perf_counter() - t0
    del batches
    t0 = time.perf_counter()
    report["families"] = {arch: _lm_train_family(arch, gen, dev) for arch in LM_TRAIN_FAMILIES}
    seconds["families"] = time.perf_counter() - t0
    report["seconds"] = seconds
    launches = _lm_launches()
    require(not any(launches.values()), f"lm_train: a ported kernel ran on the LM training path: {launches}")
    report["launches"] = launches
    emit("lm_train", nvidia_smi=dev_info["nvidia_smi"],
         tolerance={"families_loss": f"{LM_TRAIN_F32_TOL}·|loss| + {LM_TRAIN_F32_TOL}",
                    "families_grad_leaf": f"{LM_TRAIN_F32_TOL}·max|g_leaf| + 1e-6", "families_ranges": "2e-5",
                    "resume": "bitwise", "learner": "bitwise", "ranges_after_delay": "bitwise"},
         **report)
    return report


DIST_TRAIN = dict(batch=8, seq=1024, qat_delay=2, steps=3)
DIST_SERVE = dict(arch="qwen2_0_5b", batch=2, prompt=1024, new=16)
DIST_MOE = dict(arch="moonshot_v1_16b_a3b", n_layers=2, batch=64, seq=1024)  # 65,536 tokens
DIST_TIMED = 2  # steps timed per path (the first not counted)


def _dist_group(dev):
    """A one-rank process group on `dev` (NCCL on the card, gloo on the
    CPU) and the (1, 1) mesh over it."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_distributed, make_debug_mesh

    init_distributed(dev, store=dist.HashStore(), rank=0, world_size=1)
    return make_debug_mesh(n_data=1, n_model=1)


def _dist_train(dev, mesh) -> dict:
    """demo-100m train steps: the mesh path against the plain one, bitwise,
    under deterministic algorithms; then both paths timed and profiled."""
    from repro_torch import tree
    from repro_torch.core.parallelism import distribute_tree, gather_tree, rules_for
    from repro_torch.data.synthetic import DataConfig, make_batch
    from repro_torch.launch import specs
    from repro_torch.launch.mesh import mesh_context
    from repro_torch.models.config import ShapeConfig
    from repro_torch.optim import adam
    from repro_torch.train.step import init_state, make_train_step

    c = DIST_TRAIN
    cfg = dataclasses.replace(_lm_train_config(), qat_delay=c["qat_delay"])
    shape = ShapeConfig("dist_train", "train", c["seq"], c["batch"])
    rules = rules_for(mesh, "train")
    st_sh, b_sh = specs.train_shardings(cfg, shape, mesh, rules)
    opt = adam.AdamConfig(lr=1e-4, grad_clip_norm=1.0)
    plain, sharded = make_train_step(cfg, opt), make_train_step(cfg, opt, rules=rules)
    batches = [make_batch(DataConfig(seed=7), cfg, shape, i, device=dev) for i in range(c["steps"])]
    fresh = lambda: init_state(torch.Generator(device=dev).manual_seed(3), cfg, device=dev)  # noqa: E731
    torch.use_deterministic_algorithms(True)
    try:
        state, losses, norms = fresh(), [], []
        for b in batches:
            state, m = plain(state, b)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        dstate, dlosses, dnorms = distribute_tree(fresh(), st_sh), [], []
        with mesh_context(mesh):
            for b in batches:
                dstate, m = sharded(dstate, distribute_tree(b, b_sh))
                dlosses.append(float(m["loss"].full_tensor()))
                dnorms.append(float(m["grad_norm"]))
        differ = _bitwise_trees(gather_tree(dstate), state)
        placements = sorted({str(t.placements) for t in tree.leaves(dstate)})
    finally:
        torch.use_deterministic_algorithms(False)
    require(dlosses == losses, f"dist train: losses {dlosses} against the plain step's {losses}")
    require(dnorms == norms, f"dist train: grad norms {dnorms} against {norms}")
    require(not differ, f"dist train: the mesh path's state differs from the plain one at {differ[:6]}")
    del state, dstate
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    def timed(step, state, place):
        ms = []
        for i in range(DIST_TIMED):
            sync(dev)
            t0 = time.perf_counter()
            state, m = step(state, place(batches[i % len(batches)]))
            sync(dev)
            ms.append((time.perf_counter() - t0) * 1e3)
        prof = _profile(lambda: step(state, place(batches[0])), 1, "step") if dev.type == "cuda" else {}
        return {"ms": ms, "ms_p50": statistics.median(ms[1:]),
                **{k: v for k, v in prof.items() if not k.startswith(("runtime_calls", "top_"))}}

    times = {"plain": timed(plain, fresh(), lambda b: b)}
    with mesh_context(mesh):
        times["mesh"] = timed(sharded, distribute_tree(fresh(), st_sh), lambda b: distribute_tree(b, b_sh))
    return {"model": cfg.name, "batch": c["batch"], "seq": c["seq"], "qat_delay": c["qat_delay"],
            "losses": losses, "grad_norms": norms, "state": "bitwise the plain step's",
            "placements": placements, "deterministic_algorithms": True, "times": times}


def _dist_serve(dev, mesh, gen) -> dict:
    """qwen2-0.5b's bf16 serving tree: a prefill into a cache and greedy
    decode steps on the mesh path against the plain path, bitwise."""
    from repro_torch.core.parallelism import NamedSharding, distribute_tree, rules_for
    from repro_torch.launch import specs
    from repro_torch.launch.dryrun import _serve_layout_hints
    from repro_torch.launch.mesh import mesh_context
    from repro_torch.models import transformer as T
    from repro_torch.models.config import ShapeConfig

    c = DIST_SERVE
    cfg = _lm_config(c["arch"])
    b, s, new = c["batch"], c["prompt"], c["new"]
    params = T.serving_params(T.init_params(torch.Generator(device=dev).manual_seed(_lm_seed(gen)), cfg,
                                            device=dev), cfg)
    rules = rules_for(mesh, "serve", **_serve_layout_hints(cfg, mesh))
    shape = ShapeConfig("dist_decode", "decode", s + new, b)
    p_sh, b_sh, c_sh = specs.serve_shardings(cfg, shape, mesh, rules)
    dparams = distribute_tree(params, p_sh)
    prompt = torch.randint(0, cfg.vocab_size, (b, s), generator=torch.Generator(device=dev).manual_seed(9),
                           device=dev, dtype=torch.int32)
    tok_sh = NamedSharding(mesh, rules.mesh_axes(("batch", "seq"), (b, s), mesh))
    with torch.no_grad():  # DTensor views refuse inference mode
        cache = T.init_cache(cfg, b, s + new, device=dev)
        dcache = distribute_tree(T.init_cache(cfg, b, s + new, device=dev), c_sh)
        want, cache = T.prefill(params, {"tokens": prompt}, cfg, cache=cache)
        with mesh_context(mesh):
            got, dcache = T.prefill(dparams, {"tokens": distribute_tree(prompt, tok_sh)}, cfg, rules=rules,
                                    cache=dcache)
        steps = [bool(torch.equal(got.full_tensor(), want))]
        for i in range(new):
            tok = want.argmax(-1)[:, None].to(torch.int32)
            want, cache = T.decode_step(params, tok, cache, s + i, cfg)
            with mesh_context(mesh):
                got, dcache = T.decode_step(dparams, distribute_tree({"tokens": tok}, b_sh)["tokens"], dcache,
                                            s + i, cfg, rules=rules)
            steps.append(bool(torch.equal(got.full_tensor(), want)))
            want = want[:, -1]
    require(all(steps), f"dist serve: logits differ from the plain path at steps {[i for i, ok in enumerate(steps) if not ok]}")
    del params, dparams, cache, dcache
    return {"model": cfg.name, "batch": b, "prompt": s, "decode_steps": new, "logits": "bitwise the plain path's"}


def _dist_moe(dev, mesh, gen) -> dict:
    """moonshot-v1-16b-a3b cut to 2 layers, bf16 serving tree: a prefill at
    65,536 tokens takes the expert-parallel path at model = 1 (counted);
    against the plain dense dispatch within the bf16 serving contract."""
    from repro_torch.core.parallelism import NamedSharding, distribute_tree, rules_for
    from repro_torch.launch import specs
    from repro_torch.launch.dryrun import _serve_layout_hints
    from repro_torch.launch.mesh import mesh_context
    from repro_torch.models import moe
    from repro_torch.models import transformer as T
    from repro_torch.models.config import ShapeConfig

    c = DIST_MOE
    cfg = dataclasses.replace(_lm_config(c["arch"]), n_layers=c["n_layers"])
    b, s = c["batch"], c["seq"]
    require(b * s >= moe.SHARDED_MIN_TOKENS, "dist moe: below the expert-parallel threshold")
    params = T.serving_params(T.init_params(torch.Generator(device=dev).manual_seed(_lm_seed(gen)), cfg,
                                            device=dev), cfg)
    rules = rules_for(mesh, "serve", **_serve_layout_hints(cfg, mesh))
    p_sh, _, _ = specs.serve_shardings(cfg, ShapeConfig("dist_moe", "prefill", s, b), mesh, rules)
    dparams = distribute_tree(params, p_sh)
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=torch.Generator(device=dev).manual_seed(11),
                           device=dev, dtype=torch.int32)
    calls = [0]
    body = moe._moe_forward_sharded

    def counted(*a, **k):
        calls[0] += 1
        return body(*a, **k)

    cap = moe.capacity(b * s, cfg)
    with torch.no_grad():  # DTensor views refuse inference mode
        want = T.prefill(params, {"tokens": tokens}, cfg).clone()  # the last position: the rest freed
        sync(dev)
        moe._moe_forward_sharded = counted
        try:
            t0 = time.perf_counter()
            with mesh_context(mesh):
                got = T.prefill(dparams, {"tokens": distribute_tree(tokens, NamedSharding(
                    mesh, rules.mesh_axes(("batch", "seq"), (b, s), mesh)))}, cfg, rules=rules)
                got = got.full_tensor().clone()
            sync(dev)
            mesh_s = time.perf_counter() - t0
        finally:
            moe._moe_forward_sharded = body
    require(calls[0] == cfg.n_layers, f"dist moe: the expert-parallel path ran {calls[0]} times, not {cfg.n_layers}")
    err = compare(got.float(), want.float(), LM_TOL, "dist moe: expert-parallel prefill against the dense dispatch")
    out = {"model": cfg.name, "n_layers": cfg.n_layers, "tokens": b * s, "batch": b, "seq": s,
           "expert_parallel_calls": calls[0], "capacity": cap, "bitwise": bool(torch.equal(got, want)),
           "max_abs_err": err["max_abs"], "mesh_prefill_s": mesh_s,
           "buffer_bytes": {"dispatch (E, C+1, d)": cfg.n_experts * (cap + 1) * cfg.d_model * 2,
                            "hidden (E, C, f)": cfg.n_experts * cap * cfg.d_ff * 2,
                            "logits (B, S, V)": b * s * cfg.vocab_size * 2}}
    if dev.type == "cuda":
        out["peak_memory_bytes"] = torch.cuda.max_memory_allocated(dev)
    del params, dparams
    return out


def phase_dist(gen: torch.Generator, dev, dev_info: dict) -> dict:
    """The sharded code at world size 1 on the card (module docstring).
    The six ported kernels' counts are set to 0 before and must read 0
    after (the LM paths run no kernel of the port's own)."""
    import torch.distributed as dist

    _reset_counts()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    seconds = {}
    mesh = _dist_group(dev)
    try:
        t0 = time.perf_counter()
        train = _dist_train(dev, mesh)
        seconds["train"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        serve = _dist_serve(dev, mesh, gen)
        seconds["serve"] = time.perf_counter() - t0
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        moe_report = _dist_moe(dev, mesh, gen)
        seconds["moe"] = time.perf_counter() - t0
        backend = dist.get_backend()
    finally:
        dist.destroy_process_group()
    launches = _lm_launches()
    require(not any(launches.values()), f"dist: a ported kernel ran on the sharded LM path: {launches}")
    report = {"world_size": 1, "backend": backend, "mesh": mesh.shape, "train": train, "serve": serve,
              "moe": moe_report, "seconds": seconds, "launches": launches}
    emit("dist", nvidia_smi=dev_info["nvidia_smi"],
         tolerance={"train": "bitwise (deterministic algorithms)", "serve": "bitwise",
                    "moe": f"{LM_TOL}·scale + {LM_TOL}"}, **report)
    return report


DRYRUN_CALIBRATION = (("demo_100m", "train", 8, 1024), ("qwen2_0_5b", "prefill", 1, 1024))  # (arch, kind, B, S)
DRYRUN_CELLS = (("qwen2_0_5b", "decode_32k", False), ("qwen2_0_5b", "train_4k", True))  # (arch, shape, multi_pod)
DRYRUN_TOL = 0.10  # the estimate's relative distance from the allocator's peak
DRYRUN_TIMEOUT = 300  # seconds for one production cell's CLI run


def _dryrun_cell(arch: str, kind: str, batch: int, seq: int, dev):
    """(step, args) of a calibration cell on `dev`, no mesh: demo-100m's
    train step as `lm_train` runs it (QAT, remat "dots"), or a prefill of
    the float32 params (cast per use)."""
    from repro_torch.data.synthetic import DataConfig, make_batch
    from repro_torch.models import transformer as T
    from repro_torch.models.config import ShapeConfig
    from repro_torch.optim import adam, schedule
    from repro_torch.serve.engine import make_prefill
    from repro_torch.train.step import init_state, make_train_step

    shape = ShapeConfig("calibration", kind, seq, batch)
    if kind == "train":
        cfg = _lm_train_config()
        opt = adam.AdamConfig(lr=3e-4, grad_clip_norm=1.0, schedule=schedule.warmup_cosine(50, LM_TRAIN_CLI["steps"]))
        state = init_state(torch.Generator(device=dev).manual_seed(1), cfg, device=dev)
        return make_train_step(cfg, opt), (state, make_batch(DataConfig(seed=5), cfg, shape, 0, device=dev))
    cfg = _lm_config(arch)
    params = T.init_params(torch.Generator(device=dev).manual_seed(2), cfg, device=dev)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq), generator=torch.Generator().manual_seed(3),
                           dtype=torch.int32).to(dev)
    return make_prefill(cfg), (params, {"tokens": tokens})


def _dryrun_calibrate(arch: str, kind: str, batch: int, seq: int, dev) -> dict:
    """The cell once for real (the allocator's peak over it, from its
    arguments' creation on) and once under fake tensors with no group
    (`launch.dryrun.measure`'s estimate); the estimate within DRYRUN_TOL of
    the allocator's."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch import dryrun

    grad = torch.enable_grad if kind == "train" else torch.no_grad
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    sync(dev)
    base = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    fn, args = _dryrun_cell(arch, kind, batch, seq, dev)
    with grad():
        out = fn(*args)
    sync(dev)
    real_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    del fn, args, out
    t0 = time.perf_counter()
    with FakeTensorMode(), grad():
        est = dryrun.measure(*_dryrun_cell(arch, kind, batch, seq, dev))
    fake_s = time.perf_counter() - t0
    row = {"arch": arch, "kind": kind, "batch": batch, "seq": seq, "estimate_bytes": est["memory"]["peak_bytes"],
           "estimate_argument_bytes": est["memory"]["argument_bytes"], "real_s": real_s, "fake_s": fake_s}
    if peak is not None:
        real = peak - base
        row.update(max_memory_allocated=peak, allocated_before=base, allocator_peak_bytes=real,
                   rel_err=(row["estimate_bytes"] - real) / real)
        require(abs(row["rel_err"]) <= DRYRUN_TOL,
                f"dryrun calibration {arch} {kind}: estimate {row['estimate_bytes']} B against the allocator's "
                f"{real} B ({row['rel_err']:+.3f}, limit {DRYRUN_TOL})")
    return row


def _dryrun_start(cells, dev, work: pathlib.Path) -> list:
    """Start `python -m repro_torch.launch.dryrun` for each production
    cell, each in a process of its own (each starts the fake world of its
    mesh), all at once."""
    work.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(p for p in (str(SRC), os.environ.get("PYTHONPATH")) if p))
    procs = []
    for arch, shape, multi_pod in cells:
        out = work / f"{arch}_{shape}_{'pod2x16x16' if multi_pod else 'pod16x16'}.json"
        out.unlink(missing_ok=True)
        argv = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape,
                "--device", dev.type, "--out", str(out)] + (["--multi-pod"] if multi_pod else [])
        procs.append((out, subprocess.Popen(argv, cwd=str(REPO), env=env, stdout=subprocess.PIPE,
                                            stderr=subprocess.PIPE, text=True), time.perf_counter()))
    return procs


def _dryrun_wait(procs) -> list:
    """Each started cell's record; every cell must end "ok"."""
    rows = []
    for out, proc, t0 in procs:
        try:
            stdout, stderr = proc.communicate(timeout=max(1.0, DRYRUN_TIMEOUT - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            require(False, f"dryrun: {out.name} did not finish within {DRYRUN_TIMEOUT} s")
        require(proc.returncode == 0 and out.is_file(),
                f"dryrun: {out.name} exited {proc.returncode}: {stdout[-1500:]} {stderr[-1500:]}")
        rec = json.loads(out.read_text())
        require(rec["status"] == "ok", f"dryrun: {out.name}: {rec.get('error')}")
        require(rec["planner_ops"] > 0, f"dryrun: {out.name}: no op of DTensor's sharding planner was recognised "
                                        "(launch.dryrun._in_sharding_propagation): its peak would count them")
        rows.append({**{k: rec[k] for k in ("arch", "shape", "mesh", "status", "n_devices", "flops",
                                            "flops_per_rank", "collective_bytes", "collective_counts", "memory",
                                            "planner_ops", "build_s", "run_s")},
                     "process_s": time.perf_counter() - t0})
    return rows


def phase_dryrun(gen: torch.Generator, dev, dev_info: dict) -> dict:
    """The production dry run (slice 13, module docstring): the production
    cells through the CLI, in processes of their own, while this one
    calibrates the estimator against the card's allocator.  The six
    kernels' counts are set to 0 before and must read 0 after."""
    _reset_counts()
    t0 = time.perf_counter()
    procs = _dryrun_start(DRYRUN_CELLS, dev, REPO / "build" / "dryrun")
    try:
        calibration = [_dryrun_calibrate(*c, dev) for c in DRYRUN_CALIBRATION]
        calibration_s = time.perf_counter() - t0
        launches = _lm_launches()
        require(not any(launches.values()), f"dryrun: a ported kernel ran on the calibration cells: {launches}")
        cells = _dryrun_wait(procs)
    finally:
        for _, proc, _ in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    from repro_torch.launch.dryrun import HBM_BYTES

    for c in cells:  # the threshold of PERF.md's table (tools/dryrun_table.py)
        c["peak_gb_per_rank"] = c["memory"]["peak_bytes"] / 1e9
        c["fits_gb"] = HBM_BYTES / 1e9
        c["fits"] = c["memory"]["peak_bytes"] <= HBM_BYTES
    report = {"calibration": calibration, "cells": cells, "launches": launches,
              "seconds": {"calibration": calibration_s, "phase": time.perf_counter() - t0}}
    emit("dryrun", nvidia_smi=dev_info["nvidia_smi"],
         tolerance=f"estimate within {DRYRUN_TOL:.0%} of the allocator's peak", **report)
    return report


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

    # cuBLAS reads its workspace setting once: a deterministic one from the
    # start, so the lm_train phase can run under deterministic algorithms
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(args.seed)
    t0 = time.perf_counter()
    dev_info = phase_device()
    phase_build()
    err_a = phase_kernel_a(gen, dev)
    err_b, err_b_quant = phase_kernel_b(gen, dev)
    err_b_res, err_qs = phase_kernel_b_res(gen, dev)
    err_bwd = phase_kernel_bwd(gen, dev)
    err_step = phase_kernel_step(gen, dev)
    err_mq = phase_kernel_mq(gen, dev)
    serve_launches = phase_serve(gen, dev)
    layer = phase_layer_monitor(gen, dev)
    phase_fxp_raw(gen, dev)
    phase_update(gen, dev)
    phase_update(gen, dev, "pallas_fused_step")
    train = phase_train(gen, dev, args.seed)
    fused, fused_agent = phase_train_fused(gen, dev, args.seed, train)
    learner = phase_learner(dev, args.seed, fused_agent)["launches"]
    phase_profile(gen, dev)
    times = phase_times(gen, dev, dev_info)
    phase_engine_latency(gen, dev)
    phase_mesh(gen, dev)
    lm_launches = phase_lm(gen, dev, dev_info)["launches"]
    lm_train_launches = phase_lm_train(gen, dev, dev_info)["launches"]
    dist_launches = phase_dist(gen, dev, dev_info)["launches"]
    dryrun_launches = phase_dryrun(gen, dev, dev_info)["launches"]

    host, device = fused["train_host"], fused["train_device"]

    def fused_path(name: str) -> dict:
        return {"train_fused.train_host": host["launches"][name],
                "train_fused.train_device": {"wrapper_calls": device["wrapper_calls"][name], "captured_calls": 1,
                                             "graph_replays": device["graph_replays"],
                                             "executed": device["executed"][name]}}

    by_path = {
        "fxp_dense": {"serve": serve_launches["fxp_dense"]},
        "fxp_mlp_fwd": {"serve": serve_launches["fxp_mlp_fwd"], "train": train["launches"]["fxp_mlp_fwd"],
                        **fused_path("fxp_mlp_fwd"), "learner": learner["fxp_mlp_fwd"]},
        "fxp_mlp_bwd": {"train": train["launches"]["fxp_mlp_bwd"], "learner": learner["fxp_mlp_bwd"]},
        "ddpg_critic_step": {**fused_path("ddpg_critic_step"), "learner": learner["ddpg_critic_step"]},
        "ddpg_actor_step": {**fused_path("ddpg_actor_step"), "learner": learner["ddpg_actor_step"]},
        "fxp_monitor_quant": {"layer_monitor": layer["launches"]["fxp_monitor_quant"]},
    }
    for name, paths in by_path.items():  # the LM zoo's paths: none of the six (checked to be 0 there)
        paths["lm"] = lm_launches[name]
        paths["lm_train"] = lm_train_launches[name]
        paths["dist"] = dist_launches[name]
        paths["dryrun"] = dryrun_launches[name]

    def wrapper_count(paths: dict) -> int:
        return sum(v["wrapper_calls"] if isinstance(v, dict) else v for v in paths.values())

    kernels = []
    for name, source, replaces, key, err, tol in (
        ("fxp_dense", "src/repro_torch/csrc/fxp_dense.cu", "src/repro/kernels/fxp_matmul/kernel.py:47",
         ("fxp_dense", "chain 17-400-300-6", 512, "full"), err_a, TOL),
        ("fxp_mlp_fwd", "src/repro_torch/csrc/fxp_mlp_fwd.cu", "src/repro/kernels/fxp_mlp/kernel.py:76",
         ("fxp_mlp_fwd", "17-400-300-6", 512, "monitor (full)"), max(err_b, err_b_quant, err_b_res), TOL_QUANT),
        ("fxp_mlp_bwd", "src/repro_torch/csrc/fxp_mlp_bwd.cu", "src/repro/kernels/fxp_mlp/kernel.py:223",
         ("fxp_mlp_bwd", "critic 23-400-300-1", _paper_ddpg(0).batch_size, "monitor"), err_bwd,
         {"rtol": GRAD_TOL["quant"][0], "atol": GRAD_TOL["quant"][1]}),
        ("ddpg_critic_step", "src/repro_torch/csrc/fxp_ddpg_step.cu", "src/repro/kernels/fxp_mlp/kernel.py:481",
         ("ddpg_critic_step", "actor 17-400-300-6, critic 23-400-300-1", _paper_ddpg(0).batch_size, "monitor"),
         err_step["critic"], _step_tolerance()),
        ("ddpg_actor_step", "src/repro_torch/csrc/fxp_ddpg_step.cu", "src/repro/kernels/fxp_mlp/kernel.py:632",
         ("ddpg_actor_step", "actor 17-400-300-6, critic 23-400-300-1", _paper_ddpg(0).batch_size, "monitor"),
         err_step["actor"], _step_tolerance()),
        ("fxp_monitor_quant", "src/repro_torch/csrc/fxp_monitor_quant.cu", "src/repro/kernels/quantize/kernel.py:30",
         ("fxp_monitor_quant", "512x400", 512, "monitor"), err_mq, "bitwise"),
    ):
        row = times[key]
        entry = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": wrapper_count(by_path[name]), "launches_by_path": by_path[name],
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
            entry["pass_us"] = row["pass_us"]
            entry["library_note"] = "no single PyTorch call computes the masked backward chain"
        if name.startswith("ddpg_"):
            entry["cuda_launches_per_call"] = STEP_CUDA_LAUNCHES[name]
            entry["pass_us"] = row["pass_us"]
            entry["library_note"] = "no single PyTorch call computes a whole DDPG half-update"
        if name == "fxp_monitor_quant":
            entry["cuda_launches_per_call"] = 1
            entry["library_note"] = (f"no single PyTorch call computes it; torch.aminmax, the reduction alone: "
                                     f"{row['library_note_aminmax_ms']} ms")
        kernels.append(entry)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"device": dev_info, "kernels": kernels,
                                        "times": list(times.values()), "phases": PHASES}, indent=1))
    emit("done", seconds=time.perf_counter() - t0)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
