#!/usr/bin/env python3
"""Where kernel 3's chain pass spends its time, phase by phase.

    python3 tools/bwd_phases.py [--batch B] [--plan BM,C] [--calls N]

Builds `src/repro_torch/csrc/fxp_mlp_bwd.cu` with -DFXP_BWD_TRACE into
`build/kernels/libfxp_mlp_bwd_trace.so` (the kernel's own library compiles
the stamps out), then runs kernel 3 through it for the paper's actor and
critic on kernel B's residuals, in both phases, on `bwd_plan`'s plan or on
the one forced by --plan.  Thread 0 of every block stamps clock64() after
each phase of its first row block; %globaltimer at its entry and exit gives
each block's clock rate.  Prints one JSON line per case: for each phase the
median and the largest duration over the grid's blocks and N calls, in ns,
and the spread of the blocks' entries.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import statistics
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]
SLOTS = 32  # csrc/fxp_mlp_bwd.cu TRACE_SLOTS


def phases(n_layers: int) -> list:
    """(name, first slot, last slot) of each phase, as the kernel stamps them."""
    out = [("weights requested", 0, 1), ("residual loads", 1, 2), ("weights arrived", 2, 3)]
    prev = 3
    for i in range(n_layers):
        l = n_layers - 1 - i
        out += [(f"layer {l} act_bwd", prev, 4 + 2 * i), (f"layer {l} bwd_dx", 4 + 2 * i, 5 + 2 * i)]
        prev = 5 + 2 * i
    out += [("dx store, later row blocks", prev, 4 + 2 * n_layers), ("exit barrier", 4 + 2 * n_layers,
                                                                      5 + 2 * n_layers),
            ("whole", 0, 5 + 2 * n_layers)]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--plan", default=None, help="rows per block and cluster width, e.g. 16,8")
    ap.add_argument("--calls", type=int, default=5)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(REPO), str(REPO / "src")]
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.fxp_mlp import kernel as K

    if not torch.cuda.is_available():
        print("bwd_phases: no CUDA device available", file=sys.stderr)
        return 2
    info = cs.phase_device()
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = _build.BUILD_DIR / "libfxp_mlp_bwd_trace.so"
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-DFXP_BWD_TRACE", "-o", str(out),
                    str(_build.CSRC / "fxp_mlp_bwd.cu")], check=True, capture_output=True)
    lib = ctypes.CDLL(str(out))
    lib.fxp_mlp_bwd_error_string.argtypes = [ctypes.c_int]
    lib.fxp_mlp_bwd_error_string.restype = ctypes.c_char_p
    lib.fxp_mlp_bwd_set_trace.argtypes = [ctypes.c_void_p]
    lib.fxp_mlp_bwd_set_trace.restype = ctypes.c_int
    fn = lib.fxp_mlp_bwd_launch
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int]
                   + [ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    K._bwd_launcher = lambda: (lib, fn)
    if args.plan:
        bm, c = map(int, args.plan.split(","))
        K.bwd_plan = lambda m, dims: K._bwd_layout(bm, c, dims, True)._replace(
            n_clusters=min(-(-m // bm), K.CLUSTER_SLOTS[c]))
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(5)
    for net in cs.NETS:
        dims, acts, ws, bs, deltas, zs = cs._net_operands(gen, dev, net)
        x = (torch.randn(args.batch, dims[0], generator=gen) * 2).to(dev)
        g = torch.randn(args.batch, dims[-1], generator=gen).to(dev)
        plan = K.bwd_plan(args.batch, dims)
        blocks = plan.n_clusters * plan.cluster
        trace = torch.zeros(blocks * SLOTS, dtype=torch.int64, device=dev)
        for phase in cs.STEP_PHASES:
            kw = cs._case_kw(acts, phase)
            _, _, _, qs, hs = K.fxp_mlp_fwd_cuda(x, ws, bs, deltas, zs, save_residuals=True, **kw)
            K.fxp_mlp_bwd_cuda(g, x, ws, qs, hs, deltas, zs, **kw)  # warm
            torch.cuda.synchronize()
            assert lib.fxp_mlp_bwd_set_trace(trace.data_ptr()) == 0
            spans = {name: [] for name, _, _ in phases(len(ws))}
            entries = []
            for _ in range(args.calls):
                trace.zero_()
                K.fxp_mlp_bwd_cuda(g, x, ws, qs, hs, deltas, zs, **kw)
                torch.cuda.synchronize()
                t = trace.view(blocks, SLOTS).cpu().tolist()
                last = 5 + 2 * len(ws)
                for row in t:
                    ns_per_cycle = (row[31] - row[30]) / max(1, row[last] - row[0])
                    for name, a, b in phases(len(ws)):
                        spans[name].append((row[b] - row[a]) * ns_per_cycle)
                first = min(row[30] for row in t)
                entries += [row[30] - first for row in t]
            assert lib.fxp_mlp_bwd_set_trace(None) == 0
            print(json.dumps({"bwd_phases": f"{net} {'-'.join(map(str, dims))}", "phase": phase,
                              "batch": args.batch, "plan": list(plan[:4]), "card": info["nvidia_smi"],
                              "ns": {k: {"median": statistics.median(v), "max": max(v)} for k, v in spans.items()},
                              "entry_spread_ns": {"median": statistics.median(entries), "max": max(entries)}}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
