#!/usr/bin/env python3
"""Every LM arch's smoke cells (train, prefill, decode) on a set of meshes,
the port under fake tensors beside the JAX reference's compile, on the CPU.

    PYTHONPATH=src python3 tools/layout_sweep.py [--mesh 2x4 --mesh pod2x2x2 ...]
        [--arch gemma3_1b ...] [--kind train ...] [--reference] [--jobs N]

A mesh is `DxM` (data, model) or `podPxDxM` (pod, data, model); the
default set is seven: 2x4, 4x2, 1x8, 8x1, pod2x2x2 and pod2x4x1 on a world
of 8, and 1x1 on a world of 1.  Shapes: train S = 256, B = 8; prefill and
decode S = 512, B = 8 (decode: one token against a 512-slot cache); QAT on,
as `launch.dryrun` runs a cell.  A cell the dry run skips at the full
config is skipped (hubert-xlarge's decode: encoder-only), so a mesh has 29.

The port's side runs each mesh in a child process of its own (a process
holds one process group): a fake world of the mesh's size
(`launch.mesh.init_fake_world`) and `launch.dryrun.measure_cell(...,
fake=True)` per cell — the production dry run's path at smoke size.  A
cell that raises is a stop, reported with the innermost frame of
`src/repro_torch/` on its traceback.  With `--reference`, a second child
per mesh compiles the reference's cell (`repro.launch.dryrun.build_cell`,
then `.lower(*args).compile()`, as `tests/test_sharding.py` does) on as
many forced XLA host devices as the mesh has.  This script imports
neither package itself; the reference's children are the only processes
that import `repro` or JAX.

It prints one row per (mesh, arch, kind) — the port's status, the
reference's, and the port's file:line for a stop — then one count line
per mesh, and exits 1 when a cell the reference compiles stops in the
port (or, without `--reference`, when any cell stops).  Under fake
tensors a cell costs 1–20 s; the seven meshes take a few minutes each, run
`--jobs` at a time (default 4).
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import pathlib
import subprocess
import sys

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
DEFAULT_MESHES = ("2x4", "4x2", "1x8", "8x1", "pod2x2x2", "pod2x4x1", "1x1")
KINDS = ("train", "prefill", "decode")
# (seq_len, global_batch) per kind
SHAPES = {"train": (256, 8), "prefill": (512, 8), "decode": (512, 8)}
ARCHS = ("dbrx_132b", "deepseek_7b", "gemma3_1b", "hubert_xlarge", "internlm2_1_8b", "moonshot_v1_16b_a3b",
         "phi3_vision_4_2b", "qwen2_0_5b", "recurrentgemma_2b", "rwkv6_1_6b")


def parse_mesh(text: str) -> tuple[tuple[int, ...], tuple[str, ...]]:
    """"2x4" -> ((2, 4), ("data", "model")); "pod2x2x2" -> ((2, 2, 2),
    ("pod", "data", "model"))."""
    pod = text.startswith("pod")
    sizes = tuple(int(n) for n in text[3 if pod else 0:].split("x"))
    axes = ("pod", "data", "model") if pod else ("data", "model")
    if len(sizes) != len(axes) or min(sizes) < 1:
        raise ValueError(f"a mesh is DxM or podPxDxM, got {text!r}")
    return sizes, axes


# One child per mesh: the port's cells on a fake world of the mesh's size.
_PORT = r"""
import json, math, sys, traceback
from repro_torch.configs import registry
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import init_fake_world, make_auto_mesh
from repro_torch.models.config import ShapeConfig

sizes, axes, cells, shapes, src = json.loads(sys.argv[1])
init_fake_world(math.prod(sizes), "cpu")
mesh = make_auto_mesh(sizes, axes)
for arch, kind in cells:
    seq, batch = shapes[kind]
    cfg = registry.get_smoke(arch)
    shape = ShapeConfig(kind[0], kind, seq, batch)
    row = {"arch": arch, "kind": kind}
    if dryrun.skip_reason(registry.get(arch), shape):  # by the full config's name
        row["status"] = "skip"
    else:
        try:
            rec = dryrun.measure_cell(cfg, shape, mesh, qat=True)
            row.update(status="ok", run_s=round(rec["run_s"], 2), peak_bytes=rec["memory"]["peak_bytes"])
        except Exception as e:  # noqa: BLE001 - a stop is this cell's result
            frames = [f for f in traceback.extract_tb(e.__traceback__) if f.filename.startswith(src)]
            where = f"{frames[-1].filename[len(src) + 1:]}:{frames[-1].lineno}" if frames else "?"
            row.update(status="stop", where=where, error=f"{type(e).__name__}: {str(e).splitlines()[0][:200]}")
    print(json.dumps(row), flush=True)
"""

# One child per mesh: the reference's cells compiled on as many forced
# host devices as the mesh has.
_REFERENCE = r"""
import json, math, os, sys
sizes, axes, cells, shapes, src = json.loads(sys.argv[1])
os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={math.prod(sizes)}"
os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, src)
from repro.configs import registry
from repro.launch import dryrun
from repro.launch.mesh import make_auto_mesh, mesh_context
from repro.models.config import ShapeConfig

mesh = make_auto_mesh(tuple(sizes), tuple(axes))
for arch, kind in cells:
    seq, batch = shapes[kind]
    cfg = registry.get_smoke(arch)
    shape = ShapeConfig(kind[0], kind, seq, batch)
    row = {"arch": arch, "kind": kind}
    if dryrun.skip_reason(registry.get(arch), shape):  # by the full config's name
        row["status"] = "skip"
    else:
        try:
            with mesh_context(mesh):
                jitted, args = dryrun.build_cell(cfg, shape, mesh, qat=True)
                jitted.lower(*args).compile()
            row["status"] = "ok"
        except Exception as e:  # noqa: BLE001 - a refusal is this cell's result
            row.update(status="stop", error=f"{type(e).__name__}: {str(e).splitlines()[0][:200]}")
    print(json.dumps(row), flush=True)
"""


def run_mesh(mesh: str, cells: list, *, reference: bool = False, timeout: float = 1800.0) -> dict:
    """One side's child for `mesh` over `cells` ((arch, kind) pairs): the
    port's, or the reference's with `reference`; {(arch, kind): row}, a
    row's "status" "ok", "skip" or "stop".  Cells the child never reported
    (it died or timed out) come back as stops."""
    script = _REFERENCE if reference else _PORT
    sizes, axes = parse_mesh(mesh)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, (str(SRC), os.environ.get("PYTHONPATH")))),
               OMP_NUM_THREADS="1")
    arg = json.dumps([sizes, axes, cells, SHAPES, str(SRC)])
    try:
        out = subprocess.run([sys.executable, "-c", script, arg], capture_output=True, text=True, env=env,
                             timeout=timeout)
        stdout, tail = out.stdout, out.stderr.strip().splitlines()[-1:] or [f"exit {out.returncode}"]
    except subprocess.TimeoutExpired as e:
        stdout = e.stdout.decode() if isinstance(e.stdout, bytes) else (e.stdout or "")
        tail = [f"timed out after {timeout} s"]
    rows = {}
    for line in stdout.splitlines():
        if line.startswith("{"):
            row = json.loads(line)
            rows[(row["arch"], row["kind"])] = row
    for arch, kind in cells:
        rows.setdefault((arch, kind), {"arch": arch, "kind": kind, "status": "stop", "where": "?",
                                       "error": f"child ended: {tail[0][:200]}"})
    return rows


def sweep(meshes, archs, kinds, *, reference: bool, jobs: int, timeout: float = 1800.0) -> list[dict]:
    """Every (arch, kind) cell on every mesh, each mesh's side in a child
    of its own, `jobs` children at once: one row per (mesh, arch, kind)."""
    cells = [(a, k) for a in archs for k in kinds]
    sides = ("port", "reference") if reference else ("port",)
    with concurrent.futures.ThreadPoolExecutor(jobs) as pool:
        futures = {(side, m): pool.submit(run_mesh, m, cells, reference=side == "reference", timeout=timeout)
                   for m in meshes for side in sides}
        got = {key: f.result() for key, f in futures.items()}
    rows = []
    for m in meshes:
        for cell in cells:
            p = got[("port", m)][cell]
            r = got[("reference", m)][cell] if reference else None
            rows.append({"mesh": m, "arch": cell[0], "kind": cell[1], "port": p["status"],
                         "reference": r["status"] if r else None, "where": p.get("where"),
                         "error": p.get("error") or (r or {}).get("error"), "run_s": p.get("run_s")})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mesh", action="append", help="DxM or podPxDxM; repeat (default: the seven)")
    ap.add_argument("--arch", action="append", choices=ARCHS, help="repeat (default: all ten)")
    ap.add_argument("--kind", action="append", choices=KINDS, help="repeat (default: all three)")
    ap.add_argument("--reference", action="store_true", help="also compile the JAX reference's cells")
    ap.add_argument("--jobs", type=int, default=4, help="children at once")
    args = ap.parse_args(argv)
    meshes = args.mesh or list(DEFAULT_MESHES)
    for m in meshes:
        parse_mesh(m)
    rows = sweep(meshes, args.arch or list(ARCHS), args.kind or list(KINDS), reference=args.reference,
                 jobs=args.jobs)
    print(f"{'mesh':<10} {'arch':<20} {'kind':<8} {'port':<5} {'ref':<5} where / error")
    for r in rows:
        note = f"{r['where']}  {r['error']}" if r["port"] == "stop" else (r["error"] or "")
        print(f"{r['mesh']:<10} {r['arch']:<20} {r['kind']:<8} {r['port']:<5} {r['reference'] or '-':<5} {note}")
    bad = 0
    for m in meshes:
        mine = [r for r in rows if r["mesh"] == m and r["port"] != "skip"]
        ran = sum(r["port"] == "ok" for r in mine)
        if args.reference:
            compiled = [r for r in mine if r["reference"] == "ok"]
            missed = sum(r["port"] != "ok" for r in compiled)
            print(f"{m}: port runs {ran} of {len(mine)} cells; reference compiles {len(compiled)}; "
                  f"{len(compiled) - missed} of {len(compiled)} that the reference compiles run in the port")
            bad += missed
        else:
            print(f"{m}: port runs {ran} of {len(mine)} cells")
            bad += len(mine) - ran
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
