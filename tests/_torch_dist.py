"""Run cases on several CPU ranks of a `gloo` process group, for the port's
sharded tests (`tests/test_torch_dist_*.py`).

`run_ranks(world, workdir, cases)` starts `world` processes (the `spawn`
start method: nothing of the parent, JAX included, is inherited), joins
them to one group through a `FileStore` in `workdir` (no ports), and has
every rank run every case in order: a case is (name, "module:function",
kwargs), called as `fn(rank, world, **kwargs)` with one CPU thread.  Each
rank writes each case's result (or its error) to a file; the parent waits
for every case in turn, up to its own timeout, and returns
{name: rank 0's result} — a case that raised on any rank, or hung, comes
back as a `CaseError` — and prints each case's seconds to stderr.  The group is destroyed in a `finally`.

`start_reference(script, *args)` runs the JAX reference's side of a test
beside the ranks: `script` in a Python subprocess whose XLA has 8 forced
host devices (`REF_PREAMBLE` sets them before JAX is imported and puts the
repo's `src` on the path); `wait_reference` collects it.
"""

from __future__ import annotations

import importlib
import multiprocessing as mp
import os
import pathlib
import pickle
import subprocess
import sys
import time
import traceback

CASE_TIMEOUT = 240.0  # seconds for one case on every rank
SRC = str(pathlib.Path(__file__).resolve().parents[1] / "src")
REF_PREAMBLE = f"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, {SRC!r})
"""


class CaseError(Exception):
    pass


def _rank_main(rank: int, world: int, workdir: str, cases: list, src: str) -> None:
    sys.path.insert(0, src)
    import torch

    torch.set_num_threads(1)
    torch.manual_seed(0)
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_distributed

    work = pathlib.Path(workdir)
    try:
        init_distributed("cpu", store=dist.FileStore(str(work / "store"), world), rank=rank, world_size=world)
        for name, target, kwargs in cases:
            mod, fn = target.split(":")
            try:
                out = ("ok", getattr(importlib.import_module(mod), fn)(rank, world, **kwargs))
            except BaseException:  # noqa: BLE001 — reported to the parent
                out = ("error", traceback.format_exc())
            tmp = work / f".{name}.{rank}"
            tmp.write_bytes(pickle.dumps(out))
            tmp.rename(work / f"{name}.{rank}")
            if out[0] == "error":
                break  # the other ranks may be waiting in a collective
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(world: int, workdir, cases: list, *, timeout: float = CASE_TIMEOUT) -> dict:
    work = pathlib.Path(workdir)
    work.mkdir(parents=True, exist_ok=True)
    src = SRC
    tests = str(pathlib.Path(__file__).resolve().parent)
    ctx = mp.get_context("spawn")
    old_path = os.environ.get("PYTHONPATH")
    os.environ["PYTHONPATH"] = os.pathsep.join(p for p in (src, tests, old_path) if p)
    try:
        procs = [ctx.Process(target=_rank_main, args=(r, world, str(work), cases, src), daemon=True)
                 for r in range(world)]
        for p in procs:
            p.start()
    finally:
        if old_path is None:
            os.environ.pop("PYTHONPATH", None)
        else:
            os.environ["PYTHONPATH"] = old_path
    results: dict = {}
    seconds: dict = {}
    start = time.monotonic()
    try:
        for name, _, _ in cases:
            deadline = time.monotonic() + timeout
            files = [work / f"{name}.{r}" for r in range(world)]
            while not all(f.exists() for f in files):
                errors = [f for f in files if f.exists() and pickle.loads(f.read_bytes())[0] == "error"]
                dead = [p for p in procs if not p.is_alive() and p.exitcode not in (0, None)]
                if errors or dead or time.monotonic() > deadline:
                    break
                time.sleep(0.05)
            seconds[name] = time.monotonic() - start
            start = time.monotonic()
            outs = [pickle.loads(f.read_bytes()) if f.exists() else None for f in files]
            errs = [o[1] for o in outs if o is not None and o[0] == "error"]
            if errs:
                results[name] = CaseError(errs[0])
            elif any(o is None for o in outs):
                results[name] = CaseError(f"case {name} did not finish on every rank within {timeout} s")
            else:
                results[name] = outs[0][1]
            if isinstance(results[name], CaseError):
                for rest, _, _ in cases[len(seconds):]:
                    results[rest] = CaseError(f"not run: case {name} failed before it")
                break
    finally:
        for p in procs:
            p.join(timeout=10 if len(results) == len(cases) else 0.1)
            if p.is_alive():
                p.kill()
                p.join()
    print("seconds per case (the first includes the ranks' start):",
          {k: round(v, 1) for k, v in seconds.items()}, file=sys.stderr)
    return results


def result(results: dict, name: str):
    """The case's rank-0 result; raises its error."""
    out = results[name]
    if isinstance(out, CaseError):
        raise out
    return out


def start_reference(script: str, *args) -> subprocess.Popen:
    """`REF_PREAMBLE + script` in a Python subprocess, `args` as its argv[1:]."""
    return subprocess.Popen([sys.executable, "-c", REF_PREAMBLE + script, *map(str, args)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def wait_reference(proc: subprocess.Popen, timeout: float = 600.0) -> None:
    """Wait for a `start_reference` process; raises with its stderr's tail
    if it failed (and kills it if it outlives `timeout`)."""
    try:
        _, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise CaseError(f"the reference's process did not finish within {timeout} s")
    if proc.returncode != 0:
        raise CaseError(err[-3000:])
