"""Run one benchmark cell once on the card and print its result line.

    python3 bench/run.py --workload NAME --seed N --seconds S --trace 0|1

Everything is found by name from `BENCHMARK.json` at the checkout's root:
the cell's configuration (its `file`), its traffic mix
(`bench/traffic/<traffic>.json`, which names its driver,
`bench/drivers/<driver>.py`), the configuration's plain reference
(`bench/reference/<reference>.py`), the cell's limits
(`bench/limits/<cell>.json`) and each per-layer metric's reader
(`bench/metrics/<metric>.py`).  A cell, a mix or a metric is added by
adding files and entries; none of these files names another cell.

With `--trace 0` the result carries the cell's end-to-end metrics, with
`--trace 1` its per-layer metrics and the traced window's device time.
The harness knows nothing of what a cell runs: the driver returns its
end-to-end numbers, its readings for the check, and with `--trace 1` the
traced window (`bench/trace.py`) and whatever its cell's per-layer readers
take (`layer_inputs`: counts, rates, peaks), which each reader gets with
the cell's configuration and traffic mix.
Every run checks what its timed path produced against the plain reference
and prints each number compared beside its limit, last on standard error
and last in the result line (`checks`).

Exit codes: 0 with a result line; 2 bad arguments; 3 no card, or fewer
cards than the cell asks for; 4 a JAX module was loaded; 1 any other
failure.  No path falls back to the CPU.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import pathlib
import sys
import time
import types

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")  # top-level module names, compared whole


def _process_start() -> float:
    """The process's start on the `time.perf_counter` clock (from
    /proc/self/stat, 10 ms resolution), else now."""
    try:
        fields = pathlib.Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()
        started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        age = time.clock_gettime(time.CLOCK_BOOTTIME) - started
        return time.perf_counter() - max(age, 0.0)
    except (OSError, ValueError, IndexError):
        return time.perf_counter()


T_START = _process_start()


def load_module(path: pathlib.Path, name: str) -> types.ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_json(path: pathlib.Path) -> dict:
    return json.loads(path.read_text())


def find_cell(bench: dict, workload: str) -> tuple[dict, dict]:
    """(the cell's entry, its configuration's entry)."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    return cell, configs[cell["config"]]


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def cell_files(root: pathlib.Path, bench: dict, workload: str) -> dict:
    """Every file a cell needs, found by name."""
    cell, conf = find_cell(bench, workload)
    config = read_json(root / conf["file"])
    traffic = read_json(root / "bench" / "traffic" / f"{cell['traffic']}.json")
    return {
        "cell": cell, "config": config, "traffic": traffic,
        "driver": root / "bench" / "drivers" / f"{traffic['driver']}.py",
        "reference": root / "bench" / "reference" / f"{config['reference']}.py",
        "limits": read_json(root / "bench" / "limits" / f"{workload}.json"),
        "metrics": {m["name"]: root / "bench" / "metrics" / f"{m['name']}.py"
                    for m in bench["per_layer"] if applies(m, workload)},
    }


def forbidden_modules() -> list[str]:
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))


def judge(readings: dict, limits: dict) -> tuple[bool, dict]:
    """`correct` and the numbers compared, each beside its limit."""
    checks = {}
    ok = True
    for name, limit in limits["limits"].items():
        value = readings.get(name)
        if value is not None and not math.isfinite(value):
            value = None
        ok = ok and value is not None and value <= limit
        checks[name] = {"value": value, "limit": limit}
    return ok, checks


def _set_caches(root: pathlib.Path) -> None:
    """Build and kernel caches at fixed paths inside the checkout (the
    program's own kernel libraries go to `build/kernels` there)."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton")


class Harness(types.SimpleNamespace):
    """What a driver gets: the cell's files, the run's arguments, and the
    device-specific parts (sync, energy, memory peak)."""

    def sync(self) -> None:
        import torch

        if self.device != "cpu":
            torch.cuda.synchronize()

    def memory_peak(self) -> int:
        import torch

        return torch.cuda.max_memory_allocated() if self.device != "cpu" else 0


def main(argv=None, *, device: str | None = None, root: pathlib.Path = ROOT, energy_meter=None) -> int:
    """`device` and `energy_meter` are for the CPU tests only: they skip
    the look for a card (the command line has no way to do so)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), required=True)
    args = ap.parse_args(argv)

    bench = read_json(root / "BENCHMARK.json")
    files = cell_files(root, bench, args.workload)
    chips = files["cell"]["chips"]
    import torch

    phases = {"import_torch": time.perf_counter()}
    card = None
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"bench: the cell needs {chips} CUDA card(s); this machine has {n}", file=sys.stderr)
            return 3
        device = "cuda"
        from bench import device as cards

        card = cards.Card()
        energy_meter = lambda: cards.EnergyMeter(card)  # noqa: E731
        phases["card"] = time.perf_counter()
    _set_caches(root)
    for p in (str(root / "src"), str(root)):
        if p not in sys.path:
            sys.path.insert(0, p)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    h = Harness(config=files["config"], traffic=files["traffic"], seed=args.seed, seconds=args.seconds,
                trace=bool(args.trace), device=device, energy_meter=energy_meter, started=T_START,
                phases=phases,
                reference=load_module(files["reference"], f"bench_reference_{files['config']['reference']}"))
    driver = load_module(files["driver"], f"bench_driver_{files['traffic']['driver']}")
    out = driver.run(h)
    setup_s = out["window_start"] - T_START

    result_metrics = {}
    if not args.trace:
        values = dict(out["end_to_end"], setup_s=setup_s)
        for m in bench["end_to_end"]:
            if applies(m, args.workload):
                if m["name"] not in values:
                    print(f"bench: the run measured no {m['name']}", file=sys.stderr)
                    return 1
                result_metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        if not out.get("trace", {}).get("busy_s"):
            print("bench: the traced run recorded no device time", file=sys.stderr)
            return 1
        ctx = dict(out.get("layer_inputs", {}), config=files["config"], traffic=files["traffic"])
        units = {m["name"]: m["unit"] for m in bench["per_layer"]}
        for name, path in files["metrics"].items():
            value = load_module(path, f"bench_metric_{name.replace('.', '_')}").read(ctx)
            if value is not None:
                result_metrics[name] = {"value": value, "unit": units[name]}

    dev = {"platform": "gpu" if device != "cpu" else "cpu",
           "kind": torch.cuda.get_device_name(0) if device != "cpu" else "cpu",
           "count": chips, "memory_peak_bytes": out["memory_peak_bytes"]}
    if card is not None:
        dev["power_limit_w"] = card.power_limit_w()
    if args.trace:
        dev["busy_s"], dev["window_s"] = out["trace"]["busy_s"], out["trace"]["window_s"]

    found = forbidden_modules()
    if found:
        print(f"bench: the run loaded {found}: the benchmark measures the PyTorch port alone", file=sys.stderr)
        return 4
    correct, checks = judge(out["readings"], files["limits"])
    result = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"],
              "metrics": result_metrics, "device": dev}
    if args.trace:
        result["breakdown"] = out["trace"]["breakdown"]
    result["checks"] = checks
    keys = ("timesteps", "seconds", "energy_source", "joules", "setup_phases", "check_s")
    info = {k: out[k] for k in keys if k in out}
    print(f"bench: {args.workload} seed {args.seed}: setup_s {setup_s:.3f}, {json.dumps(info)}", file=sys.stderr)
    print(f"bench: every reading (the limited ones follow): {json.dumps(out['readings'])}", file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    sys.exit(main())
