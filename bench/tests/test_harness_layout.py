"""BENCHMARK.json against the benchmark's contract, the lookups by name,
what the harness imports, and its refusal to run without a card."""

from __future__ import annotations

import ast
import contextlib
import io
import json
import os
import re
import shutil
import subprocess
import sys

import pytest
from conftest import ROOT

from bench import run

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "bench/run.py"] and BENCH["paths"] == ["bench"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries_keys_names_and_units(section):
    for entry in BENCH[section]:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") else set()
        assert KEYS[section] <= set(entry) <= KEYS[section] | extra, entry
        assert NAME.match(entry["name"]), entry["name"]
        if "unit" in entry:
            assert UNIT.match(entry["unit"]), entry["unit"]
            assert entry["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in entry:
                assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key] and "\t" not in entry[key]
        for key in ("config", "traffic"):
            if key in entry:
                assert NAME.match(entry[key])
        for key in entry.get("reduced", []):
            assert NAME.match(key)
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))


def test_metric_sources_and_bounds():
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_reporting_a_per_layer_metric_reports_what_it_moves():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for cell in BENCH["workloads"]:
        per_layer = [m for m in BENCH["per_layer"] if run.applies(m, cell["name"])]
        assert per_layer, cell["name"]
        for m in per_layer:
            assert run.applies(e2e[m["moves"]], cell["name"]), (m["name"], cell["name"])
        assert run.applies(e2e["train_ips"], cell["name"])
        assert run.applies(e2e["setup_s"], cell["name"])


def test_cells_configs_and_chips():
    configs = {c["name"] for c in BENCH["configs"]}
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == configs
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert all(w["chips"] == 1 for w in BENCH["workloads"])
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files)) and all(f.startswith("bench/") for f in files)


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_finds_its_files_by_name(workload):
    files = run.cell_files(ROOT, BENCH, workload)
    for key in ("driver", "reference"):
        assert files[key].is_file()
    assert set(files["metrics"]) == {m["name"] for m in BENCH["per_layer"] if run.applies(m, workload)}
    assert all(p.is_file() for p in files["metrics"].values())
    assert files["limits"]["limits"]


TOY_DRIVER = """
import time

import torch


def run(h):
    gen = torch.Generator().manual_seed(h.seed)
    rows = torch.rand((h.config["rows"], h.config["width"]), generator=gen)
    t0 = time.perf_counter()
    done = 0
    while True:
        out = torch.sort(rows, dim=1).values
        done += 1
        if time.perf_counter() - t0 >= h.seconds:
            break
    t1 = time.perf_counter()
    result = {"window_start": t0, "attempted": done, "failed": 0, "memory_peak_bytes": 0,
              "end_to_end": {"sorts_per_s": done / (t1 - t0)},
              "readings": {"wrong": h.reference.wrong(rows, out)}}
    if h.trace:
        result["trace"] = {"busy_s": 0.5, "window_s": 1.0, "breakdown": {"device_ops": [], "idle_gaps": []}}
        result["layer_inputs"] = {"rows_sorted": float(h.config["rows"])}
    return result
"""

TOY_REFERENCE = """
def wrong(rows, out):
    return float(sum(sorted(r.tolist()) != o.tolist() for r, o in zip(rows, out)))
"""


def _toy_benchmark(root) -> dict:
    """BENCHMARK.json and bench/ under `root`, with a cell added that runs no
    DDPG: its own configuration, mix, driver, reference, limits, end-to-end
    metric and per-layer reader, in new files alone."""
    shutil.copytree(ROOT / "bench", root / "bench", ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    new_files = {
        "configs/toy_sort.json": json.dumps({"reference": "toy_sort", "rows": 32, "width": 16}),
        "traffic/toy_mix.json": json.dumps({"driver": "toy_sort"}),
        "drivers/toy_sort.py": TOY_DRIVER,
        "reference/toy_sort.py": TOY_REFERENCE,
        "limits/toy.cell.json": json.dumps({"limits": {"wrong": 0.0}}),
        "metrics/rows_sorted.py": "def read(ctx):\n    return ctx.get(\"rows_sorted\")\n",
    }
    for rel, text in new_files.items():
        assert not (root / "bench" / rel).exists()
        (root / "bench" / rel).write_text(text)
    bench["configs"].append({"name": "toy_sort", "source": "x", "file": "bench/configs/toy_sort.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "toy.cell", "config": "toy_sort", "traffic": "toy_mix", "chips": 1,
                               "why": "x"})
    bench["end_to_end"].append({"name": "sorts_per_s", "unit": "1/s", "better": "higher", "bound": 0.05,
                                "source": "host_clock", "workloads": ["toy.cell"]})
    bench["per_layer"].append({"name": "rows_sorted", "unit": "count", "better": "higher",
                               "source": "program_counter", "layer": "sort", "moves": "sorts_per_s",
                               "workloads": ["toy.cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return bench


def _main(root, trace: int) -> dict:
    from conftest import StubMeter

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = run.main(["--workload", "toy.cell", "--seed", "3000000019", "--seconds", "0.05", "--trace", str(trace)],
                      device="cpu", root=root, energy_meter=StubMeter)
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


def test_new_files_are_found_without_editing_any(tmp_path):
    before = {p.relative_to(ROOT): p.read_bytes() for p in (ROOT / "bench").rglob("*")
              if p.is_file() and "__pycache__" not in p.parts}
    bench = _toy_benchmark(tmp_path)
    files = run.cell_files(tmp_path, bench, "toy.cell")
    assert files["config"]["reference"] == "toy_sort" and files["traffic"]["driver"] == "toy_sort"
    assert set(files["metrics"]) == {"rows_sorted"} and files["limits"]["limits"] == {"wrong": 0.0}
    assert all((tmp_path / rel).read_bytes() == b for rel, b in before.items())


def test_a_cell_that_runs_no_ddpg_runs_traced_and_untraced_from_new_files_alone(tmp_path):
    _toy_benchmark(tmp_path)
    untraced = _main(tmp_path, 0)
    assert untraced["correct"] is True
    assert set(untraced["metrics"]) == {"sorts_per_s", "setup_s"}
    traced = _main(tmp_path, 1)
    assert traced["correct"] is True and traced["metrics"] == {"rows_sorted": {"value": 32.0, "unit": "count"}}
    assert traced["device"]["busy_s"] == 0.5


def _imports(path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted((ROOT / "bench").rglob("*.py")), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not _imports(path) & {"jax", "jaxlib", "flax", "repro"}


def test_the_reference_imports_nothing_of_the_program():
    for path in (ROOT / "bench" / "reference").glob("*.py"):
        assert not _imports(path) & {"repro_torch", "repro", "jax", "bench"}, path
        assert "repro_torch" not in path.read_text().replace("program", "")


def test_no_reading_of_the_old_benchmarks_folder():
    for path in (ROOT / "bench").rglob("*.py"):
        if path.parent.name == "tests":
            continue
        assert "benchmarks/" not in path.read_text() and "BENCH_" not in path.read_text(), path


def test_forbidden_names_compare_the_top_level_name_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_lookalike", sys)
    assert "repro" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.rl", sys)
    assert "repro" in run.forbidden_modules()


def test_without_a_card_the_command_fails_and_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    cell = BENCH["workloads"][0]["name"]
    out = subprocess.run([sys.executable, "bench/run.py", "--workload", cell, "--seed", "3000000019", "--seconds",
                          "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_without_the_program_the_command_fails_and_prints_no_result(tmp_path):
    shutil.copytree(ROOT / "bench", tmp_path / "bench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    code = ("import sys; sys.path.insert(0, '.'); from bench import run; "
            f"sys.exit(run.main(['--workload', {BENCH['workloads'][0]['name']!r}, '--seed', '5', '--seconds', '1', "
            "'--trace', '0'], device='cpu'))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True, text=True, timeout=120,
                         env=env)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "repro_torch" in out.stderr
