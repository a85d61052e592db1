"""Shared set-up of the benchmark's CPU tests: the repository root and the
port's sources on `sys.path`, and a copy of the benchmark cut to a size
the CPU runs in seconds (the same cells, files and limits; smaller batch,
window, ring and QAT delay)."""

from __future__ import annotations

import json
import pathlib
import shutil
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

CUT_TRAFFIC = {"batch_size": 16, "window_timesteps": 4}
CUT_FLEET = 48
CUT_RING = 256
CUT_QUANT_DELAY = 3


def cut_copy(dest: pathlib.Path) -> pathlib.Path:
    """BENCHMARK.json and bench/ under `dest`, with every traffic mix and
    configuration cut to a CPU size."""
    shutil.copytree(ROOT / "bench", dest / "bench", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", dest)
    for p in (dest / "bench" / "traffic").glob("*.json"):
        t = json.loads(p.read_text())
        t.update(CUT_TRAFFIC, n_envs=min(t["n_envs"], CUT_FLEET))
        if t["phase"] == "quant":
            t["qat_delay"] = CUT_QUANT_DELAY
        p.write_text(json.dumps(t))
    for p in (dest / "bench" / "configs").glob("*.json"):
        c = json.loads(p.read_text())
        c["replay_capacity"] = CUT_RING
        p.write_text(json.dumps(c))
    return dest


class StubMeter:
    """Stands in for the card's energy meter on the CPU."""

    source = "stub"

    def start(self) -> None:
        pass

    def stop(self) -> float:
        return 1.0


@pytest.fixture
def cut_root(tmp_path):
    import torch

    torch.set_num_threads(2)
    return cut_copy(tmp_path)


@pytest.fixture
def card():
    """Skips a test unless a CUDA card is present (decided here, not at
    import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
