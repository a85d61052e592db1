"""Sharded checkpoints and the sharded train CLI on CPU ranks.

One spawn of 8 gloo ranks trains the demo smoke config two steps on the
debug mesh (data 2 × model 4), saves the sharded state (every rank takes
part in the gathers, rank 0 writes: synchronously and through
`AsyncCheckpointer`) and restores it onto meshes of 8, 4, 2 and 1 ranks
(`ckpt.restore(shardings=)`, the reference's elastic restore): bitwise the
gathered state, laid out by each mesh's rules.

Meanwhile the train CLI under `torch.distributed.run --nproc-per-node 8` on
the CPU (`--mesh debug`) trains 3 steps, whose logged losses match a one-rank
run's within 1e-4 relative (the smoke config computes in bfloat16; the
sharded contractions sum in another order).
"""

import json
import os
import pathlib
import subprocess
import sys

import pytest

pytest.importorskip("torch")

import _torch_dist as D

REPO = pathlib.Path(__file__).resolve().parents[1]
CLI = ["-m", "repro_torch.launch.train", "--arch", "demo_100m", "--smoke", "--device", "cpu", "--steps", "3",
       "--batch", "8", "--seq", "64", "--qat", "--qat-delay", "2", "--log-every", "1"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The elastic case on 8 spawned ranks, and meanwhile the sharded CLI
    under `torch.distributed.run` (its stdout, or its failure)."""
    work = tmp_path_factory.mktemp("dist_ckpt")
    run = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "8"]
    cli = subprocess.Popen(run + CLI + ["--mesh", "debug"], env=_env(), stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True, cwd=work)
    try:
        elastic = D.run_ranks(8, work / "ranks", [("elastic", "_torch_dist_cases:ckpt_elastic",
                                                   {"directory": str(work / "ckpt")})])
    finally:
        try:
            out, err = cli.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            cli.kill()
            out, err = cli.communicate()
    return elastic, (cli.returncode, out, err)


@pytest.mark.parametrize("n", [8, 4, 2, 1])
def test_sharded_checkpoint_restores_onto_n_ranks(runs, n):
    r = D.result(runs[0], "elastic")
    assert r["written"] == ["async", "step_00000002"]
    got = r[n]
    assert got["step"] == 2 and got["extra"] == {"arch": "demo-smoke"}
    assert got["bitwise"] and got["async_bitwise"]
    if n > 1:
        assert any("Shard" in p for p in got["placements"]), got["placements"]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (str(REPO / "src"), env.get("PYTHONPATH")) if p)
    env["OMP_NUM_THREADS"] = "1"
    return env


def _losses(stdout: str) -> list:
    return [json.loads(line)["loss"] for line in stdout.splitlines() if line.startswith("{")]


def test_cli_trains_on_eight_cpu_ranks_like_one(runs):
    rc, stdout, stderr = runs[1]
    assert rc == 0, stderr[-3000:]
    from repro_torch.launch.train import main

    _, records = main(CLI[2:])  # one rank, in this process
    got, want = _losses(stdout), [r["loss"] for r in records]
    assert len(got) == len(want) == 3, stdout  # rank 0 logs, once
    assert all(abs(g - w) <= 1e-4 * abs(w) for g, w in zip(got, want)), (got, want)
