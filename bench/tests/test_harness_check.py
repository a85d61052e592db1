"""The comparison that decides `correct`, on the CPU at a cut size: the
plain reference follows the port's CPU path within every limit; the
control (the reference one precision step lower, in the program's place)
comes out not correct; and a whole run with the timed path broken
underneath comes out not correct, once for each fault a training cell can
have.  Also the trace reduction and the per-layer readers on made-up
traces."""

from __future__ import annotations

import contextlib
import io
import json

import pytest
from conftest import ROOT, StubMeter

from bench import run, trace, yardstick

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
SEED = 3_000_000_019


def _cell(root, workload):
    files = run.cell_files(root, BENCH, workload)
    ref = run.load_module(files["reference"], "test_reference")
    drv = run.load_module(files["driver"], "test_driver")
    return files, ref, drv


def _snaps(root, workload, seed=SEED):
    files, ref, drv = _cell(root, workload)
    cell = drv.Cell(files["config"], files["traffic"], seed, "cpu")
    cell.prepare(ref)
    return files, ref, drv, cell.checked_steps(files["traffic"]["checked_steps"])


@pytest.mark.parametrize("workload", CELLS)
def test_reference_follows_the_port_within_the_limits(cut_root, workload):
    files, ref, drv, snaps = _snaps(cut_root, workload)
    readings = drv.check(ref, files["config"], files["traffic"], SEED, snaps, "cpu")
    ok, checks = run.judge(readings, files["limits"])
    assert ok, checks
    assert readings["start"] == 0.0  # the program starts where the seed says, bit for bit


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_is_not_correct(cut_root, workload):
    files, ref, drv, snaps = _snaps(cut_root, workload)
    control = drv.stand_in(ref, files["config"], files["traffic"], SEED, snaps, "cpu", lower=True)
    ok, checks = run.judge(drv.check(ref, files["config"], files["traffic"], SEED, control, "cpu"), files["limits"])
    assert not ok, checks


def test_a_start_from_another_seed_is_refused(cut_root):
    files, ref, drv, snaps = _snaps(cut_root, CELLS[0])
    readings = drv.check(ref, files["config"], files["traffic"], SEED + 1, snaps, "cpu")
    assert readings["start"] > 0 and not run.judge(readings, files["limits"])[0]


def _broken_update(kind):
    from repro_torch.rl import ddpg

    real = ddpg.update

    def update(state, batch, cfg):
        if kind == "unchanged":
            return state, {}
        half = {k: v[: v.shape[0] // 2] for k, v in batch.items()}
        return real(state, half, cfg)

    return update


def _altered_step_fleet():
    from repro_torch.rl import loop

    real = loop.step_fleet

    def step_fleet(*args, **kwargs):
        state, obs, reward, done = real(*args, **kwargs)
        return state, obs, reward + 0.01 * (torch_arange_like(reward) == 0), done

    return step_fleet


def torch_arange_like(x):
    import torch

    return torch.arange(x.shape[0], device=x.device)


def _run(root, workload):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = run.main(["--workload", workload, "--seed", str(SEED), "--seconds", "0.2", "--trace", "0"],
                      device="cpu", root=root, energy_meter=StubMeter)
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("workload", [CELLS[0], CELLS[1]])
def test_a_sound_run_is_correct(cut_root, workload):
    result = _run(cut_root, workload)
    assert result["correct"] is True
    assert list(result)[-1] == "checks"
    assert set(result["metrics"]) == {"train_ips", "train_samples_per_j", "setup_s"}


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered_reward"])
@pytest.mark.parametrize("workload", [CELLS[0], CELLS[1]])
def test_a_run_with_the_timed_path_broken_is_not_correct(cut_root, monkeypatch, workload, fault):
    from repro_torch.rl import ddpg, loop

    if fault == "altered_reward":
        monkeypatch.setattr(loop, "step_fleet", _altered_step_fleet())
    else:
        monkeypatch.setattr(ddpg, "update", _broken_update(fault))
    result = _run(cut_root, workload)
    assert result["correct"] is False, result["checks"]


# ------------------------------------------------------------ traces and readers
def _events():
    """A made-up window of two timesteps: 1.0 s to 2.0 s, four kernels."""
    ev = [{"name": trace.WINDOW, "kind": "user_annotation", "device": False, "start": 1.0, "end": 2.0, "corr": 1}]
    ev += [{"name": "cudaGraphLaunch", "kind": "cuda_runtime", "device": False, "start": 1.05, "end": 1.06, "corr": 7},
           {"name": "cudaGraphLaunch", "kind": "cuda_runtime", "device": False, "start": 1.5, "end": 1.51, "corr": 8}]
    kernels = [("void (anonymous namespace)::fxp_mlp_fwd_kernel<8>(float const*)", 1.1, 1.2, 7),
               ("void ddpg_critic_kernel<16>(StepArgs)", 1.2, 1.4, 7),
               ("void at::native::elementwise_kernel<128, 2>(int)", 1.55, 1.65, 8),
               ("reduce_update_kernel(UpdateArgs, float const*, int, int)", 1.7, 1.8, 8)]
    ev += [{"name": n, "kind": "kernel", "device": True, "start": s, "end": e, "corr": c} for n, s, e, c in kernels]
    return ev


def test_kernel_names_are_read_without_templates_and_arguments():
    assert trace.ident("void ddpg_critic_kernel<8>(StepArgs, WeightMaps)") == "ddpg_critic_kernel"
    assert trace.ident("void at::native::vectorized_elementwise_kernel<4, X>(int)") == "vectorized_elementwise_kernel"
    assert trace.ident("Memcpy DtoH (Device -> Pageable)") == "Memcpy DtoH"
    assert trace.ident("void (anonymous namespace)::ddpg_actor_kernel<8>(StepArgs)") == "ddpg_actor_kernel"


def test_trace_reduction():
    red = trace.reduce(_events())
    assert red["window_s"] == pytest.approx(1.0)
    assert red["busy_s"] == pytest.approx(0.5)
    assert red["kernel_count"]["ddpg_critic_kernel"] == 1
    idle = dict(red["breakdown"]["idle_gaps"])
    assert sum(idle.values()) == pytest.approx(0.5)
    assert idle["inside one launch (graph nodes)"] == pytest.approx(0.05)  # 1.65 .. 1.7, one launch
    assert len(red["breakdown"]["device_ops"]) == 4


def test_per_layer_readers():
    red = trace.reduce(_events())
    config = json.loads((ROOT / "bench" / "configs" / "fixar_halfcheetah.json").read_text())
    traffic = json.loads((ROOT / "bench" / "traffic" / "b128.quant.json").read_text())
    counts = yardstick.timestep(config, traffic)
    ctx = {"trace": dict(red, timesteps=2, replays=2), "counts": counts, "timesteps_per_s": 1000.0,
           "peaks": yardstick.PEAKS, "config": config, "traffic": traffic}
    read = {m["name"]: run.load_module(ROOT / "bench" / "metrics" / f"{m['name']}.py", m["name"]).read(ctx)
            for m in BENCH["per_layer"]}
    assert read["timestep_kernels"] == 2.0
    assert read["plain_ops_ms"] == pytest.approx(0.1 / 2 * 1e3)
    assert read["update_roofline"] == pytest.approx(counts["update_bound_s"] / 0.15 * 100)
    assert read["act_roofline"] == pytest.approx(counts["act_bound_s"] / 0.05 * 100)
    assert read["train_mfu"] == pytest.approx(counts["timestep_ops"] * 1000.0 / 67e12 * 100)
    empty = dict(ctx, trace=dict(ctx["trace"], ops=[], kernel_s={}, busy_s=0.0))
    for name in ("timestep_kernels", "plain_ops_ms", "update_roofline", "act_roofline"):
        mod = run.load_module(ROOT / "bench" / "metrics" / f"{name}.py", name)
        assert mod.read(empty) is None, name
    for m in BENCH["per_layer"]:  # a cell whose driver gives no trace and no counts: nothing to read
        mod = run.load_module(ROOT / "bench" / "metrics" / f"{m['name']}.py", m["name"])
        assert mod.read({"config": {}, "traffic": {}}) is None, m["name"]


@pytest.mark.cuda
def test_a_cell_runs_on_the_card(card):
    result = _run_on_card(CELLS[0])
    assert result["correct"] is True


def _run_on_card(workload):
    import subprocess
    import sys

    out = subprocess.run([sys.executable, "bench/run.py", "--workload", workload, "--seed", str(SEED),
                          "--seconds", "2", "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])
