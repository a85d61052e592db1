"""The LM cell's comparison on the CPU at its cut size, beyond what
`test_harness_check.py` asks of every cell: each fault the reference can
plant in the program's place comes out not correct, and so does a whole
run whose timed path is broken underneath (the routing bias left where it
was, the gates without their scaling, a QAT site whose range never
folds)."""

from __future__ import annotations

import contextlib
import io
import json

import pytest
from conftest import ROOT, StubMeter

from bench import run

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELL = "lm_train.moonlight.s8k.quant"
SEED = 3_000_000_019


def _files(root):
    files = run.cell_files(root, BENCH, CELL)
    return files, run.load_module(files["reference"], "lm_reference"), run.load_module(files["driver"], "lm_driver")


def test_each_planted_fault_is_not_correct(cut_root):
    files, ref, drv = _files(cut_root)
    cell = drv.Cell(files["config"], files["traffic"], SEED, "cpu")
    cell.prepare()
    snaps = cell.checked_steps()
    for fault in ref.FAULTS:
        planted = drv.stand_in(ref, files["config"], files["traffic"], SEED, snaps, "cpu", fault=fault)
        ok, checks = run.judge(drv.check(ref, files["config"], files["traffic"], SEED, planted, "cpu"),
                               files["limits"])
        assert not ok, (fault, checks)


def _frozen_bias():
    from repro_torch.train import step

    real = step._balance

    def balance(cfg, bias, moe):
        _, counters = real(cfg, bias, moe)
        return bias, counters

    return step, "_balance", balance


def _unscaled_gates():
    from repro_torch.models import moe

    real = moe.route_sigmoid

    def route(flat, router, bias, cfg):
        r = real(flat, router, bias, cfg)
        return dict(r, gates=r["gates"] / cfg.routed_scaling)

    return moe, "route_sigmoid", route


def _unfolded_site():
    from repro_torch.models import layers

    real = layers.LayerQAT._site

    def site(self, name, x, valid=None):
        stat = self.stats[name]
        out = real(self, name, x, valid)
        if name == "expert_down_in":  # its range never folded: frozen at the never-updated guard
            self.stats[name] = stat
        return out

    return layers.LayerQAT, "_site", site


@pytest.mark.parametrize("broken", [_frozen_bias, _unscaled_gates, _unfolded_site])
def test_a_run_with_the_timed_path_broken_is_not_correct(cut_root, monkeypatch, broken):
    monkeypatch.setattr(*broken())
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = run.main(["--workload", CELL, "--seed", str(SEED), "--seconds", "0.2", "--trace", "0"], device="cpu",
                      root=cut_root, energy_meter=StubMeter)
    assert rc == 0
    result = json.loads(out.getvalue().strip().splitlines()[-1])
    assert result["correct"] is False, result["checks"]


def test_a_sound_run_is_correct_and_reports_the_cells_metrics(cut_root):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = run.main(["--workload", CELL, "--seed", str(SEED), "--seconds", "0.2", "--trace", "0"], device="cpu",
                      root=cut_root, energy_meter=StubMeter)
    assert rc == 0
    result = json.loads(out.getvalue().strip().splitlines()[-1])
    assert result["correct"] is True, result["checks"]
    assert set(result["metrics"]) == {"train_ips", "train_samples_per_j", "setup_s"}


# ------------------------------------------------------------ spans and readers
def _events():
    """A made-up window, 1.0 s to 2.0 s, its events without activity kinds
    as the card's profiler gives them: an attention span around one
    kernel, a QAT span nested in an experts span (each span with its
    device-side copy), a kernel outside every span, and a kernel whose
    launch lies outside the window."""
    from bench import trace

    host = [(trace.WINDOW, 1.0, 2.0, 1), ("lm.mla.attend", 1.1, 1.3, 2), ("lm.moe.experts", 1.4, 1.8, 3),
            ("lm.qat.site", 1.5, 1.6, 4)]
    launches = [(1.15, 10), (1.45, 11), (1.55, 12), (1.85, 13), (0.5, 14)]
    kernels = [("attn_kernel", 1.2, 1.25, 10), ("gemm_kernel", 1.5, 1.6, 11), ("quant_kernel", 1.6, 1.62, 12),
               ("add_kernel", 1.9, 1.95, 13), ("early_kernel", 1.01, 1.02, 14)]
    ev = [{"name": n, "kind": "", "device": dev, "start": s, "end": e, "corr": c}
          for n, s, e, c in host for dev in (False, True)]
    ev += [{"name": "cudaLaunchKernel", "kind": "", "device": False, "start": s, "end": s + 0.001, "corr": c}
           for s, c in launches]
    ev += [{"name": "aten::mm", "kind": "", "device": False, "start": 1.44, "end": 1.46, "corr": 0},
           {"name": "cudaStreamSynchronize", "kind": "", "device": False, "start": 1.7, "end": 1.8, "corr": 20}]
    ev += [{"name": n, "kind": "", "device": True, "start": s, "end": e, "corr": c} for n, s, e, c in kernels]
    return ev


def test_kernels_go_to_the_innermost_span_around_their_launch():
    _, _, drv = _files(ROOT)
    spans = drv.span_device_s(_events())
    assert spans == pytest.approx({"lm.mla.attend": 0.05, "lm.moe.experts": 0.1, "lm.qat.site": 0.02})


def test_reduce_reads_the_window_from_the_pruned_events():
    from bench import trace

    _, _, drv = _files(ROOT)
    kept = drv.for_reduce(_events())
    assert {e["name"] for e in kept if not e["device"]} == {trace.WINDOW, "lm.mla.attend", "lm.moe.experts",
                                                             "lm.qat.site", "cudaStreamSynchronize"}
    assert {e["name"] for e in kept if e["device"]} == {"attn_kernel", "gemm_kernel", "quant_kernel", "add_kernel",
                                                         "early_kernel"}  # the spans' device copies left out
    red = trace.reduce(kept)
    assert red["window_s"] == pytest.approx(1.0)
    assert red["busy_s"] == pytest.approx(0.05 + 0.1 + 0.02 + 0.05 + 0.01)
    assert red["kernel_count"] == {"attn_kernel": 1, "gemm_kernel": 1, "quant_kernel": 1, "add_kernel": 1,
                                   "early_kernel": 1}


def test_the_cells_readers():
    from bench import lm_counts

    files, _, drv = _files(ROOT)
    counts = lm_counts.step_counts(files["config"], files["traffic"], 147_456)
    spans = drv.span_device_s(_events())
    ctx = {"lm_span_s": spans, "lm_counts": counts, "lm_steps_per_s": 2.0, "config": files["config"],
           "traffic": files["traffic"]}
    read = {name: run.load_module(path, name).read(ctx) for name, path in files["metrics"].items()}
    assert read.pop("moe_dispatch_ms") is None  # no routing or dispatch span in the window
    assert read == pytest.approx({"lm_train_mfu": counts["step_ops"] * 2.0 / 989.4e12 * 100,
                                  "mla_attn_roofline": counts["attn_bound_s"] / 0.05 * 100,
                                  "moe_experts_roofline": counts["experts_bound_s"] / 0.1 * 100,
                                  "lm_qat_sites_ms": 0.02 * 1e3})
