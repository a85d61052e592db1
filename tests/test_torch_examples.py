"""The port's examples (`examples/torch/`, one per reference script in
`examples/`), each `main(device="cpu", <cut sizes>)` run here and held to
what its script promises.  The sizes are cut (steps, clients, requests):
widths and models are the scripts' own.  Every output goes under
`tmp_path`.  On the card `chip_smoke.py`'s `examples` phase runs them at
the reference's sizes or lengths cut, with the kernels' launch counts.
"""

import importlib
import json
import math
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401  (one intra-op thread a worker)

REPO = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = REPO / "examples" / "torch"
NAMES = ("quickstart", "serve_policy", "serve_batched", "serve_lm", "train_lm_qat", "train_learner",
         "observe_serve", "observe_fleet", "elastic_restart")


def _example(name: str):
    """The example module, imported by its name with `examples/torch` on
    the path (observe_fleet's spawned hosts import it so)."""
    if str(EXAMPLES) not in sys.path:
        sys.path.insert(0, str(EXAMPLES))
    return importlib.import_module(name)


def test_every_reference_example_has_a_port():
    assert sorted(p.stem for p in (REPO / "examples").glob("*.py")) == sorted(NAMES)
    assert sorted(p.stem for p in EXAMPLES.glob("*.py")) == sorted(NAMES)


@pytest.mark.parametrize("name", NAMES)
def test_main_needs_a_card_or_a_device(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _example(name).main()


def test_quickstart_switches_phase_at_its_delay():
    """10 env steps, updates from step 4 (6 of them), the delay at 40 % of
    the steps (4 updates): monitor phase at the first evaluation (one
    update), the 16-bit phase at the second; the six sites' captured ranges
    finite and ordered."""
    r = _example("quickstart").main("cpu", total_steps=10, warmup_steps=5, eval_every=5, chunk=5,
                                    eval_episodes=1, batch_size=8, replay_capacity=64)
    assert r["qat_delay"] == 4 and r["updates"] == 6
    assert r["at_eval"] == [(1, False), (6, True)]
    assert r["history"]["step"] == [5, 10]
    assert len(r["ranges"]) == 6
    for lo, hi in r["ranges"].values():
        assert math.isfinite(lo) and math.isfinite(hi) and lo <= hi


def test_serve_policy_replies_match_the_plain_act():
    from repro_torch.rl import ddpg

    r = _example("serve_policy").main("cpu", n_clients=4, per_client=5, pool=64)
    s, engine = r["stats"], r["engine"]
    assert s["requests"] == 20
    assert sum(sum(m.values()) for m in s["mode_histogram"].values()) == s["batches"]
    want = ddpg.act_batch(engine.actor, torch.from_numpy(r["obs"]), engine.frozen).numpy()
    np.testing.assert_allclose(r["actions"], want, rtol=1e-5, atol=1e-6)


def test_serve_batched_generates_every_token():
    r = _example("serve_batched").main("cpu", max_new=4, steps=3)
    assert r["tokens"].shape == (8, 16)
    assert torch.equal(r["tokens"][:, :12], r["prompts"].to(torch.int32))
    assert r["serve_step_ms"] > 0 and torch.isfinite(r["logits"]).all()


def test_serve_lm_serves_every_client_and_traces(tmp_path):
    r = _example("serve_lm").main("cpu", max_new=4, out_dir=tmp_path)
    assert r["stats"]["requests"] == 8
    for prompt, seq in zip(r["prompts"], r["results"]):
        assert seq.shape == (len(prompt) + 4,)
        np.testing.assert_array_equal(seq[:len(prompt)], prompt)
    assert r["trace"] == tmp_path / "serve_lm_trace.jsonl"
    names = {json.loads(line).get("name") for line in r["trace"].read_text().splitlines() if line.strip()}
    for span in ("serve_lm.admit", "serve_lm.launch", "serve_lm.block_until_ready", "serve_lm.reply",
                 "serve_lm.request"):
        assert span in names, (span, sorted(n for n in names if n))
    # the queue's depth and wait are registry series, not spans: the two
    # warmup batches' 8 + 4 requests and the clients' 8
    assert r["registry"]["counters"]["serve_lm.batcher.submitted"] == 20
    assert r["registry"]["histograms"]["serve_lm.batcher.queue_wait_s"]["count"] == 20


def test_train_lm_qat_flips_phase_and_checkpoints(tmp_path):
    state, records, ckdir = _example("train_lm_qat").main("cpu", smoke=True, steps=6, batch=2, seq=32,
                                                          qat_delay=3, ckpt_every=3, log_every=3,
                                                          out_dir=tmp_path)
    assert [(r["step"], r["quant_phase"]) for r in records] == [(3, 0), (6, 1)]
    assert all(math.isfinite(r["loss"]) for r in records)
    assert ckdir == tmp_path / "fixar_lm_ckpt"
    assert sorted(p.name for p in ckdir.iterdir()) == ["step_00000003", "step_00000006"]
    assert int(state.step) == 6


def test_train_learner_streams_every_request():
    r = _example("train_learner").main("cpu", producers=2, per_producer=2, trajectory=150)
    s = r["stats"]
    assert s["requests"] == 6  # the producers' four and the trajectory's two chunks
    assert r["trajectory"]["chunks"] == 2
    assert r["step"] == s["updates"] == sum(sum(m.values()) for m in s["mode_histogram"].values())
    assert s["updates"] >= 3  # four requests, coalesced to one at the most, and two chunks


def test_observe_serve_reads_every_layer(tmp_path):
    r = _example("observe_serve").main("cpu", n_clients=4, per_client=5, out_dir=tmp_path)
    st = r["stats"]
    assert st["requests"] == 20
    assert st["dispatch_audit"]["batches"] == st["batches"] > 0
    assert any(t.get("probes") for t in st["qat_telemetry"].values())
    assert r["registry"]["counters"]["serve.requests"] == 20
    assert pathlib.Path(r["trace"]).read_text().strip()
    snap = json.loads(r["snapshot"].read_text())
    assert snap["stats"]["requests"] == 20


def test_observe_fleet_flags_the_rogue_host(tmp_path):
    r = _example("observe_fleet").main("cpu", out_dir=tmp_path)
    assert any(a["rule"] == "dispatch-calibration-stale" for a in r["alerts"])
    assert r["healthz"] == {"actor-0": 200, "actor-1": 200, "rogue": 503}
    assert r["requests"] > 0
    assert r["alive"] == {"actor-0": False, "actor-1": False, "rogue": False}
    assert r["prometheus"].read_text().strip() and json.loads(r["snapshot"].read_text())


def test_elastic_restart_resumes_bitwise(tmp_path):
    """The restored state is the saved one bitwise, the resumed data cursor
    starts at the saved step, and the continuation is bitwise an
    uninterrupted run of the same steps."""
    from repro_torch import tree
    from repro_torch.configs import registry
    from repro_torch.data.synthetic import DataConfig, DataIterator
    from repro_torch.models.config import ShapeConfig
    from repro_torch.optim import adam
    from repro_torch.train.step import init_state, make_train_step

    r = _example("elastic_restart").main("cpu", steps=3, resumed_steps=2, out_dir=tmp_path)
    assert r["restored_bitwise"] and r["restored_step"] == 3
    assert r["data_steps"] == [3, 4]
    assert (r["plan"].data, r["plan"].model, r["plan"].n_devices, r["plan"].grad_accum_factor) == (8, 16, 128, 2)
    assert pathlib.Path(r["checkpoint"]).parent == tmp_path

    cfg = registry.get_smoke("demo_100m")
    step = make_train_step(cfg, adam.AdamConfig(lr=1e-3, grad_clip_norm=1.0))
    state = init_state(torch.Generator().manual_seed(0), cfg, device="cpu")
    data = DataIterator(DataConfig(seed=0), cfg, ShapeConfig("t", "train", 64, 8), device="cpu")
    losses = []
    for _ in range(5):
        state, m = step(state, next(data))
        losses.append(float(m["loss"]))
    assert losses == r["losses"] + r["resumed_losses"]
    assert all(torch.equal(a, b) for a, b in zip(tree.leaves(state), tree.leaves(r["final"]), strict=True))
