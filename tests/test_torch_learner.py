"""The port's learner engine, `repro_torch.train.learner`, on the CPU.

1. The reference's learner tests (`tests/train/test_learner.py` and the
   learner cases of `tests/runtime/test_engine_runtime.py`) on the port: a
   bucket-sized stream is bitwise a direct `ddpg.update` per mode and
   bucket; a short request pads with zero-weight rows, bitwise a direct
   call on the engine's padded batch and, within the update contracts, the
   unpadded call; an oversized one chunks to the top bucket in order;
   `warmup` leaves the state bitwise as it was (a kernel or plain version
   that wrote into its inputs would show there); threaded streaming
   applies every request; `force_mode` and `pad_policy` validation; the
   generic update family.  Narrow nets (actor 5-32-24-2, critic 7-32-24-1)
   and the kernels' plain versions (CPU tensors).
2. The port's learner against the reference's `LearnerEngine` on the same
   request stream (rows 5, 8, 27 and 300 at the default buckets 8, 32, 128:
   pads, an exact fit, and three chunks), modes "jnp" and "fused" (the
   reference's "pallas" backend in interpret mode).  Before each request
   the port's engine loads the reference's state, so every comparison is
   one request's updates from one state.  Contracts,
   `tests/test_torch_ddpg_train.py`'s: losses rtol 1e-4 / atol 1e-5, the
   four nets rtol 1e-4 / atol 2e-5, mu 2e-6, nu 1e-7 (rtol 1e-4), range
   monitors rtol 1e-5 / atol 1e-6, counts and steps exactly.  `stats()`
   has the reference's keys.
"""

import contextlib
import dataclasses
import threading
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401  (one intra-op thread a worker)

from repro_torch import tree
from repro_torch.rl import ddpg as pddpg
from repro_torch.runtime.engine import BatcherConfig
from repro_torch.serve.policy.dispatch import TRAIN_MODES
from repro_torch.train.learner import TRAIN_BACKENDS, LearnerEngine, UpdateBatcher
from repro_torch.train.learner.batcher import TRANSITION_KEYS
from repro_torch.train.learner.engine import DEFAULT_BUCKETS

OBS, ACT, HIDDEN = 5, 2, (32, 24)
SPEC = types.SimpleNamespace(obs_dim=OBS, act_dim=ACT)
BUCKETS = (8, 16, 32)
Q = 2.0**-16
STREAM = (5, 8, 27, 300)


@contextlib.contextmanager
def _narrow(*modules):
    """`HIDDEN` of each ddpg module narrowed while a state is made."""
    with pytest.MonkeyPatch.context() as mp:
        for m in modules:
            mp.setattr(m, "HIDDEN", HIDDEN)
        yield


def narrow_port_state(qat: bool = True, delay: int = 2, seed: int = 0):
    """(cfg, state): a port `DDPGState` with narrow nets on the CPU."""
    cfg = pddpg.DDPGConfig(batch_size=8, qat_enabled=qat, qat_delay=delay)
    with _narrow(pddpg):
        state = pddpg.init(SPEC, cfg, generator=torch.Generator().manual_seed(seed), device="cpu")
    return cfg, state


def narrow_reference_state(qat: bool = True, delay: int = 2, seed: int = 0):
    """(reference cfg, port cfg, reference `DDPGState`) with narrow nets."""
    import jax

    from repro.rl import ddpg as rddpg

    kw = dict(batch_size=8, qat_enabled=qat, qat_delay=delay)
    with _narrow(rddpg):
        state = rddpg.init(jax.random.key(seed), SPEC, rddpg.DDPGConfig(**kw))
    return rddpg.DDPGConfig(**kw), pddpg.DDPGConfig(**kw), state


def requests(rows, seed: int = 0) -> list:
    """Host update requests of the given row counts, from one seed."""
    r = np.random.default_rng(seed)
    return [{
        "obs": r.normal(size=(n, OBS)).astype(np.float32),
        "action": r.uniform(-1, 1, size=(n, ACT)).astype(np.float32),
        "reward": r.normal(size=(n,)).astype(np.float32),
        "next_obs": r.normal(size=(n, OBS)).astype(np.float32),
        "done": r.uniform(size=(n,)) < 0.2,
    } for n in rows]


def _tensors(batch: dict) -> dict:
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _direct(state, batch: dict, cfg, mode: str):
    return pddpg.update(state, _tensors(batch), dataclasses.replace(cfg, backend=TRAIN_BACKENDS[mode]))


def _assert_bitwise(got, want, what=""):
    g, w = tree.flatten_with_path(got), tree.flatten_with_path(want)
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        assert a.dtype == b.dtype and torch.equal(a, b), f"{what}{path}"


def _clone(state):
    return tree.tree_map(torch.clone, state)


@pytest.fixture(scope="module")
def port_state():
    return narrow_port_state()


# --------------------------------------------------------------------- #
# 1. the engine on the port (tests/train/test_learner.py's cases)
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("mode", TRAIN_MODES)
@pytest.mark.parametrize("bucket", BUCKETS)
def test_streamed_update_bitmatches_direct(port_state, mode, bucket):
    cfg, state = port_state
    eng = LearnerEngine.from_ddpg(state, cfg, force_mode=mode, batcher=BatcherConfig(buckets=BUCKETS))
    (batch,) = requests((bucket,), seed=bucket)
    got = eng.run_update(batch)
    want, want_metrics = _direct(state, batch, cfg, mode)
    _assert_bitwise(eng.state, want, f"{mode}/b{bucket}")
    for k, v in want_metrics.items():
        assert got[k] == float(v), k
    assert got["mode"] == mode
    assert int(eng.state.step) == int(state.step) + 1


def _assert_update_close(got, want):
    """One padded update against the unpadded direct call: params within
    one Q15.16 quantum, targets 1e-6, moments and ranges as the update
    contracts, counts exactly."""
    for name in ("actor", "critic"):
        for a, b in zip(tree.leaves(getattr(got, name)), tree.leaves(getattr(want, name))):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=Q, err_msg=name)
    for name in ("actor_target", "critic_target"):
        for a, b in zip(tree.leaves(getattr(got, name)), tree.leaves(getattr(want, name))):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-6, err_msg=name)
    for name in ("actor_opt", "critic_opt"):
        g, w = getattr(got, name), getattr(want, name)
        assert int(g.step) == int(w.step)
        for a, b in zip(tree.leaves(g.mu), tree.leaves(w.mu)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=2e-6, err_msg=f"{name}.mu")
        for a, b in zip(tree.leaves(g.nu), tree.leaves(w.nu)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-7, err_msg=f"{name}.nu")
    for site, r in want.qat.ranges.items():
        assert int(got.qat.ranges[site].count) == int(r.count)
        np.testing.assert_allclose(got.qat.ranges[site].a_min.numpy(), r.a_min.numpy(), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got.qat.ranges[site].a_max.numpy(), r.a_max.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("mode", TRAIN_MODES)
def test_padded_update_bitmatches_direct_masked_call(port_state, mode):
    cfg, state = port_state
    eng = LearnerEngine.from_ddpg(state, cfg, force_mode=mode, batcher=BatcherConfig(buckets=BUCKETS))
    (batch,) = requests((5,), seed=3)
    eng.run_update(batch)
    padded = eng._pad(batch, 5, 8)
    assert padded["mask"].tolist() == [1.0] * 5 + [0.0] * 3
    assert all(not v[5:].any() for k, v in padded.items() if k != "mask")
    want, _ = _direct(state, padded, cfg, mode)
    _assert_bitwise(eng.state, want)
    unpadded, _ = _direct(state, batch, cfg, mode)
    _assert_update_close(eng.state, unpadded)


@pytest.mark.parametrize("mode", TRAIN_MODES)
def test_oversized_request_chunks_sequentially(port_state, mode):
    cfg, state = port_state
    eng = LearnerEngine.from_ddpg(state, cfg, force_mode=mode, batcher=BatcherConfig(buckets=BUCKETS))
    (traj,) = requests((70,), seed=7)
    metrics = eng.run_update(traj)
    assert metrics["chunks"] == 3 and metrics["mode"] == mode  # 32 + 32 + 6
    want = state
    for lo in (0, 32, 64):
        n = min(70 - lo, 32)
        part = {k: v[lo : lo + n] for k, v in traj.items()}
        want, _ = _direct(want, eng._pad(part, n, eng.batcher_config.bucket_for(n)), cfg, mode)
    _assert_bitwise(eng.state, want)


@pytest.mark.parametrize("mode", TRAIN_MODES)
def test_warmup_leaves_the_state_bitwise(port_state, mode):
    cfg, state = port_state
    before = _clone(state)
    eng = LearnerEngine.from_ddpg(state, cfg, force_mode=mode, batcher=BatcherConfig(buckets=BUCKETS))
    assert eng.warmup(padded=True) == 2 * len(BUCKETS)  # an exact and a masked call per bucket
    assert eng.state is state
    _assert_bitwise(state, before)


def test_update_batcher_coalesces_by_rows():
    ub = UpdateBatcher(BatcherConfig(buckets=BUCKETS, max_wait_ms=10_000.0))
    for i, batch in enumerate(requests((8,) * 5)):
        ub.submit(batch)
    reqs = ub.next_batch(timeout=0.5)  # 32-row cap -> 4 x 8-row requests
    assert [r.rows for r in reqs] == [8, 8, 8, 8]
    assert len(ub) == 1
    with pytest.raises(ValueError, match="exceeds the top bucket"):
        ub.submit(requests((33,))[0])
    with pytest.raises(ValueError, match="missing"):
        UpdateBatcher(BatcherConfig(buckets=BUCKETS), required_keys=TRANSITION_KEYS).submit(
            {"obs": np.zeros((4, OBS))})


@pytest.mark.parametrize("mode", TRAIN_MODES)
def test_threaded_streaming_applies_all_requests_sequentially(port_state, mode):
    cfg, state = port_state
    eng = LearnerEngine.from_ddpg(state, cfg, force_mode=mode, batcher=BatcherConfig(buckets=BUCKETS, max_wait_ms=5.0))
    eng.warmup(padded=True)
    rows = [4, 8, 11, 3, 16, 9, 40, 1]
    batches = requests(rows, seed=11)
    futs, lock = [], threading.Lock()

    def producer(chunk):
        for b in chunk:
            f = eng.submit(b)
            with lock:
                futs.append(f)

    eng.start()
    try:
        threads = [threading.Thread(target=producer, args=(batches[i::4],)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120.0)
            assert not t.is_alive()
        results = [f.result(timeout=120.0) for f in futs]
    finally:
        eng.stop()
    assert len(results) == len(rows) and all("critic_loss" in r for r in results)
    st = eng.stats()
    assert st["requests"] == len(rows) + 1  # the 40-row request is two chunks
    assert st["transitions"] == sum(rows)
    assert st["updates"] == int(eng.state.step) - int(state.step)
    assert sum(st["mode_histogram"]["train"].values()) == st["updates"]
    assert st["p99_ms"] >= st["p50_ms"]
    assert 0 < st["batch_occupancy"] <= 1.0
    assert st["updates_per_s_device"] > 0 and st["train_ips_device"] > 0
    assert all(bool(torch.isfinite(t).all()) for t in tree.leaves(eng.state.actor))


def test_submit_requires_running_engine_and_splits_oversize(port_state):
    cfg, state = port_state
    eng = LearnerEngine.from_ddpg(state, cfg, force_mode="jnp", batcher=BatcherConfig(buckets=BUCKETS))
    with pytest.raises(RuntimeError, match="not streaming"):
        eng.submit(requests((8,))[0])
    eng.start()
    try:
        res = eng.submit(requests((70,), seed=2)[0]).result(timeout=120.0)  # 3 chunks, aggregate future
        assert res["chunks"] == 3 and "critic_loss" in res
    finally:
        eng.stop()
    assert int(eng.state.step) == int(state.step) + 3
    with pytest.raises(RuntimeError, match="not streaming"):
        eng.submit(requests((8,))[0])


def test_force_mode_and_pad_policy_validation(port_state):
    cfg, state = port_state
    with pytest.raises(ValueError, match="force_mode"):
        LearnerEngine.from_ddpg(state, cfg, force_mode="layer")
    with pytest.raises(ValueError, match="cannot train"):
        LearnerEngine.from_ddpg(state, cfg, modes=("fused", "layer"))
    with pytest.raises(ValueError, match="pad_policy"):
        LearnerEngine.from_ddpg(state, cfg, pad_policy="truncate")
    eng = LearnerEngine.from_ddpg(state, cfg, force_mode="jnp", batcher=BatcherConfig(buckets=BUCKETS),
                                  pad_policy="exact")
    with pytest.raises(ValueError, match="exact"):
        eng.run_update(requests((5,))[0])
    eng.run_update(requests((8,))[0])  # an exact fit passes
    assert int(eng.state.step) == int(state.step) + 1


def test_default_buckets_and_adaptive_dispatch(port_state):
    """The reference's defaults: buckets 8, 32, 128; unforced, the
    train-phase dispatcher picks by bucket (jnp at 8, the fused step
    above, under the reference's hand-set costs)."""
    cfg, state = port_state
    eng = LearnerEngine.from_ddpg(state, cfg)
    assert eng.batcher_config.buckets == DEFAULT_BUCKETS == (8, 32, 128)
    assert eng.modes == TRAIN_MODES and eng.device == torch.device("cpu")
    for n in (8, 32):
        eng.run_update(requests((n,), seed=n)[0])
    chosen = [eng.cost_model.choose(n, eng.dims, phase="train") for n in (8, 32)]
    assert eng.stats()["mode_histogram"]["train"] == {m: chosen.count(m) for m in chosen}


def test_a_cuda_state_without_a_card_raises(port_state, monkeypatch):
    """The device rule: the engine computes where its state lives; a state
    whose tensors report `cuda` on a machine without a card raises (no
    quiet CPU run), and tensors on two devices are refused."""
    from repro_torch.train.learner import engine as eng_mod

    cfg, state = port_state
    fake = dataclasses.replace(state, step=torch.empty((), dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match="different devices"):
        LearnerEngine.from_ddpg(fake, cfg)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(eng_mod, "check_same_device", lambda *ts: torch.device("cuda"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LearnerEngine.from_ddpg(state, cfg)


def test_generic_update_family_contract():
    """Any update_fn(state, batch) -> (state, metrics) family with
    pad_policy="exact"; a state with no tensor takes the host batch as it
    is; chunking is key-agnostic; warmup needs a batch template."""
    calls = []

    def update(state, batch):
        calls.append(batch["x"].shape[0])
        return state + batch["x"].sum(), {"loss": batch["x"].mean()}

    eng = LearnerEngine(np.float64(0.0), {"jnp": update}, dims=[17, 400, 300, 6],
                        batcher=BatcherConfig(buckets=(4, 8)), pad_policy="exact")
    assert eng.device is None
    m = eng.run_update({"x": np.ones((8, 2))})
    assert m["loss"] == 1.0 and m["mode"] == "jnp"
    assert eng.state == 16.0 and calls == [8]
    m2 = eng.run_update({"x": np.full((16, 2), 2.0)})
    assert m2["chunks"] == 2 and m2["loss"] == 2.0
    assert calls == [8, 8, 8] and eng.state == 16.0 + 64.0
    with pytest.raises(RuntimeError, match="warmup_template"):
        eng.warmup()
    eng.warmup_template = lambda rows: {"x": np.zeros((rows, 2))}
    assert eng.warmup(buckets=(4,)) == 1
    assert eng.state == 80.0  # zero batch: warmup adds nothing


def test_load_state_installs_a_state(port_state):
    cfg, state = port_state
    eng = LearnerEngine.from_ddpg(state, cfg, force_mode="jnp", batcher=BatcherConfig(buckets=BUCKETS))
    _, other = narrow_port_state(seed=1)
    eng.load_state(other)
    assert eng.state is other
    (batch,) = requests((8,), seed=5)
    eng.run_update(batch)
    _assert_bitwise(eng.state, _direct(other, batch, cfg, "jnp")[0])


# --------------------------------------------------------------------- #
# 2. the port's learner against the reference's
# --------------------------------------------------------------------- #


def _assert_close(got, want, what, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol, err_msg=what)


def _assert_state_close(st_p, st_r):
    for name in ("actor", "critic", "actor_target", "critic_target"):
        for layer, leaves in getattr(st_r, name).items():
            for leaf, want in leaves.items():
                _assert_close(getattr(st_p, name)[layer][leaf], want, f"{name}/{layer}/{leaf}", rtol=1e-4, atol=2e-5)
    for name in ("actor_opt", "critic_opt"):
        o_p, o_r = getattr(st_p, name), getattr(st_r, name)
        assert int(o_p.step) == int(o_r.step)
        for layer, leaves in o_r.mu.items():
            for leaf in leaves:
                _assert_close(o_p.mu[layer][leaf], o_r.mu[layer][leaf], f"{name}.mu/{layer}/{leaf}", rtol=1e-4,
                              atol=2e-6)
                _assert_close(o_p.nu[layer][leaf], o_r.nu[layer][leaf], f"{name}.nu/{layer}/{leaf}", rtol=1e-4,
                              atol=1e-7)
    assert int(st_p.step) == int(st_r.step) and int(st_p.qat.step) == int(st_r.qat.step)
    for site, r in st_r.qat.ranges.items():
        p = st_p.qat.ranges[site]
        assert int(p.count) == int(r.count), site
        for field in ("a_min", "a_max"):
            _assert_close(getattr(p, field), getattr(r, field), f"{site}.{field}", rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def reference_streams():
    """Per mode, the reference learner's state before and after each
    request of STREAM, with its metrics (module docstring, item 2)."""
    import jax

    from repro.train.learner import LearnerEngine as RLearner

    out = {}
    for mode in ("jnp", "fused"):
        cfg_r, cfg_p, st_r = narrow_reference_state(qat=True, delay=2)
        eng = RLearner.from_ddpg(st_r, cfg_r, force_mode=mode)
        steps = []
        for batch in requests(STREAM, seed=21):
            before = jax.tree.map(np.asarray, eng.state)
            metrics = eng.run_update(batch)
            steps.append((before, batch, metrics, jax.tree.map(np.asarray, eng.state)))
        out[mode] = (cfg_p, steps, eng.stats())
    return out


@pytest.mark.parametrize("mode", ["jnp", "fused"])
def test_learner_matches_reference_learner(reference_streams, mode):
    from repro_torch.convert import ddpg_state_from_numpy

    cfg_p, steps, _ = reference_streams[mode]
    eng = None
    phases = set()
    for before, batch, want_metrics, want_state in steps:
        start = ddpg_state_from_numpy(before, device="cpu")
        phases.add(bool(start.qat.quantized_phase))
        if eng is None:
            eng = LearnerEngine.from_ddpg(start, cfg_p, force_mode=mode)
        else:
            eng.load_state(start)
        got_metrics = eng.run_update(batch)
        assert set(got_metrics) == set(want_metrics)
        assert got_metrics["mode"] == want_metrics["mode"] == mode
        for k, v in want_metrics.items():
            if k == "mode":
                continue
            np.testing.assert_allclose(got_metrics[k], v, rtol=1e-4, atol=1e-5, err_msg=k)
        _assert_state_close(eng.state, want_state)
    assert phases == {False, True}  # the stream crosses the QAT delay
    assert eng.stats()["updates"] == 6 and eng.stats()["transitions"] == sum(STREAM)


def test_stats_keys_match_reference(reference_streams, port_state):
    cfg, state = port_state
    eng = LearnerEngine.from_ddpg(state, cfg, force_mode="jnp")
    eng.run_update(requests((8,))[0])
    want = reference_streams["jnp"][2]
    got = eng.stats()
    assert set(got) == set(want)
    assert got["mode_histogram"].keys() == want["mode_histogram"].keys()
