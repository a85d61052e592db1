"""Port parity: the serving slice end to end — weights carried across from
the JAX reference, the port's `act_batch` in every mode, and its
`PolicyEngine` (synchronous and threaded) against the reference engine.

The contract is the reference's serve contract, rtol 1e-5 / atol 1e-6
(tests/serve/test_policy_engine.py).  These tests run the port on the CPU,
where its kernels' plain versions stand in for the CUDA kernels.
"""

import json
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.rl import ddpg as rddpg
from repro.rl.envs.locomotion import make
from repro.serve.policy import BatcherConfig as RefBatcherConfig
from repro.serve.policy import PolicyEngine as RefEngine
from repro.serve.policy import dispatch as rdispatch

from repro_torch import convert
from repro_torch.core.qat import QATState
from repro_torch.device import resolve_device
from repro_torch.rl import ddpg as pddpg
from repro_torch.serve.policy import BatcherConfig, CostModel, MicroBatcher, PolicyEngine
from repro_torch.serve.policy import dispatch as pdispatch

SERVE_TOL = dict(rtol=1e-5, atol=1e-6)
MODES = ("fused", "layer", "jnp")
ACTOR_DIMS = [17, 400, 300, 6]
_CACHE: dict = {}


def _regime(name: str):
    """(reference actor, reference FrozenQuant, port actor, port FrozenQuant)
    for a reference DDPG state initialised with jax.random.key(0)."""
    if name not in _CACHE:
        cfg = {"frozen": rddpg.DDPGConfig(qat_delay=0),
               "monitor": rddpg.DDPGConfig(qat_delay=10**9),
               "off": rddpg.DDPGConfig(qat_enabled=False)}[name]
        state = rddpg.init(jax.random.key(0), make("halfcheetah").spec, cfg)
        ref_frozen = rddpg.freeze_actor_quant(state)
        actor = convert.actor_from_numpy(jax.tree.map(np.asarray, state.actor), device="cpu")
        frozen = None
        if ref_frozen is not None:
            frozen = convert.frozen_from_numpy(
                np.asarray(ref_frozen.a_mins), np.asarray(ref_frozen.a_maxs), np.asarray(ref_frozen.deltas),
                np.asarray(ref_frozen.zs), quantized=ref_frozen.quantized, n_bits=ref_frozen.n_bits,
                fxp32_phase1=ref_frozen.fxp32_phase1, device="cpu")
        _CACHE[name] = (state, ref_frozen, actor, frozen)
    return _CACHE[name]


def _obs(batch: int, seed: int = 0) -> np.ndarray:
    return (np.random.default_rng(seed + batch).normal(size=(batch, 17)) * 2).astype(np.float32)


@pytest.mark.parametrize("regime", ["frozen", "monitor", "off"])
@pytest.mark.parametrize("batch", [1, 7, 64])
@pytest.mark.parametrize("mode", MODES)
def test_act_batch_matches_reference(mode, batch, regime):
    state, ref_frozen, actor, frozen = _regime(regime)
    obs = _obs(batch)
    got = pddpg.act_batch(actor, torch.from_numpy(obs), frozen, mode=mode)
    want = rddpg.act_batch(state.actor, jnp.asarray(obs), ref_frozen, mode=mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SERVE_TOL, err_msg=f"{mode}/{regime}/b{batch}")


def test_converted_weights_are_exact():
    state, ref_frozen, actor, frozen = _regime("frozen")
    for name, layer in state.actor.items():
        for k, v in layer.items():
            np.testing.assert_array_equal(actor[name][k].numpy(), np.asarray(v))
    assert frozen.quantized is True and ref_frozen.quantized is True
    np.testing.assert_array_equal(frozen.deltas.numpy(), np.asarray(ref_frozen.deltas))


@pytest.mark.parametrize("mode", MODES)
def test_engine_run_batch_matches_reference_engine(mode):
    state, _, actor, frozen = _regime("frozen")
    obs = _obs(7, seed=1)
    got = PolicyEngine(actor, frozen, device="cpu", force_mode=mode).run_batch(obs)
    want = RefEngine.from_ddpg(state, force_mode=mode).run_batch(obs)
    np.testing.assert_allclose(got, want, **SERVE_TOL)


def test_threaded_submit_matches_reference_engine():
    state, _, actor, frozen = _regime("frozen")
    obs = _obs(16, seed=2)
    want = RefEngine.from_ddpg(state, force_mode="layer").run_batch(obs)
    eng = PolicyEngine(actor, frozen, device="cpu", force_mode="layer",
                       batcher=BatcherConfig(buckets=(1, 8, 32), max_wait_ms=5.0))
    futs = {}
    eng.start()
    try:
        def client(lo, hi):
            for i in range(lo, hi):
                futs[i] = eng.submit(obs[i])

        threads = [threading.Thread(target=client, args=(k * 4, k * 4 + 4)) for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
        got = np.stack([futs[i].result(timeout=60) for i in range(16)])
    finally:
        eng.stop()
    np.testing.assert_allclose(got, want, **SERVE_TOL)
    stats = eng.stats()
    assert stats["requests"] == 16
    assert sum(stats["mode_histogram"]["act"].values()) == stats["batches"]


def test_oversized_batch_is_chunked_like_the_reference():
    state, _, actor, frozen = _regime("off")
    obs = _obs(81, seed=3)
    eng = PolicyEngine(actor, frozen, device="cpu", force_mode="jnp", batcher=BatcherConfig(buckets=(1, 8, 32)))
    ref = RefEngine.from_ddpg(state, force_mode="jnp", batcher=RefBatcherConfig(buckets=(1, 8, 32)))
    np.testing.assert_allclose(eng.run_batch(obs), ref.run_batch(obs), **SERVE_TOL)
    assert eng.stats()["batches"] == ref.stats()["batches"] == 3


def _key_tree(d):
    """Nested key structure of a stats() dict (values dropped)."""
    return {k: _key_tree(v) for k, v in d.items()} if isinstance(d, dict) else None


def test_stats_keys_match_reference_engine():
    state, _, actor, frozen = _regime("frozen")
    obs = _obs(7, seed=4)
    port = PolicyEngine(actor, frozen, device="cpu", force_mode="fused")
    ref = RefEngine.from_ddpg(state, force_mode="fused")
    port.run_batch(obs)
    ref.run_batch(obs)
    port.record_qat_telemetry(np.pad(obs, ((0, 1), (0, 0))), rows=7)
    ref.record_qat_telemetry(np.pad(obs, ((0, 1), (0, 0))), rows=7)
    p, r = port.stats(), ref.stats()
    assert list(p) == list(r)
    for key in ("mode_histogram", "dispatch_audit", "qat_telemetry"):
        assert _key_tree(p[key]) == _key_tree(r[key]), key
    for site, entry in r["qat_telemetry"].items():
        for k, v in entry.items():
            np.testing.assert_allclose(p["qat_telemetry"][site][k], v, rtol=1e-5, atol=1e-6, err_msg=f"{site}.{k}")
    assert p["cost_model"] == r["cost_model"] == "default"


def test_engine_client_strings_match_reference():
    for attr in ("not_running_msg", "already_started_msg", "stopped_msg", "health_running_key", "thread_name"):
        assert getattr(PolicyEngine, attr) == getattr(RefEngine, attr), attr


def test_submit_requires_running_engine():
    _, _, actor, frozen = _regime("off")
    eng = PolicyEngine(actor, frozen, device="cpu", force_mode="jnp")
    with pytest.raises(RuntimeError, match="not serving"):
        eng.submit(np.zeros(17))
    eng.start()
    assert eng.submit(np.zeros(17)).result(timeout=60).shape == (6,)
    eng.stop()
    with pytest.raises(RuntimeError, match="not serving"):
        eng.submit(np.zeros(17))
    with pytest.raises(ValueError, match="force_mode"):
        PolicyEngine(actor, frozen, device="cpu", modes=("fused", "jnp"), force_mode="layer")


def test_serve_path_is_stateless():
    _, _, actor, frozen = _regime("frozen")
    eng = PolicyEngine(actor, frozen, device="cpu", force_mode="fused")
    obs = _obs(7, seed=5)
    first = eng.run_batch(obs)
    for _ in range(3):
        np.testing.assert_array_equal(eng.run_batch(obs), first)
    assert not any(isinstance(v, QATState) for v in vars(eng).values())
    assert eng.warmup(buckets=(1, 8)) == 2


@pytest.mark.parametrize("batch", [1, 8, 32, 128, 512])
def test_cost_model_chooses_like_the_reference(batch):
    assert CostModel.default().choose(batch, ACTOR_DIMS) == rdispatch.CostModel.default().choose(batch, ACTOR_DIMS)
    for mode in MODES:
        for phase in ("act", "train"):
            assert pdispatch.cost_hint(mode, ACTOR_DIMS, phase) == rdispatch.cost_hint(mode, ACTOR_DIMS, phase)
            assert CostModel.default().estimate_us(mode, batch, ACTOR_DIMS, phase) == \
                rdispatch.CostModel.default().estimate_us(mode, batch, ACTOR_DIMS, phase)


def test_cost_model_defaults_and_dispatch_match_reference():
    assert CostModel.default().choose(1, ACTOR_DIMS) == "layer"
    assert CostModel.default().choose(512, ACTOR_DIMS) == "fused"
    assert pdispatch.MODES == rdispatch.MODES and pdispatch.TRAIN_MODES == rdispatch.TRAIN_MODES
    assert {k: (v.per_launch_us, v.us_per_kflop) for k, v in pdispatch.DEFAULT_COSTS.items()} == \
        {k: (v.per_launch_us, v.us_per_kflop) for k, v in rdispatch.DEFAULT_COSTS.items()}


def test_cost_model_from_bench_fits_like_the_reference(tmp_path):
    bench = {"config": {"batch": 512, "net": ACTOR_DIMS},
             "actor_ips": {"jnp": 200_000.0, "pallas": 50_000.0},
             "actor_ips_by_batch": {"pallas": {"64": 60_000.0, "512": 90_000.0}},
             "train": {"batch": 128, "updates_per_s": {"jnp": 100.0}}}
    path = tmp_path / "bench.json"
    path.write_text(json.dumps(bench))
    p, r = CostModel.from_bench(path), rdispatch.CostModel.from_bench(path)
    assert {k: (v.per_launch_us, v.us_per_kflop) for k, v in p.costs.items()} == \
        {k: (v.per_launch_us, v.us_per_kflop) for k, v in r.costs.items()}
    assert p.train_costs.keys() == r.train_costs.keys()
    assert CostModel.from_bench(tmp_path / "missing.json").source == "default (no bench file)"


def test_micro_batcher_coalesces_fifo():
    mb = MicroBatcher(BatcherConfig(buckets=(1, 4), max_wait_ms=10_000.0))
    for i in range(5):
        mb.submit(np.full(3, i))
    assert [int(r.obs[0]) for r in mb.next_batch(timeout=0.5)] == [0, 1, 2, 3]
    assert len(mb) == 1


def test_no_device_means_no_quiet_cpu_run(monkeypatch):
    """Without CUDA, an entry point given no device raises instead of
    running on the CPU; asking for cuda raises too."""
    _, _, actor, frozen = _regime("frozen")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PolicyEngine(actor, frozen)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PolicyEngine(actor, frozen, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError):
        pddpg.init_actor(17, 6, generator=torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError):
        convert.actor_from_numpy({"l0": {"w": np.zeros((2, 2)), "b": np.zeros(2)}})
    with pytest.raises(RuntimeError):
        QATState.init(0, ["s"])
    assert resolve_device("cpu") == torch.device("cpu")


def test_init_actor_distributions():
    a = pddpg.init_actor(17, 6, generator=torch.Generator().manual_seed(0), device="cpu")
    b = pddpg.init_actor(17, 6, generator=torch.Generator().manual_seed(0), device="cpu")
    dims = [17, *pddpg.HIDDEN, 6]
    for i in range(3):
        w, bias = a[f"l{i}"]["w"], a[f"l{i}"]["b"]
        assert tuple(w.shape) == (dims[i], dims[i + 1]) and tuple(bias.shape) == (dims[i + 1],)
        bound = 3e-3 if i == 2 else dims[i] ** -0.5
        assert float(w.abs().max()) <= bound + 2.0**-16 and float(bias.abs().max()) <= bound + 2.0**-16
        np.testing.assert_array_equal((w * 65536).numpy(), np.round((w * 65536).numpy()))  # Q15.16
        assert torch.equal(w, b[f"l{i}"]["w"])
    assert pddpg.ACTOR_SITES == rddpg.ACTOR_SITES and pddpg.ACTOR_ACTS == rddpg.ACTOR_ACTS
    assert pddpg.HIDDEN == rddpg.HIDDEN


def test_actor_site_telemetry_matches_reference():
    state, ref_frozen, actor, frozen = _regime("frozen")
    obs = _obs(8, seed=6)
    mask = np.array([1, 1, 1, 1, 1, 0, 0, 0], np.float32)
    got = pddpg.actor_site_telemetry(actor, torch.from_numpy(obs), frozen, torch.from_numpy(mask))
    want = rddpg.actor_site_telemetry(state.actor, jnp.asarray(obs), ref_frozen, jnp.asarray(mask))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n_devices", [1, 2])
@pytest.mark.parametrize("mode", MODES)
def test_mesh_engine_matches_unsharded_engine(mode, n_devices):
    """`mesh=` on a 1- and a 2-device CPU serve mesh: a bucket whose rows
    divide by the mesh splits into one chunk per device; the actions are
    the `mesh=None` engine's (every row of the plain versions is computed
    alone, so bitwise), and within the serve contract of the reference's
    engine with its own 1-device mesh.  Bucket 1 on 2 devices does not
    divide and runs unsplit, as in the reference."""
    from repro.launch.mesh import make_serve_mesh as ref_serve_mesh

    from repro_torch.launch.mesh import make_serve_mesh

    state, _, actor, frozen = _regime("frozen")
    buckets = BatcherConfig(buckets=(1, 8, 32))
    mesh = make_serve_mesh(n_devices, device="cpu")
    sharded = PolicyEngine(actor, frozen, device="cpu", force_mode=mode, batcher=buckets, mesh=mesh)
    plain = PolicyEngine(actor, frozen, device="cpu", force_mode=mode, batcher=buckets)
    ref = RefEngine.from_ddpg(state, force_mode=mode, batcher=RefBatcherConfig(buckets=(1, 8, 32)),
                              mesh=ref_serve_mesh(1))
    for rows in (1, 5, 8, 27):
        obs = _obs(rows, seed=7)
        got = sharded.run_batch(obs)
        np.testing.assert_array_equal(got, plain.run_batch(obs), err_msg=f"{mode}/{n_devices}/{rows}")
        np.testing.assert_allclose(got, ref.run_batch(obs), **SERVE_TOL)
    assert sharded.stats()["batches"] == 4


def test_mesh_engine_refuses_a_layout_without_devices():
    from repro_torch.core.parallelism import Mesh

    _, _, actor, frozen = _regime("off")
    with pytest.raises(ValueError, match="layout only"):
        PolicyEngine(actor, frozen, device="cpu", mesh=Mesh((2,), ("data",)))
    with pytest.raises(ValueError, match="no 'data' axis"):
        PolicyEngine(actor, frozen, device="cpu", mesh=Mesh((2,), ("model",), ["cpu", "cpu"]))


@pytest.mark.parametrize("mode", MODES)
def test_mesh_engine_over_data_and_model_matches_act_batch(mode):
    """A (data 2, model 2) mesh of CPU placements: the batch splits over
    "data" (two chunks, on the first device of each data slice) and the
    "model" axis replicates, split when the rows divide by the mesh's size
    (4), as the reference's `x.shape[0] % mesh.size == 0`; the actions are
    bitwise the unsharded `act_batch` on the same rows (the plain versions
    compute every row alone), bucket 1 running unsplit."""
    from repro_torch.core.parallelism import Mesh

    _, _, actor, frozen = _regime("frozen")
    mesh = Mesh((2, 2), ("data", "model"), ["cpu"] * 4)
    eng = PolicyEngine(actor, frozen, device="cpu", force_mode=mode, batcher=BatcherConfig(buckets=(1, 8, 32)),
                       mesh=mesh)
    assert len(eng._replicas) == 2
    calls = []
    real = pddpg.act_batch

    def spy(a, x, f, mode):
        calls.append(x.shape[0])
        return real(a, x, f, mode=mode)

    pddpg.act_batch = spy
    try:
        for rows in (1, 5, 8, 27):
            obs = _obs(rows, seed=11)
            got = eng.run_batch(obs)
            np.testing.assert_array_equal(got, real(actor, torch.from_numpy(obs), frozen, mode=mode).numpy(),
                                          err_msg=f"{mode}/{rows}")
    finally:
        pddpg.act_batch = real
    assert calls == [1, 4, 4, 4, 4, 16, 16], calls
