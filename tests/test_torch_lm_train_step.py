"""Port parity: the LM train step (`repro_torch.train.step`) against the JAX
reference's (`repro.train.step`).

* The optimizer tail — `quantize_grads` → `adam.update` → `quantize_weights`
  — fed the reference's own demo-smoke gradients (moved through numpy) for three
  steps: params, moments and metrics bitwise the reference's (t ≤ 3, under
  the ulp of the float32 `pow` in Adam's bias corrections; a warmup-cosine
  schedule).  With a global-norm clip the norm is a reduction each
  framework sums in another order, and the reference's float32 sum is the
  less exact one (on a qwen2 smoke gradient 1.9758298 against the float64
  1.97583147 and the port's 1.9758315; on demo-smoke 1.1e-6 relative
  apart): so the clipped tail holds the norm at rtol 1e-5 (√n·u of a
  float32 sum of n ≈ 3·10⁴ squares, a leaf's), the moments, which the clip
  scales by it (nu by its square) before they round, at 2e-5 (mu) and 4e-5
  (nu), and the params within one Q15.16 quantum, as
  `tests/test_torch_optim.py` holds its clipped updates.
* Three whole QAT steps of demo-smoke (float32) from the same
  params on the same batches, the QAT delay at 2, with 1 and 2
  microbatches: each step's loss within 1e-4 relative (Adam moves an
  element by about ±lr whatever its gradient's size, so params that part by
  an ulp of a near-zero gradient do not make an elementwise contract), the
  `quant_phase` sequence exactly, the range trees within the forward's
  contract (rtol 1e-4 / atol 5e-5, counts exact).
* The reference's `tests/test_archs.py::test_train_step_qat` on the port
  for all ten archs; `cfg.remat` "dots" and "full" bitwise "none"; the
  learner adapter's shape (`tests/train/test_learner.py`) and a learner
  stream bitwise direct calls.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401  (one intra-op thread a worker)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _torch_lm_train as H  # noqa: E402
from repro.configs import registry as rreg  # noqa: E402
from repro.core import qat as rqat  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro.optim import adam as radam  # noqa: E402
from repro.optim import schedule as rschedule  # noqa: E402
from repro.train import step as rstep  # noqa: E402
from repro_torch import convert, tree  # noqa: E402
from repro_torch.configs import registry as preg  # noqa: E402
from repro_torch.core import qat as pqat  # noqa: E402
from repro_torch.models import transformer as PT  # noqa: E402
from repro_torch.optim import adam as padam  # noqa: E402
from repro_torch.optim import schedule as pschedule  # noqa: E402
from repro_torch.train import step as pstep  # noqa: E402

QUANTUM = 2.0**-16


def _opt_cfgs(clip):
    kw = dict(lr=1e-3, grad_clip_norm=clip)
    return (radam.AdamConfig(schedule=rschedule.warmup_cosine(2, 10), **kw),
            padam.AdamConfig(schedule=pschedule.warmup_cosine(2, 10), **kw))


@pytest.mark.parametrize("clip", [None, 1.0])
def test_optimizer_tail_matches_reference(clip):
    rcfg, pcfg = _opt_cfgs(clip)
    rc, r_state, _, _, _ = _demo_states(1)
    rp = r_state.params
    b = H.to_jax(H.batch(rc, 40, s=32, b=4))
    grads = jax.tree.leaves(jax.jit(jax.grad(lambda p: RT.loss_fn(p, b, rc, remat=False)[0]))(rp))
    treedef = jax.tree.structure(rp)
    r_params, r_opt = rp, radam.init(rp)
    p_params = convert.lm_params_from_numpy(jax.tree.map(np.asarray, rp), device="cpu")
    p_opt = padam.init(p_params)
    for t in range(3):
        g = [np.asarray(w) * np.float32(1.0 + 0.5 * t) for w in grads]  # a new gradient each step
        r_g = rqat.quantize_grads(jax.tree.unflatten(treedef, [jnp.asarray(x) for x in g]))
        r_new, r_opt, r_m = radam.update(rcfg, r_g, r_opt, r_params)
        r_params = rqat.quantize_weights(r_new)
        p_g = pqat.quantize_grads(tree.unflatten(p_params, [torch.from_numpy(x) for x in g]))
        p_new, p_opt, p_m = padam.update(pcfg, p_g, p_opt, p_params)
        p_params = pqat.quantize_weights(p_new)
        assert sorted(p_m) == sorted(r_m)
        for name, want, got, tol in (("params", r_params, p_params, dict(rtol=0, atol=QUANTUM)),
                                     ("mu", r_opt.mu, p_opt.mu, dict(rtol=2e-5, atol=0)),
                                     ("nu", r_opt.nu, p_opt.nu, dict(rtol=4e-5, atol=0))):
            for w, p in zip(jax.tree.leaves(want), tree.leaves(got)):
                if clip is None:
                    np.testing.assert_array_equal(p.numpy(), np.asarray(w), err_msg=f"{name} t={t + 1}")
                else:
                    np.testing.assert_allclose(p.numpy(), np.asarray(w), **tol, err_msg=f"{name} t={t + 1}")
        assert int(p_opt.step) == int(r_opt.step) == t + 1
        assert float(p_m["lr"]) == float(r_m["lr"])
        if clip is not None:
            np.testing.assert_allclose(float(p_m["grad_norm"]), float(r_m["grad_norm"]), rtol=1e-5)


def _demo_states(n_micro):
    rc = dataclasses.replace(rreg.get_smoke("demo_100m"), qat=True, qat_delay=2, dtype="float32")
    pc = dataclasses.replace(preg.get_smoke("demo_100m"), qat=True, qat_delay=2, dtype="float32")
    r_state = rstep.init_state(jax.random.key(0), rc)
    params = convert.lm_params_from_numpy(jax.tree.map(np.asarray, r_state.params), device="cpu")
    p_state = pstep.TrainState(params=params, opt=padam.init(params),
                               ranges=convert.lm_ranges_from_numpy(jax.tree.map(np.asarray, r_state.ranges),
                                                                   device="cpu"),
                               step=torch.zeros((), dtype=torch.int32))
    rcfg, pcfg = _opt_cfgs(1.0)
    return (rc, r_state, p_state, jax.jit(rstep.make_train_step(rc, rcfg, n_microbatches=n_micro)),
            pstep.make_train_step(pc, pcfg, n_microbatches=n_micro))


@pytest.mark.parametrize("n_micro", [1, 2])
def test_whole_steps_match_reference(n_micro):
    rc, r_state, p_state, r_step, p_step = _demo_states(n_micro)
    phases = []
    for t in range(3):
        b = H.batch(rc, 20 + t, s=32, b=4)
        r_state, r_m = r_step(r_state, H.to_jax(b))
        p_state, p_m = p_step(p_state, H.to_torch(b))
        want = float(r_m["loss"])
        assert abs(float(p_m["loss"]) - want) <= 1e-4 * abs(want), (t, float(p_m["loss"]), want)
        assert int(p_m["quant_phase"]) == int(r_m["quant_phase"])
        phases.append(int(p_m["quant_phase"]))
        H.assert_ranges(p_state.ranges, jax.tree.map(np.asarray, r_state.ranges), f"step {t + 1}")
    assert phases == [0, 0, 1]
    assert int(p_state.step) == 3 and int(p_state.opt.step) == 3


def _arch_batch(cfg, seed=1, b=2, s=64):
    rng = np.random.default_rng(seed)
    out = {"labels": torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32))}
    if cfg.frontend != "audio_stub":
        out["tokens"] = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32))
    if cfg.frontend == "vision_stub":
        out["frontend"] = torch.from_numpy(rng.normal(size=(b, cfg.frontend_len, cfg.frontend_dim)).astype(np.float32))
    if cfg.frontend == "audio_stub":
        out["frontend"] = torch.from_numpy(rng.normal(size=(b, s, cfg.frontend_dim)).astype(np.float32))
    return out


@pytest.mark.parametrize("arch", preg.lm_archs())
def test_train_step_qat(arch):
    """The reference's per-arch smoke test on the port: three QAT steps
    (delay 2) on a repeated batch — loss finite and falling, params finite,
    ranges captured — and the phase flag flips at the delay with the
    ranges frozen from then on."""
    cfg = dataclasses.replace(preg.get_smoke(arch), qat=True, qat_delay=2)
    state = pstep.init_state(0, cfg, device="cpu")
    step = pstep.make_train_step(cfg, padam.AdamConfig(lr=1e-3, grad_clip_norm=1.0))
    batch = _arch_batch(cfg)
    l0, phases, frozen = None, [], None
    for t in range(3):
        state, metrics = step(state, batch)
        assert bool(torch.isfinite(metrics["loss"]))
        l0 = l0 or float(metrics["loss"])
        phases.append(int(metrics["quant_phase"]))
        if t == 1:
            frozen = [x.clone() for x in tree.leaves(state.ranges)]
    assert float(metrics["loss"]) < l0  # optimizes on a repeated batch
    assert all(bool(torch.isfinite(x).all()) for x in tree.leaves(state.params))
    first = state.ranges["scan"][0][PT.block_sites(cfg, cfg.block_pattern[0])[0]].a_max
    assert bool(torch.isfinite(first).all()), "ranges never captured"
    assert phases == [0, 0, 1]
    assert all(torch.equal(a, b) for a, b in zip(tree.leaves(state.ranges), frozen))


@pytest.mark.parametrize("remat", ["dots", "full"])
@pytest.mark.parametrize("arch", ["qwen2_0_5b", "rwkv6_1_6b", "recurrentgemma_2b", "moonshot_v1_16b_a3b"])
def test_remat_leaves_grads_and_ranges_bitwise(arch, remat):
    """`cfg.remat` "dots" (matrix products saved, the rest recomputed) and
    "full" (each period recomputed from its inputs) against "none" on the
    CPU, at the smoke config's own bf16: loss, every gradient leaf and the
    range tree bitwise, in the monitor phase (the QAT sites fold their ranges in the checkpointed
    period, so a recompute that re-ran them on shared state would show)."""
    cfg = preg.get_smoke(arch)
    params = PT.init_params(0, cfg, device="cpu")
    batch = _arch_batch(cfg, s=32)
    ranges = PT.init_ranges(cfg, device="cpu")
    want = pstep.value_and_grad(dataclasses.replace(cfg, remat="none"), params, ranges, batch, torch.tensor(False))
    got = pstep.value_and_grad(dataclasses.replace(cfg, remat=remat), params, ranges, batch, torch.tensor(False))
    assert torch.equal(got[0], want[0])
    assert all(torch.equal(a, b) for a, b in zip(tree.leaves(got[2]), tree.leaves(want[2])))
    assert all(torch.equal(a, b) for a, b in zip(tree.leaves(got[1]["ranges"]), tree.leaves(want[1]["ranges"])))


def test_learner_update_fns_adapter_shape():
    """The LM train step in the engine's update-family contract (one
    "jnp" mode), as the reference's `tests/train/test_learner.py` holds."""
    from repro_torch.models.config import ModelConfig

    cfg = ModelConfig(name="tiny", family="dense", n_layers=1, d_model=8, n_heads=2, n_kv_heads=2, d_ff=16,
                      vocab_size=32)
    fns = pstep.learner_update_fns(cfg, padam.AdamConfig())
    assert set(fns) == {"jnp"} and callable(fns["jnp"])


def test_learner_stream_is_bitwise_direct_calls():
    """Two demo-smoke QAT steps through `LearnerEngine(pad_policy="exact")`
    equal two direct calls of the same step on the same batches, bitwise."""
    from repro_torch.runtime.engine import BatcherConfig
    from repro_torch.train.learner import LearnerEngine

    cfg = dataclasses.replace(preg.get_smoke("demo_100m"), qat=True, qat_delay=1)
    opt = padam.AdamConfig(lr=1e-3, grad_clip_norm=1.0)
    fns = pstep.learner_update_fns(cfg, opt)
    direct = pstep.init_state(0, cfg, device="cpu")
    eng = LearnerEngine(pstep.init_state(0, cfg, device="cpu"), fns, dims=[cfg.d_model, cfg.vocab_size],
                        force_mode="jnp", pad_policy="exact", batcher=BatcherConfig(buckets=(2,)))
    try:
        for t in range(2):
            b = _arch_batch(cfg, seed=30 + t, s=16)
            m = eng.run_update({k: v.numpy() for k, v in b.items()})
            direct, dm = fns["jnp"](direct, b)
            assert m["loss"] == float(dm["loss"]) and m["mode"] == "jnp"
        assert all(torch.equal(a, b) for a, b in zip(tree.leaves(eng.state), tree.leaves(direct)))
    finally:
        eng.close()


def test_training_after_serving_in_one_process():
    """A training backward after a serving call under `torch.inference_mode`
    in the same process: the layers' cached constants (the score scale,
    the RoPE table) must not be inference tensors, which autograd cannot
    save (the caches are cleared first, so the serving call makes them)."""
    cfg = preg.get_smoke("qwen2_0_5b")
    PT.L._const.cache_clear()
    PT.L.rope_freqs.cache_clear()
    params = PT.init_params(0, cfg, device="cpu")
    batch = _arch_batch(cfg, s=16)
    with torch.inference_mode():
        PT.prefill(params, {"tokens": batch["tokens"]}, cfg)
    loss, _, grads = pstep.value_and_grad(cfg, params, None, batch, torch.tensor(False))
    assert bool(torch.isfinite(loss)) and all(bool(torch.isfinite(g).all()) for g in tree.leaves(grads))


def test_train_state_leaves_in_the_reference_order():
    """`init_state`'s tree, walked by `repro_torch.tree` (what
    `checkpoint.ckpt` writes), names, orders and shapes its leaves as the
    reference's `TrainState` does under `jax.tree_util`, dtypes included:
    so either package's checkpoint lays out the other's state."""
    rc, pc = rreg.get_smoke("gemma3_1b"), preg.get_smoke("gemma3_1b")
    ref = jax.tree_util.tree_flatten_with_path(rstep.init_state(jax.random.key(0), rc))[0]
    mine = tree.flatten_with_path(pstep.init_state(0, pc, device="cpu"))
    assert [p for p, _ in mine] == [jax.tree_util.keystr(p) for p, _ in ref]
    for (path, t), (_, r) in zip(mine, ref):
        assert tuple(t.shape) == r.shape and str(t.dtype).removeprefix("torch.") == np.dtype(r.dtype).name, path
