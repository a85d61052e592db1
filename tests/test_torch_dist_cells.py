"""The port's sharded LM zoo on 8 CPU ranks of a gloo group (the reference
holds its sharding the same way, on 8 forced host devices:
`tests/test_sharding.py`).

One spawn of 8 ranks runs every case (`_torch_dist.run_ranks`); each test
reads its case.  The cells are the reference's, at its smoke configs and
shapes, in float32: qwen2 train and dbrx train at S = 256, B = 8 on the
debug mesh (data 2, model 4), rwkv6 decode against a 512-token cache at
B = 8, gemma3 prefill at S = 512, B = 4, and qwen2 train on the multi-pod
layout pod 2 × data 2 × model 2 (one step); a qwen2 decode at B = 1 under the
long-context rules (`shard_kv_seq`: the KV cache sharded along its
sequence); gemma3's prefill on a (1, 8) mesh (its attention weights
sharded on head_dim: heads that do not divide the model axis); an
rwkv6 train step (the WKV recurrence per rank on its (batch, head)
shards); and recurrentgemma's train step and decode (the RG-LRU gate
products laid out on "state" before their biases, `rglru._gates`, and its
decode output laid out as its prompt path's); gemma3's train step and
decode on the pure data-parallel (8, 1) mesh (its one kv head on a "model"
axis of 1); rwkv6's prefill and decode on (1, 8) (4 heads on 8 ranks); and
decodes at per-row positions on a batch-sharded and on a sequence-sharded
KV cache.  Each is held against the port's unsharded run on the same
arrays (itself held to the reference by the parity tests), to the
existing contracts:

  * prefill and decode logits within 2e-5·scale + 2e-5; greedy tokens
    equal except where the top-2 margin lies inside that bound;
  * train: the loss within 2e-5·|loss| + 2e-5, each gradient leaf within
    1e-4·max|g_leaf| + 1e-6; two whole steps (QAT, the quant phase from
    step 1, the reference's Adam config: lr 1e-4, clip 1.0): losses within
    2e-5·|loss| + 2e-5 (1e-4 relative in the quant phase), the clip norm to
    rtol 1e-5, params within 2·lr + a quantum (the clipped gradient is
    rounded onto the Q15.16 gradient lattice and Adam's first step is
    lr·g/(|g| + ε), about a sign, so a gradient within its bound of zero or
    of a rounding midpoint may move its param by lr either way); the
    optimizer's count exact and its moments within the gap the gradient
    contract and one gradient quantum allow (`_check_optimizer`); each
    step's param update within one quantum wherever the two runs' Q15.16
    gradients were the same at every step so far; the QAT ranges within
    the forward's contract, and bitwise where the monitored tensor is (min
    and max do not depend on order, but a sharded contraction sums in
    another order than the unsharded one, so an activation after one can
    differ in its last bits).

The dbrx train cell's first step is also held against the reference's own
sharded run: a subprocess with 8 forced host devices runs
`jax.value_and_grad` of the reference's loss on its debug mesh with the
train rules, on the port's arrays, while the ranks run (the parity tests'
contracts: loss, gradients, ranges rtol 1e-4 / atol 5e-5, counts exact).

Then the dry-run cells as the CLI runs them (`launch.dryrun.run_cell` on
the debug mesh, the smoke configs, QAT on): status ok, and the dbrx
prefill at 65,536 tokens runs the expert-parallel MoE path, whose
collectives are an all-gather of the expert weights and an all-reduce of
the combine.  The production dry run's measurement (`launch.dryrun.
measure`, fake tensors over a fake world) is held to these real runs: a
subprocess starts a fake world of 8 ranks (`launch.mesh.init_fake_world`)
and measures the same cells on the same (2, 4) mesh under
`FakeTensorMode` (`_FAKE_WORLD`); rank 0's flops, collective bytes and
argument, output and peak bytes must be the real run's.
"""

import json

import numpy as np
import pytest

pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401  (one intra-op thread a worker)

import _torch_dist as D

CASES = [
    ("mesh_guards", "_torch_dist_cases:mesh_guards", {}),
    ("qwen2_train", "_torch_dist_cases:train_cell", {"arch": "qwen2_0_5b"}),
    ("dbrx_train", "_torch_dist_cases:train_cell", {"arch": "dbrx_132b"}),
    ("rwkv6_decode", "_torch_dist_cases:decode_cell", {}),
    ("gemma3_prefill", "_torch_dist_cases:prefill_cell", {}),
    ("qwen2_train_multipod", "_torch_dist_cases:train_cell", {"arch": "qwen2_0_5b", "multi_pod": True,
                                                              "steps": 1}),
    ("qwen2_decode_kv_seq", "_torch_dist_cases:decode_cell", {"arch": "qwen2_0_5b", "batch": 1, "prompt": 254,
                                                              "steps": 3, "shard_kv_seq": True}),
    ("gemma3_prefill_model8", "_torch_dist_cases:prefill_cell", {"n_model": 8}),
    ("rwkv6_train", "_torch_dist_cases:train_cell", {"arch": "rwkv6_1_6b", "steps": 1}),
    ("recurrentgemma_train", "_torch_dist_cases:train_cell", {"arch": "recurrentgemma_2b", "steps": 1}),
    ("recurrentgemma_decode", "_torch_dist_cases:decode_cell", {"arch": "recurrentgemma_2b"}),
    # pure data parallel: one kv head on a "model" axis of 1
    ("gemma3_train_data8", "_torch_dist_cases:train_cell", {"arch": "gemma3_1b", "n_model": 1, "steps": 1}),
    ("gemma3_decode_data8", "_torch_dist_cases:decode_cell", {"arch": "gemma3_1b", "n_model": 1}),
    # 4 heads on a "model" axis of 8 (d_model 64 divides it)
    ("rwkv6_decode_model8", "_torch_dist_cases:decode_cell", {"arch": "rwkv6_1_6b", "n_model": 8}),
    # per-row positions: on a batch-sharded cache, and on a sequence-sharded
    # one (split at slot 256 over "data") whose rows' slots lie on both
    # sides of the split, row 0 crossing it
    ("gemma3_decode_rows", "_torch_dist_cases:decode_cell", {"arch": "gemma3_1b",
                                                             "row_offsets": [0, 3, 1, 7, 2, 5, 0, 9]}),
    ("qwen2_decode_rows_kv_seq", "_torch_dist_cases:decode_cell", {"arch": "qwen2_0_5b", "batch": 2, "prompt": 250,
                                                                   "steps": 3, "shard_kv_seq": True,
                                                                   "row_offsets": [4, 60]}),
    ("dry_qwen2_train", "_torch_dist_cases:dryrun_cell", {"arch": "qwen2_0_5b", "kind": "train", "seq": 256,
                                                          "batch": 8, "repeat": 2}),
    ("dry_dbrx_train", "_torch_dist_cases:dryrun_cell", {"arch": "dbrx_132b", "kind": "train", "seq": 256,
                                                        "batch": 8}),
    ("dry_rwkv6_decode", "_torch_dist_cases:dryrun_cell", {"arch": "rwkv6_1_6b", "kind": "decode", "seq": 512,
                                                          "batch": 8, "repeat": 2}),
    ("dry_gemma3_prefill", "_torch_dist_cases:dryrun_cell", {"arch": "gemma3_1b", "kind": "prefill", "seq": 512,
                                                            "batch": 4}),
    ("dry_dbrx_expert_parallel", "_torch_dist_cases:dryrun_cell", {"arch": "dbrx_132b", "kind": "prefill",
                                                                  "seq": 128, "batch": 512}),
]
# the dry-run cells measured again under fake tensors on a fake world of 8
FAKE_CELLS = {"dry_qwen2_train": ("qwen2_0_5b", "train", 256, 8), "dry_rwkv6_decode": ("rwkv6_1_6b", "decode", 512, 8)}
QUANTUM = 2.0 ** -16
LR, B1, B2 = 1e-4, 0.9, 0.999  # the cells' Adam config (the dry run's: lr 1e-4, the default betas)
GRAD_REL = (1e-4, 1e-3)  # the gradient contract's relative term: monitor phase, quant phase

# The reference's loss, gradients and ranges of the dbrx train cell's first
# step, sharded on its debug mesh over 8 forced host devices, from the
# port's arrays (leaves in pytree order).
_REF_DBRX = r"""
import dataclasses
import numpy as np
import jax, jax.numpy as jnp
from repro.configs import registry
from repro.core.parallelism import train_rules
from repro.launch import specs as S
from repro.launch.mesh import make_debug_mesh, mesh_context
from repro.models import transformer as T
from repro.models.config import ShapeConfig

inp = np.load(sys.argv[1])
cfg = dataclasses.replace(registry.get_smoke("dbrx_132b"), dtype="float32", qat=True, qat_delay=1)
shape = ShapeConfig("t", "train", 256, 8)
mesh = make_debug_mesh()
rules = train_rules(mesh)
st_sh, b_sh = S.train_shardings(cfg, shape, mesh, rules)
like = S.state_shapes(cfg)

def load(prefix, node):
    leaves = jax.tree.leaves(node)
    got = [jnp.asarray(inp[f"{prefix}{i}"]) for i in range(len(leaves))]
    assert [g.shape for g in got] == [l.shape for l in leaves], prefix
    return jax.tree.unflatten(jax.tree.structure(node), got)

params, ranges = load("p", like.params), load("r", like.ranges)
batch = {k: jnp.asarray(inp[f"b_{k}"]) for k in b_sh}

def f(p, b, r):
    return T.loss_fn(p, b, cfg, rules=rules, ranges=r, quant_phase=jnp.asarray(False), remat=False)

vg = jax.jit(jax.value_and_grad(f, has_aux=True), in_shardings=(st_sh.params, b_sh, st_sh.ranges))
with mesh_context(mesh):
    (loss, ex), g = vg(params, batch, ranges)
out = {"loss": np.asarray(loss)}
out.update({f"g{i}": np.asarray(x) for i, x in enumerate(jax.tree.leaves(g))})
out.update({f"r{i}": np.asarray(x) for i, x in enumerate(jax.tree.leaves(ex["ranges"]))})
np.savez(sys.argv[2], **out)
"""


# The dry-run cells of FAKE_CELLS as the production dry run measures a
# cell (`measure_cell`: fake tensors), on the debug mesh over a fake world
# of 8 ranks in one process.
_FAKE_WORLD = r"""
import json
from repro_torch.configs import registry
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import init_fake_world, make_debug_mesh
from repro_torch.models.config import ShapeConfig

init_fake_world(8, "cpu")
mesh = make_debug_mesh()
out = {}
for name, (arch, kind, seq, batch) in json.loads(sys.argv[2]).items():
    rec = dryrun.measure_cell(registry.get_smoke(arch), ShapeConfig(kind[0], kind, seq, batch), mesh, qat=True)
    out[name] = {k: rec[k] for k in ("flops_per_rank", "collective_bytes", "memory", "planner_ops")}
with open(sys.argv[1], "w") as f:
    json.dump(out, f)
"""


def _dbrx_inputs(path):
    """The dbrx train cell's arrays (`_torch_dist_cases.train_cell`'s), for
    the reference: the initial params and ranges, the first batch."""
    import dataclasses

    from repro_torch import tree
    from repro_torch.configs import registry
    from repro_torch.data.synthetic import DataConfig, DataIterator
    from repro_torch.models.config import ShapeConfig
    from repro_torch.train import step as TS

    cfg = dataclasses.replace(registry.get_smoke("dbrx_132b"), dtype="float32", qat=True, qat_delay=1)
    state = TS.init_state(0, cfg, device="cpu")
    batch = next(DataIterator(DataConfig(seed=0), cfg, ShapeConfig("t", "train", 256, 8), device="cpu"))
    arrays = {f"p{i}": t.numpy() for i, t in enumerate(tree.leaves(state.params))}
    arrays.update({f"r{i}": t.numpy() for i, t in enumerate(tree.leaves(state.ranges))})
    arrays.update({f"b_{k}": v.numpy() for k, v in batch.items()})
    np.savez(path, **arrays)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("dist_cells")
    _dbrx_inputs(work / "dbrx_in.npz")
    ref = D.start_reference(_REF_DBRX, work / "dbrx_in.npz", work / "dbrx_ref.npz")
    fake = D.start_reference(_FAKE_WORLD, work / "fake_world.json", json.dumps(FAKE_CELLS))
    try:
        port = D.run_ranks(8, work / "ranks", CASES)
    finally:
        D.wait_reference(ref)
        D.wait_reference(fake)
    return port, dict(np.load(work / "dbrx_ref.npz")), json.loads((work / "fake_world.json").read_text())


@pytest.fixture(scope="module")
def results(runs):
    return runs[:2]


@pytest.fixture(scope="module")
def fake_world(runs):
    return runs[2]


def _within(got, want, rel, abs_=None):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = float(np.max(np.abs(want))) if want.size else 0.0
    return float(np.max(np.abs(got - want))) <= rel * scale + (rel if abs_ is None else abs_)


def test_mesh_guards(results):
    r = D.result(results[0], "mesh_guards")
    assert "needs a world of 16 ranks, got 8" in r["bigger_mesh"]
    assert r["device_mesh"] == (2, 4)
    assert "no process group" in r["layout_runs"]
    # ("pod", "data") on the batch dim: Shard(0) on both, pod-major, as in JAX
    assert r["pod_placements"] == ["S(0)", "S(0)", "S(2)"]
    pod, data, model = r["pod_coord"]
    want = np.arange(128.0).reshape(8, 16)[(2 * pod + data) * 2:(2 * pod + data + 1) * 2, model * 8:(model + 1) * 8]
    np.testing.assert_array_equal(r["pod_local"], want)


def _check_train(r, what):
    (loss, dloss) = r["loss"]
    assert abs(dloss - loss) <= 2e-5 * abs(loss) + 2e-5, (what, loss, dloss)
    for i, (g, dg) in enumerate(zip(*r["grads"])):
        assert g.shape == dg.shape
        assert np.max(np.abs(dg - g)) <= 1e-4 * np.max(np.abs(g)) + 1e-6, (what, "grad leaf", i)
    rng, drng = r["ranges"]
    assert len(rng) == len(drng) and sum(np.array_equal(a, b) for a, b in zip(rng, drng)) >= 3  # the first sites
    for a, b in zip(rng, drng):
        assert _within(b, a, 2e-5), (what, a, b)
    for i, st in enumerate(r["steps"]):
        (l0, l1), (n0, n1), (q0, q1) = st["loss"], st["grad_norm"], st["quant_phase"]
        assert q0 == q1 == (1 if i >= 1 else 0)
        tol = 1e-4 * abs(l0) if q0 else 2e-5 * abs(l0) + 2e-5
        assert abs(l1 - l0) <= tol, (what, i, l0, l1)
        assert abs(n1 - n0) <= 1e-5 * abs(n0), (what, i, n0, n1)
        for j, (a, b) in enumerate(zip(*st["params"])):
            assert np.max(np.abs(b - a)) <= 2 * LR + QUANTUM, (what, i, j, np.max(np.abs(b - a)))
        for a, b in zip(*st["ranges"]):
            assert _within(b, a, 2e-5), (what, i)
        assert st["placements_kept"], what
    _check_optimizer(r["steps"], what)


def _check_optimizer(steps, what):
    """The optimizer's state after each step against the unsharded run's,
    and the params where both runs' updates were decided alike.

    Each step's clipped Q15.16 gradient g_c is read back from the moments:
    g_c = (mu_t − b1·mu_{t−1}) / (1 − b1).  The two runs' raw gradients
    meet the gradient contract (rel·max|g| + 1e-6, rel by phase), the
    Q15.16 rounding adds at most a quantum, the clip scales by s = min(1,
    1/‖g‖) and its norm agrees to 1e-5: so |Δg_c| ≤ δ = (rel + 2e-5)·
    max|g_c| + s·(1e-6 + (1 + rel)·quantum), and the moments' gaps grow as
    the moments do: Δmu_t ≤ b1·Δmu_{t−1} + (1 − b1)·δ_t, Δnu_t ≤
    b2·Δnu_{t−1} + (1 − b2)·(2·max|g_c|·δ_t + δ_t²), plus two float32 ulps.
    The count is exact.  Where the two runs' g_c agree within half a
    scaled quantum at every step so far, their Q15.16 gradients are the
    same and the updates differ by the clip's 1e-5 only: each step moves
    those params alike, to within one quantum of the weights' rounding."""
    prev = None
    for i, st in enumerate(steps):
        (c0, c1), (n0, _), (q0, _) = st["count"], st["grad_norm"], st["quant_phase"]
        assert c0 == c1 == i + 1, (what, i, c0, c1)
        scale = min(1.0, 1.0 / (n0 + 1e-12))
        rel = GRAD_REL[q0]
        mu, nu, params = st["mu"], st["nu"], st["params"]
        cur = []
        for j, ((m0, m1), (v0, v1), (p0, p1)) in enumerate(zip(zip(*mu), zip(*nu), zip(*params))):
            m0, m1, v0, v1 = (np.asarray(x, np.float64) for x in (m0, m1, v0, v1))
            pm0, pm1, bmu, bnu, agree, pp0, pp1 = prev[j] if prev else (0.0, 0.0, 0.0, 0.0, True, None, None)
            g0, g1 = (m0 - B1 * pm0) / (1 - B1), (m1 - B1 * pm1) / (1 - B1)
            gmax = float(np.max(np.abs(g0), initial=0.0))
            delta = (rel + 2e-5) * gmax + scale * (1e-6 + (1 + rel) * QUANTUM)
            bmu = B1 * bmu + (1 - B1) * delta
            bnu = B2 * bnu + (1 - B2) * (2 * gmax * delta + delta ** 2)
            ulps = 2.0 ** -22
            assert np.max(np.abs(m1 - m0), initial=0) <= bmu + ulps * np.max(np.abs(m0), initial=0), (what, i, j)
            assert np.max(np.abs(v1 - v0), initial=0) <= bnu + ulps * np.max(np.abs(v0), initial=0), (what, i, j)
            agree = agree & (np.abs(g1 - g0) <= 0.5 * scale * QUANTUM)
            step0, step1 = (p0 - pp0, p1 - pp1) if prev else (p0, p1)  # the first step: from the same params
            assert np.max(np.abs(step1 - step0)[agree], initial=0) <= QUANTUM, (what, i, j)
            cur.append((m0, m1, bmu, bnu, agree, p0, p1))
        share = sum(int(np.sum(c[4])) for c in cur) / sum(c[4].size for c in cur)
        assert share > 0.9, (what, i, share)  # the check above covers most params
        prev = cur


@pytest.mark.parametrize("cell", ["qwen2_train", "dbrx_train", "qwen2_train_multipod", "rwkv6_train",
                                  "recurrentgemma_train", "gemma3_train_data8"])
def test_train_cell_matches_unsharded(results, cell):
    r = D.result(results[0], cell)
    _check_train(r, cell)
    # gradients come back laid out as their params: no partial sum is left
    assert not any("Partial" in p for p in r["grad_placements"]), r["grad_placements"]


def _greedy_agrees(want, got, bound):
    """Greedy tokens equal, except where the top-2 margin lies inside the
    bound (reported)."""
    top2 = np.sort(want, -1)[..., -2:]
    close = (top2[..., 1] - top2[..., 0]) <= 2 * bound
    same = np.argmax(want, -1) == np.argmax(got, -1)
    return bool(np.all(same | close)), int(np.sum(~same))


def test_gemma3_prefill_matches_unsharded(results):
    r = D.result(results[0], "gemma3_prefill")
    want, got = r["logits"]
    assert got.shape == want.shape == (4, 512)
    assert _within(got, want, 2e-5)
    bound = 2e-5 * np.max(np.abs(want)) + 2e-5
    ok, flips = _greedy_agrees(want, got, bound)
    assert ok, flips


def test_head_dim_sharded_prefill_matches_unsharded(results):
    """gemma3's smoke config on a (1, 8) mesh: its 4 query heads and 1 kv
    head do not divide 8, its head_dim 16 does, so the serve rules shard
    the attention weights on head_dim, as the full config's (4 heads, 256)
    on the production mesh's model axis of 16 — the layout whose merged
    (heads, head_dim) matmul the attention projections compute per rank
    (`layers._heads_by_rank`, `_out_proj_by_rank`)."""
    r = D.result(results[0], "gemma3_prefill_model8")
    assert "Shard(dim=3)" in r["wq_placements"], r["wq_placements"]
    want, got = r["logits"]
    assert got.shape == want.shape == (4, 512)
    assert _within(got, want, 2e-5)
    ok, flips = _greedy_agrees(want, got, 2e-5 * np.max(np.abs(want)) + 2e-5)
    assert ok, flips


def _check_decode(r, n_logits):
    assert len(r["logits"]) == n_logits
    for want, got in r["logits"]:
        assert got.shape == want.shape
        assert _within(got, want, 2e-5)
        ok, flips = _greedy_agrees(want, got, 2e-5 * np.max(np.abs(want)) + 2e-5)
        assert ok, flips
    for a, b in zip(*r["cache"]):
        assert _within(b, a, 2e-5)


def test_rwkv6_decode_matches_unsharded(results):
    r = D.result(results[0], "rwkv6_decode")
    _check_decode(r, 3)
    # the recurrent states stay sharded (batch over data, state over model)
    assert any("Shard" in p for p in r["state_placements"]), r["state_placements"]


def test_recurrentgemma_decode_matches_unsharded(results):
    """recurrentgemma's smoke config (RG-LRU, RG-LRU, local attention): a
    16-token prefill and two decodes on the debug mesh.  The RG-LRU gate
    products contract the sharded state dim, so each partial sum is laid
    out on "state" before its sharded bias (`rglru._gates`), and the decode
    step lays its output out as the prompt path does."""
    r = D.result(results[0], "recurrentgemma_decode")
    _check_decode(r, 3)
    assert any("Shard" in p for p in r["state_placements"]), r["state_placements"]


def test_qwen2_sequence_parallel_decode_matches_unsharded(results):
    """B = 1 with the reference's long-context rules (`shard_kv_seq`): the
    KV cache, (layers, B, T, kv heads, head dim), is sharded along its
    sequence over "data" (and, the kv heads not dividing "model", along
    its head dim), and the prompt of 254 tokens and three decodes write
    slots on both sides of the split at 256 (each rank writes the slots
    of its piece)."""
    r = D.result(results[0], "qwen2_decode_kv_seq")
    _check_decode(r, 4)
    assert r["cache_placements"] and all(pl[0] == "S(2)" for pl in r["cache_placements"]), r["cache_placements"]


@pytest.mark.parametrize("cell,n_logits", [("gemma3_decode_data8", 3), ("rwkv6_decode_model8", 3),
                                           ("gemma3_decode_rows", 3), ("qwen2_decode_rows_kv_seq", 4)])
def test_layout_decode_matches_unsharded(results, cell, n_logits):
    """The layouts the reference runs and the port once stopped on: gemma3
    (one kv head) on the pure data-parallel (8, 1) mesh, its kv heads whole
    on each rank; rwkv6's 4 heads on (1, 8), its projections laid out on
    whole heads before the split; per-row decode positions on gemma3's
    batch-sharded cache (the debug mesh) and on qwen2's sequence-sharded
    one — a prefill and greedy decodes, each against unsharded."""
    r = D.result(results[0], cell)
    _check_decode(r, n_logits)
    if cell == "qwen2_decode_rows_kv_seq":
        assert all(pl[0] == "S(2)" for pl in r["cache_placements"]), r["cache_placements"]
    if cell == "gemma3_decode_rows":  # the batch over "data": (layers, B, ...) stacked, (B, ...) in the tail
        assert all(pl[0] in ("S(0)", "S(1)") for pl in r["cache_placements"]), r["cache_placements"]
        assert "S(0)" in {pl[0] for pl in r["cache_placements"]}, r["cache_placements"]


def test_dbrx_train_cell_matches_reference_on_a_mesh(results):
    """The dbrx train cell's first step on 8 ranks against the reference's
    on its debug mesh over 8 forced host devices, the same arrays (the
    parity tests' contracts: loss, gradients, ranges rtol 1e-4 / atol
    5e-5 with counts exact)."""
    port, ref = results
    r = D.result(port, "dbrx_train")
    loss = float(ref["loss"])
    assert abs(r["loss"][1] - loss) <= 2e-5 * abs(loss) + 2e-5, (r["loss"][1], loss)
    grads, ranges = r["grads"][1], r["ranges"][1]
    assert len(grads) == sum(k.startswith("g") for k in ref)
    assert len(ranges) == sum(k.startswith("r") for k in ref)
    for i, g in enumerate(grads):
        w = ref[f"g{i}"]
        assert g.shape == w.shape, i
        assert np.max(np.abs(g - w)) <= 1e-4 * np.max(np.abs(w)) + 1e-6, ("grad leaf", i)
    for i, x in enumerate(ranges):
        w = ref[f"r{i}"]
        assert x.dtype == w.dtype, i
        if w.dtype.kind == "i":
            np.testing.assert_array_equal(x, w, err_msg=f"range leaf {i}")
        else:
            np.testing.assert_allclose(x, w, rtol=1e-4, atol=5e-5, err_msg=f"range leaf {i}")


@pytest.mark.parametrize("cell", ["dry_qwen2_train", "dry_dbrx_train", "dry_rwkv6_decode", "dry_gemma3_prefill"])
def test_dryrun_cell_runs(results, cell):
    r = D.result(results[0], cell)
    assert r["status"] == "ok" and r["n_devices"] == 8
    assert r["flops"] > 0
    assert r["collective_bytes"] and all(v > 0 for v in r["collective_bytes"].values())
    assert r["memory"]["argument_bytes"] > 0 and r["memory"]["peak_bytes"] > 0


def test_dryrun_expert_parallel_collectives(results):
    r = D.result(results[0], "dry_dbrx_expert_parallel")
    assert r["status"] == "ok"
    assert {"all_gather", "all_reduce"} <= set(r["collective_bytes"]), r["collective_bytes"]


@pytest.mark.parametrize("cell", sorted(FAKE_CELLS))
def test_dryrun_measure_on_a_fake_world_matches_real_ranks(results, fake_world, cell):
    """The production dry run's measurement on a fake world of 8 under fake
    tensors against the same cell on the 8 real ranks (their second run:
    the per-device constants the layers cache exist by then; a fake run,
    which never caches them, makes and frees them within the step, so its
    peak may exceed the real one by their bytes, at most 64).  DTensor's
    sharding planner must be seen (`planner_ops`): its ops run at global
    shapes and are left out of the peak, and a planner no longer
    recognised would let them in."""
    real, fake = D.result(results[0], cell), fake_world[cell]
    assert fake["planner_ops"] > 0
    assert real["flops_per_rank"] == fake["flops_per_rank"] > 0
    assert real["collective_bytes"] == fake["collective_bytes"]
    for key in ("argument_bytes", "output_bytes"):
        assert real["memory"][key] == fake["memory"][key] > 0, key
    assert 0 <= fake["memory"]["peak_bytes"] - real["memory"]["peak_bytes"] <= 64
    assert real["memory"]["peak_bytes"] > real["memory"]["argument_bytes"]
