"""The port's expert-parallel MoE dispatch on 8 CPU ranks (data 2 × model 4)
against the reference's `_moe_forward_sharded` on 8 forced host devices.

The two sides run at once: a subprocess with 8 forced XLA host devices
runs the reference's shard_map body on a (2, 4) mesh with QAT on (jitted
once, the phase an argument) in both phases, and writes y, the balance
loss, the sites' ranges and each data shard's routing to an .npz; meanwhile one spawn of 8 gloo ranks runs the
port's body on the same arrays (`_torch_dist_cases.moe_body`).  The port
must match: routing (experts, slots, keep) exact, y within 2e-5·scale +
2e-5, the balance loss within 2e-5, the token-stream sites' ranges
bitwise, and the folded "expert_down_in" range within 2e-6 relative — its
min / max fold over the ranks is exact, but the hidden activations it
reads come out of the expert products, which XLA and PyTorch's CPU kernels
sum in different orders (measured against the reference's jitted body:
two float32 ulps apart in the monitor phase, bitwise in the quant phase).

Also on the ranks: `moe_forward` at 65,536 tokens of the narrow dbrx
smoke config takes the expert-parallel path (bitwise the body called
directly; its collectives: the weights' all-gather over "data", the
combine's all-reduce over "model"; against the unsharded dense dispatch
within 2e-5·scale + 2e-5 on every token whose keep flags the per-shard
and the global capacity agree on), and the body's gradients (QAT off)
equal those of the plain computation of its semantics — the dense
dispatch on each data shard with the balance losses averaged — each leaf
within 1e-4·max|g| + 1e-6.  Given plain tensors on a live mesh of several
ranks, the selected expert-parallel path raises, naming `distribute_tree`,
rather than run the whole token stream under one shard's capacity.
"""

import numpy as np
import pytest

pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401  (one intra-op thread a worker)

import _torch_dist as D

ARCH, BATCH, SEQ = "dbrx_132b", 8, 32

_REF = r"""
import dataclasses
import numpy as np
import jax, jax.numpy as jnp
from repro.configs import registry
from repro.core.parallelism import train_rules
from repro.core.ranges import RangeStat
from repro.launch.mesh import make_debug_mesh, mesh_context
from repro.models import layers as RL, moe as RM

inp = np.load(sys.argv[1])
cfg = dataclasses.replace(registry.get_smoke(sys.argv[3]), dtype="float32")
mesh = make_debug_mesh()
rules = train_rules(mesh)
x = jnp.asarray(inp["x"])
p = {k: jnp.asarray(inp[k]) for k in ("router", "wg", "wu", "wd")}
stats = lambda sites: {s: RangeStat(jnp.float32(-2.0), jnp.float32(2.0), jnp.int32(1)) for s in sites}
out = {}
n = mesh.shape["data"]
c_local = RM.capacity(x.shape[0] * x.shape[1] // n, cfg)


@jax.jit  # one compile for both phases
def body(x, p, phase):
    qat = RL.LayerQAT(stats(("router_in", "expert_in", "expert_down_in")), phase)
    y, aux = RM._moe_forward_sharded(x, p, cfg, rules, qat, mesh)
    return y, aux, qat.collect()


for phase in (0, 1):
    with mesh_context(mesh):
        y, aux, collected = body(x, p, jnp.asarray(bool(phase)))
    out[f"y{phase}"], out[f"aux{phase}"] = np.asarray(y), np.asarray(aux)
    for s, st in collected.items():
        out[f"{s}{phase}"] = np.array([st.a_min, st.a_max, st.count], np.float64)
    q = RL.LayerQAT(stats(("router_in", "expert_in")), jnp.asarray(bool(phase)))
    xq = q.site("expert_in", q.site("router_in", x))
    for i, xs in enumerate(jnp.split(xq, n, 0)):
        flat = xs.reshape(-1, cfg.d_model)
        probs = jax.nn.softmax((flat.astype(jnp.float32) @ p["router"]).astype(jnp.float32), -1)
        _, idx = jax.lax.top_k(probs, cfg.experts_per_token)
        oh = jax.nn.one_hot(idx, cfg.n_experts, dtype=jnp.int32).reshape(-1, cfg.n_experts)
        pos = RM._blocked_cumsum(oh, n_blocks=256) - oh
        pos_in_e = jnp.sum(pos * oh, -1).reshape(flat.shape[0], -1)
        out[f"experts{phase}_{i}"] = np.asarray(idx)
        out[f"pos{phase}_{i}"] = np.asarray(pos_in_e)
        out[f"keep{phase}_{i}"] = np.asarray(pos_in_e < c_local)
np.savez(sys.argv[2], **out)
"""

CASES = [
    ("body_monitor", "_torch_dist_cases:moe_body", {"arch": ARCH, "batch": BATCH, "seq": SEQ, "quant_phase": False}),
    ("body_quant", "_torch_dist_cases:moe_body", {"arch": ARCH, "batch": BATCH, "seq": SEQ, "quant_phase": True}),
    ("grads", "_torch_dist_cases:moe_grads", {}),
    ("selected", "_torch_dist_cases:moe_selected", {}),
    ("plain_input", "_torch_dist_cases:moe_plain_input", {}),
]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    import dataclasses

    import _torch_dist_cases as C
    from repro_torch.configs import registry

    work = tmp_path_factory.mktemp("dist_moe")
    cfg = dataclasses.replace(registry.get_smoke(ARCH), dtype="float32")
    x, p = C.moe_inputs(cfg, BATCH, SEQ)
    np.savez(work / "in.npz", x=x, **p)
    ref = D.start_reference(_REF, work / "in.npz", work / "ref.npz", ARCH)
    try:
        port = D.run_ranks(8, work / "ranks", CASES)
    finally:
        D.wait_reference(ref)
    return port, dict(np.load(work / "ref.npz"))


@pytest.mark.parametrize("phase", [0, 1], ids=["monitor", "quant"])
def test_body_matches_reference_shard_map(results, phase):
    port, ref = results
    r = D.result(port, ["body_monitor", "body_quant"][phase])
    for i, got in enumerate(r["routing"]):
        np.testing.assert_array_equal(got["experts"], ref[f"experts{phase}_{i}"])
        np.testing.assert_array_equal(got["pos"], ref[f"pos{phase}_{i}"])
        np.testing.assert_array_equal(got["keep"], ref[f"keep{phase}_{i}"])
    want = ref[f"y{phase}"]
    assert r["y"].shape == want.shape
    assert np.max(np.abs(r["y"] - want)) <= 2e-5 * np.max(np.abs(want)) + 2e-5
    assert abs(r["aux"] - float(ref[f"aux{phase}"])) <= 2e-5
    for site in ("router_in", "expert_in"):
        got = np.array(r["stats"][site], np.float64)
        np.testing.assert_array_equal(got.astype(np.float32), ref[f"{site}{phase}"].astype(np.float32), err_msg=site)
    got, want = np.array(r["stats"]["expert_down_in"]), ref[f"expert_down_in{phase}"]
    assert got[2] == want[2]  # the fold happened once
    np.testing.assert_allclose(got[:2], want[:2], rtol=2e-6, atol=0)


def test_body_gradients_match_plain_semantics(results):
    port, _ = results
    r = D.result(port, "grads")
    (lw, lg), (yw, yg), (aw, ag) = r["loss"], r["y"], r["aux"]
    assert abs(lg - lw) <= 2e-5 * abs(lw) + 2e-5
    assert np.max(np.abs(yg - yw)) <= 2e-5 * np.max(np.abs(yw)) + 2e-5
    assert abs(ag - aw) <= 2e-5
    for name, want, got in zip(r["names"], *r["grads"]):
        assert got.shape == want.shape, name
        assert np.max(np.abs(got - want)) <= 1e-4 * np.max(np.abs(want)) + 1e-6, name


def test_moe_forward_selects_the_expert_parallel_path(results):
    port, _ = results
    r = D.result(port, "selected")
    np.testing.assert_array_equal(r["y"], r["y_body"])
    assert {"all_gather_into_tensor", "all_reduce"} <= set(r["counts"]), r["counts"]
    same = r["same_keep"].reshape(r["want"].shape[:2])
    assert same.mean() > 0.5, same.mean()  # most tokens route the same under both capacities
    want, got = r["want"][same], r["y"][same]
    assert np.max(np.abs(got - want)) <= 2e-5 * np.max(np.abs(r["want"])) + 2e-5


@pytest.mark.parametrize("mesh", [(2, 4), (8, 1)], ids=["data2_model4", "data8_model1"])
def test_plain_input_on_a_live_mesh_raises(results, mesh):
    port, _ = results
    msg = D.result(port, "plain_input")[mesh]
    assert "distribute_tree" in msg and "plain tensor" in msg, msg
