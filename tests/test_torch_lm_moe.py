"""Port parity: the MoE FFN's dense dispatch (`repro_torch.models.moe`)
against the JAX reference (`repro.models.moe`), on inputs made with numpy
from a seed and the reference's weights carried across by
`convert.lm_params_from_numpy`.

Contracts: `capacity()` exact over a grid of T, E, k; the routing — each
(token, choice) pair's expert, its slot in the expert's buffer and its
keep flag — bitwise, ties to the lower expert index as `lax.top_k` breaks
them; `moe_forward` in float32 within 2e-5·scale + 2e-5, both where
pairs are dropped past the capacity and where none are; the balance loss
within 2e-5; the QAT `expert_in` range over the whole (E, C, d) buffer,
the empty slots' zeros included (as the reference's).  The reference's
condition for its expert-parallel `shard_map` path raises.
"""

import dataclasses
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import registry as rreg
from repro.models import layers as RL
from repro.models import moe as RM
from repro.models import transformer as RT

from repro_torch import convert
from repro_torch.configs import registry as preg
from repro_torch.core import parallelism as ppar
from repro_torch.launch.mesh import mesh_context
from repro_torch.models import layers as PL
from repro_torch.models import moe as PM
from repro_torch.models import transformer as PT

MOE_ARCHS = ["dbrx_132b", "moonshot_v1_16b_a3b"]


def _cfgs(arch, **kw):
    rc = dataclasses.replace(rreg.get_smoke(arch), dtype="float32", **kw)
    pc = dataclasses.replace(preg.get_smoke(arch), dtype="float32", **kw)
    return rc, pc


def _weights(rc, seed=0):
    rp = RM.moe_init(jax.random.key(seed), rc)
    return rp, convert.lm_params_from_numpy(jax.tree.map(np.asarray, rp), device="cpu")


def _x(rc, b, s, seed=1, positive=False):
    x = np.random.default_rng(seed).normal(size=(b, s, rc.d_model)).astype(np.float32)
    if positive:
        x = np.abs(x) + 0.1
    return x


def _ref_routing(flat, router, cfg):
    """The reference's routing, as `_moe_forward_dense` computes it."""
    k, e = cfg.experts_per_token, cfg.n_experts
    t = flat.shape[0]
    probs = jax.nn.softmax((flat.astype(jnp.float32) @ router).astype(jnp.float32), -1)
    gate_vals, expert_idx = jax.lax.top_k(probs, k)
    oh = jax.nn.one_hot(expert_idx, e, dtype=jnp.int32).reshape(t * k, e)
    pos = RM._blocked_cumsum(oh) - oh
    pos_in_e = jnp.sum(pos * oh, axis=-1).reshape(t, k)
    return np.asarray(expert_idx), np.asarray(pos_in_e), np.asarray(pos_in_e < RM.capacity(t, cfg))


def _close(got, want, rel, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= rel * scale + rel, f"{what}: max |Δ| {err} > {rel}·{scale} + {rel}"


@pytest.mark.parametrize("e,k", [(4, 2), (8, 2), (16, 4), (64, 6), (64, 1)])
def test_capacity_matches_reference(e, k):
    rc, pc = _cfgs("dbrx_132b", n_experts=e, experts_per_token=k)
    for t, f in itertools.product((1, 2, 7, 8, 9, 64, 100, 1000, 1024, 4096, 65_536, 131_072), (1.0, 1.25, 2.0)):
        rcf, pcf = dataclasses.replace(rc, moe_capacity_factor=f), dataclasses.replace(pc, moe_capacity_factor=f)
        assert PM.capacity(t, pcf) == RM.capacity(t, rcf), (t, e, k, f)


@pytest.mark.parametrize("t", [1, 8, 64, 300])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_routing_positions_and_keep_bitwise(arch, t):
    rc, pc = _cfgs(arch)
    rp, pp = _weights(rc)
    flat = _x(rc, 1, t, seed=t)[0]
    experts, pos, keep = _ref_routing(jnp.asarray(flat), rp["router"], rc)
    r = PM.route(torch.from_numpy(flat), pp["router"], pc)
    np.testing.assert_array_equal(r["experts"].numpy(), experts)
    np.testing.assert_array_equal(r["pos"].numpy(), pos)
    np.testing.assert_array_equal(r["keep"].numpy(), keep)
    assert r["capacity"] == RM.capacity(t, rc)


def test_top_k_ties_go_to_the_lower_index():
    """Rows of many equal probabilities: the chosen experts are
    `lax.top_k`'s, the lower index first among ties."""
    rng = np.random.default_rng(3)
    probs = (rng.integers(0, 4, (256, 16)) / 4).astype(np.float32)  # ties in every row
    for k in (1, 2, 4, 6):
        vals, idx = PM.top_k(torch.from_numpy(probs), k)
        want_vals, want_idx = jax.lax.top_k(jnp.asarray(probs), k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
        np.testing.assert_array_equal(vals.numpy(), np.asarray(want_vals))


@pytest.mark.parametrize("drops", [False, True])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_forward_matches_reference(arch, drops):
    """Float32 output and balance loss.  With drops: 2 × 48 tokens at a
    capacity factor of 0.5, so experts overflow; without: 8 tokens, a
    capacity of 8 ≥ any expert's load."""
    rc, pc = _cfgs(arch, moe_capacity_factor=0.5) if drops else _cfgs(arch)
    rp, pp = _weights(rc)
    b, s = (2, 48) if drops else (1, 8)
    x = _x(rc, b, s)
    want, want_aux = RM.moe_forward(jnp.asarray(x), rp, rc, None, RL.LayerQAT(None, None))
    got, aux = PM.moe_forward(torch.from_numpy(x), pp, pc, None, PL.LayerQAT(None, None))
    r = PM.route(torch.from_numpy(x.reshape(b * s, -1)), pp["router"], pc)
    assert bool((~r["keep"]).any()) == drops
    _close(got.numpy(), want, 2e-5, f"{arch} drops={drops}")
    assert abs(float(aux) - float(want_aux)) <= 2e-5 * abs(float(want_aux)) + 2e-5


@pytest.mark.parametrize("quant_phase", [False, True])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_expert_in_range_includes_the_empty_slots(arch, quant_phase):
    """Positive tokens, so every filled slot is positive: the `expert_in`
    site's minimum is the empty slots' 0, on both sides; every site's range
    and the outputs (both QAT phases) match the reference's."""
    rc, pc = _cfgs(arch)
    rp, pp = _weights(rc)
    x = _x(rc, 1, 4, positive=True)
    r_stats = {k: v for k, v in jax.tree.map(lambda a: a[0], RL.init_site_ranges(RL.MOE_SITES, 1)).items()}
    p_stats = {k: PT._at(v, 0) for k, v in PL.init_site_ranges(PL.MOE_SITES, 1, device=torch.device("cpu")).items()}
    rq = RL.LayerQAT(r_stats, jnp.asarray(False))
    pq = PL.LayerQAT(p_stats, torch.tensor(False))
    RM.moe_forward(jnp.asarray(x), rp, rc, None, rq)
    PM.moe_forward(torch.from_numpy(x), pp, pc, None, pq)
    assert float(pq.collect()["expert_in"].a_min) == 0.0 == float(rq.collect()["expert_in"].a_min)
    assert float(pq.collect()["router_in"].a_min) > 0.0
    rq = RL.LayerQAT(rq.collect(), jnp.asarray(quant_phase))
    pq = PL.LayerQAT(pq.collect(), torch.tensor(quant_phase))
    want, _ = RM.moe_forward(jnp.asarray(x), rp, rc, None, rq)
    got, _ = PM.moe_forward(torch.from_numpy(x), pp, pc, None, pq)
    _close(got.numpy(), want, 1e-3, f"{arch} quant_phase={quant_phase}")
    for site in RL.MOE_SITES[2:]:
        for f in ("a_min", "a_max"):
            np.testing.assert_allclose(float(getattr(pq.collect()[site], f)), float(getattr(rq.collect()[site], f)),
                                       rtol=1e-4, atol=5e-5, err_msg=f"{site}.{f}")
        assert int(pq.collect()[site].count) == int(rq.collect()[site].count)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_forward_aux_loss_sums_the_layers_like_the_reference(arch):
    rc, pc = _cfgs(arch)
    rp = RT.init_params(jax.random.key(0), rc)
    pp = convert.lm_params_from_numpy(jax.tree.map(np.asarray, rp), device="cpu")
    toks = np.random.default_rng(2).integers(0, rc.vocab_size, (2, 16)).astype(np.int32)
    _, r_extras = RT.forward(rp, {"tokens": jnp.asarray(toks)}, rc)
    _, p_extras = PT.forward(pp, {"tokens": torch.from_numpy(toks)}, pc)
    want = float(r_extras["aux"])
    assert want > rc.n_layers * 0.5  # a sum over the layers (each ≥ ≈ 1 for balanced routing)
    assert abs(float(p_extras["aux"]) - want) <= 2e-5 * want + 2e-5


def test_moe_load_balance_loss_positive():
    """tests/test_archs.py's case on the port's own random weights."""
    cfg = preg.get_smoke("dbrx_132b")
    params = PT.init_params(0, cfg, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 64), generator=torch.Generator().manual_seed(1))
    _, extras = PT.forward(params, {"tokens": toks}, cfg)
    assert float(extras["aux"]) > 0.0


def test_sharded_dispatch_condition_raises():
    """Under a mesh with a "model" axis and T ≥ 65,536 the reference takes
    its shard_map path, and so does the port (`_moe_forward_sharded`): on a
    mesh of several devices with no process group behind it, a layout, it
    raises rather than run unsharded; on a one-device mesh the same body
    runs with no collectives and, QAT off, equals the dense dispatch (one
    batch shard: the same capacity and routing).  Below the threshold, or
    without rules, the dense path runs, as the reference's does."""
    _, pc = _cfgs("dbrx_132b")
    _, pp = _weights(_cfgs("dbrx_132b")[0])
    qat = PL.LayerQAT(None, None)
    big = torch.from_numpy(_x(pc, 1, PM.SHARDED_MIN_TOKENS))
    layout = ppar.Mesh((2, 4), ("data", "model"))
    with mesh_context(layout):
        with pytest.raises(RuntimeError, match="no process group"):
            PM.moe_forward(big, pp, pc, ppar.train_rules(layout), qat)
    mesh = ppar.Mesh((1, 1), ("data", "model"))
    rules = ppar.serve_rules(mesh)
    with mesh_context(mesh):
        got, aux = PM.moe_forward(big, pp, pc, rules, qat)
        x = torch.from_numpy(_x(pc, 1, 8))
        small, _ = PM.moe_forward(x, pp, pc, rules, qat)
    want, want_aux = PM._moe_forward_dense(big, pp, pc, None, qat)
    assert torch.equal(got, want) and torch.equal(aux, want_aux)
    assert torch.equal(small, PM.moe_forward(x, pp, pc, None, qat)[0])
    # no rules, or no mesh in scope: the dense path at any size
    y, _ = PM.moe_forward(torch.zeros((1, PM.SHARDED_MIN_TOKENS, pc.d_model)), pp, pc, rules, qat)
    assert y.shape == (1, PM.SHARDED_MIN_TOKENS, pc.d_model)


def test_dense_dispatch_reads_every_expert():
    """Decode (T = 1) runs every expert over its capacity buffer: the
    buffer is (E, C, d) with C = 8, one slot per chosen expert filled."""
    rc, pc = _cfgs("moonshot_v1_16b_a3b")
    _, pp = _weights(rc)
    r = PM.route(torch.from_numpy(_x(rc, 1, 1)[0]), pp["router"], pc)
    assert r["capacity"] == 8 and bool(r["keep"].all()) and r["experts"].shape == (1, pc.experts_per_token)
    assert len(set(r["experts"][0].tolist())) == pc.experts_per_token
