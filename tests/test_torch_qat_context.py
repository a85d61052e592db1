"""Port parity: `repro_torch.core.qat.QATContext` (and the range updates
behind it) against the JAX reference, bitwise, in both Algorithm-1 phases.

The same captured ranges and inputs (numpy, from a seed) go to both sides:
`site` (values, STE gradient and the new ranges), `observe` with the
"minmax" and "ema" monitors, `site_quant_params`, and `quantize_weights`.
Everything here is elementwise float32 or a min/max, so it must agree bit
for bit.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401  (one intra-op thread a worker)

import jax
import jax.numpy as jnp

from repro.core import qat as rqat
from repro.core import ranges as rranges

from repro_torch.core import qat as pqat
from repro_torch.core import ranges as pranges

SITES = ["a", "b", "c"]


def _states(step, delay, monitor, seed=0):
    """A reference QATState with captured ranges (one site never updated)
    and the same state in the port."""
    rng = np.random.default_rng(seed)
    r = rqat.QATState.init(delay=delay, sites=SITES, monitor=monitor)
    ranges = dict(r.ranges)
    for name in SITES[:2]:
        lo, hi = np.float32(-rng.uniform(0.5, 3)), np.float32(rng.uniform(0.5, 3))
        ranges[name] = rranges.RangeStat(jnp.float32(lo), jnp.float32(hi), jnp.int32(rng.integers(1, 9)))
    r = dataclasses.replace(r, ranges=ranges, step=jnp.int32(step))
    p = pqat.QATState(
        config=pqat.QATConfig(delay=delay, monitor=monitor),
        step=torch.tensor(step, dtype=torch.int32),
        ranges={
            k: pranges.RangeStat(torch.tensor(float(v.a_min)), torch.tensor(float(v.a_max)),
                                 torch.tensor(int(v.count), dtype=torch.int32))
            for k, v in ranges.items()
        },
    )
    return r, p


def _assert_ranges_equal(p_ranges, r_ranges):
    for k, v in r_ranges.items():
        got = p_ranges[k]
        for field in ("a_min", "a_max", "count"):
            np.testing.assert_array_equal(getattr(got, field).numpy(), np.asarray(getattr(v, field)), err_msg=f"{k}.{field}")


@pytest.mark.parametrize("monitor", ["minmax", "ema"])
@pytest.mark.parametrize("phase", ["monitor", "quant"])
def test_site_matches_reference(phase, monitor):
    r_state, p_state = _states(step=5 if phase == "quant" else 2, delay=4, monitor=monitor)
    rng = np.random.default_rng(1)
    xs = {name: (rng.normal(size=(9, 6)) * 2).astype(np.float32) for name in SITES}
    c = rng.normal(size=(9, 6)).astype(np.float32)

    def ref(xs):
        ctx = rqat.QATContext(r_state)
        ys = {n: ctx.site(n, x) for n, x in xs.items()}
        return sum(jnp.sum(y * c) for y in ys.values()), (ys, ctx.finalize().ranges)

    (_, (want_y, want_ranges)), want_g = jax.value_and_grad(ref, has_aux=True)({k: jnp.asarray(v) for k, v in xs.items()})
    ctx = pqat.QATContext(p_state)
    txs = {k: torch.from_numpy(v).requires_grad_(True) for k, v in xs.items()}
    ys = {n: ctx.site(n, x) for n, x in txs.items()}
    sum((y * torch.from_numpy(c)).sum() for y in ys.values()).backward()
    assert ctx.quant == (phase == "quant")
    for n in SITES:
        np.testing.assert_array_equal(ys[n].detach().numpy(), np.asarray(want_y[n]), err_msg=n)
        np.testing.assert_array_equal(txs[n].grad.numpy(), np.asarray(want_g[n]), err_msg=f"grad {n}")
    _assert_ranges_equal(ctx.finalize().ranges, want_ranges)


@pytest.mark.parametrize("monitor", ["minmax", "ema"])
@pytest.mark.parametrize("phase", ["monitor", "quant"])
def test_observe_and_quant_params_match_reference(phase, monitor):
    r_state, p_state = _states(step=9 if phase == "quant" else 0, delay=3, monitor=monitor, seed=2)
    rng = np.random.default_rng(3)
    r_ctx, p_ctx = rqat.QATContext(r_state), pqat.QATContext(p_state)
    for _ in range(3):
        for name in SITES:
            mn, mx = np.float32(rng.normal() - 2), np.float32(rng.normal() + 2)
            r_ctx.observe(name, jnp.float32(mn), jnp.float32(mx))
            p_ctx.observe(name, torch.tensor(mn), torch.tensor(mx))
    _assert_ranges_equal(p_ctx.finalize().ranges, r_ctx.finalize().ranges)
    got = p_ctx.site_quant_params(SITES)
    want = r_ctx.site_quant_params(SITES)
    for g, w, name in zip(got, want, ("deltas", "zs")):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


@pytest.mark.parametrize("monitor", ["minmax", "ema"])
def test_range_updates_match_reference(monitor):
    rng = np.random.default_rng(4)
    r_stat, p_stat = rranges.RangeStat.init(), pranges.RangeStat.init("cpu")
    for _ in range(5):
        x = (rng.normal(size=(7, 5)) * 3).astype(np.float32)
        if monitor == "minmax":
            r_stat, p_stat = rranges.update_minmax(r_stat, jnp.asarray(x)), pranges.update_minmax(p_stat, torch.from_numpy(x))
        else:
            r_stat, p_stat = rranges.update_ema(r_stat, jnp.asarray(x)), pranges.update_ema(p_stat, torch.from_numpy(x))
        _assert_ranges_equal({"s": p_stat}, {"s": r_stat})


def test_disabled_context_is_a_pass_through():
    _, p_state = _states(step=0, delay=0, monitor="minmax")
    p_state = dataclasses.replace(p_state, config=pqat.QATConfig(enabled=False))
    ctx = pqat.QATContext(p_state)
    x = torch.randn(3, 4)
    assert ctx.site("a", x) is x
    ctx.observe("a", torch.tensor(-9.0), torch.tensor(9.0))
    _assert_ranges_equal(ctx.finalize().ranges, {k: v for k, v in p_state.ranges.items()})
    with pytest.raises(KeyError, match="not registered"):
        pqat.QATContext(dataclasses.replace(p_state, config=pqat.QATConfig())).site("nope", x)


def test_quantize_weights_and_grads_match_reference():
    rng = np.random.default_rng(5)
    tree = {"l0": {"w": rng.normal(size=(4, 3)).astype(np.float32), "b": rng.normal(size=(3,)).astype(np.float32)}}
    want = rqat.quantize_grads(jax.tree.map(jnp.asarray, tree))
    got = pqat.quantize_grads({k: {n: torch.from_numpy(v) for n, v in layer.items()} for k, layer in tree.items()})
    for n in ("w", "b"):
        np.testing.assert_array_equal(got["l0"][n].numpy(), np.asarray(want["l0"][n]))
    assert pqat.quantize_weights(tree, enabled=False) is tree
