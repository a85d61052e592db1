"""Port parity: the recurrent blocks — RWKV-6 (`repro_torch.models.rwkv6`)
and RG-LRU (`repro_torch.models.rglru`), with `layers.group_norm_heads` —
against the JAX reference, on inputs made with numpy from a seed and the
reference's weights carried across by `convert.lm_params_from_numpy`.

Contracts: float32 outputs and states within 2e-5·scale + 2e-5 (the same
arithmetic in another sum or scan order: the RG-LRU scan is a doubling
scan here, `lax.associative_scan` there); every function with a carried,
nonzero state.  The RWKV-6 chunk rule (S ≤ 128 or a multiple of 128)
raises on both sides.  The states stay float32 under a bf16 compute dtype,
through `init_cache`, a prefill, a decode step and `lm_cache_from_numpy`.
The blocks write their new state into the state tensors they are given
(the per-layer caches are views of the stacked tree).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401  (one intra-op thread a worker)

import jax
import jax.numpy as jnp

from repro.configs import registry as rreg
from repro.models import layers as RL
from repro.models import rglru as RG
from repro.models import rwkv6 as RW
from repro.models import transformer as RT

from repro_torch import convert
from repro_torch.configs import registry as preg
from repro_torch.models import layers as PL
from repro_torch.models import rglru as PG
from repro_torch.models import rwkv6 as PW
from repro_torch.models import transformer as PT

TOL = 2e-5


def _close(got, want, rel=TOL, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= rel * scale + rel, f"{what}: max |Δ| {err} > {rel}·{scale} + {rel}"


def _cfgs(arch, **kw):
    return (dataclasses.replace(rreg.get_smoke(arch), dtype="float32", **kw),
            dataclasses.replace(preg.get_smoke(arch), dtype="float32", **kw))


def _rng(seed):
    return np.random.default_rng(seed)


def _normal(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _no_qat():
    return RL.LayerQAT(None, None), PL.LayerQAT(None, None)


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


# ---------------------------------------------------------------------------
# RWKV-6
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("heads,hd", [(4, 16), (2, 64), (32, 64)])
def test_group_norm_heads_matches_reference(heads, hd):
    rng = _rng(heads)
    x = _normal(rng, 3, 5, heads * hd, scale=3.0) + 1.0
    scale, bias = _normal(rng, heads * hd), _normal(rng, heads * hd)
    want = RL.group_norm_heads(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), heads)
    got = PL.group_norm_heads(torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(bias), heads)
    _close(got.numpy(), want, 1e-6, "group norm")
    xb = torch.from_numpy(x).to(torch.bfloat16)
    assert PL.group_norm_heads(xb, torch.from_numpy(scale), torch.from_numpy(bias), heads).dtype == torch.bfloat16


def _rwkv(seed=0, **kw):
    rc, pc = _cfgs("rwkv6_1_6b", **kw)
    rp = RW.rwkv_init(jax.random.key(seed), rc)
    rng = _rng(seed + 10)
    # nonzero bonus and base mixes, so every term of the chunk form counts
    rp = dict(rp, u=jnp.asarray(_normal(rng, *rp["u"].shape, scale=0.5)),
              tm_base=jnp.asarray(_normal(rng, *rp["tm_base"].shape, scale=0.3)))
    return rc, pc, rp, convert.lm_params_from_numpy(jax.tree.map(np.asarray, rp), device="cpu")


def _rwkv_state(rc, b, seed):
    rng = _rng(seed)
    h, n = rc.d_model // rc.rwkv_head_dim, rc.rwkv_head_dim
    return {"wkv": _normal(rng, b, h, n, n, scale=0.5), "x_tm": _normal(rng, b, rc.d_model),
            "x_cm": _normal(rng, b, rc.d_model)}


@pytest.mark.parametrize("c", [1, 16, 128])
def test_wkv_chunk_matches_reference(c):
    rng = _rng(c)
    b, h, n = 2, 3, 16
    r, k, v = (_normal(rng, b, c, h, n) for _ in range(3))
    logw = -np.exp(_normal(rng, b, c, h, n, scale=0.5) - 3.0).astype(np.float32)
    u, s0 = _normal(rng, h, n), _normal(rng, b, h, n, n)
    want_o, want_s = RW._wkv_chunk(*(jnp.asarray(a) for a in (r, k, v, logw, u, s0)))
    got_o, got_s = PW._wkv_chunk(*(torch.from_numpy(a) for a in (r, k, v, logw, u, s0)))
    _close(got_o.numpy(), want_o, what="o")
    _close(got_s.numpy(), want_s, what="state")


@pytest.mark.parametrize("s", [1, 7, 128, 256])
def test_time_and_channel_mix_match_reference_with_a_carried_state(s):
    """S = 256: two chunks, the state carried across the chunk edge."""
    rc, pc, rp, pp = _rwkv()
    x = _normal(_rng(s), 2, s, rc.d_model)
    st = _rwkv_state(rc, 2, seed=s + 1)
    rq, pq = _no_qat()
    want_y, want_st = RW.time_mix(jnp.asarray(x), rp, rc, {k: jnp.asarray(v) for k, v in st.items()}, None, rq)
    state = _t(st)
    got_y, got_st = PW.time_mix(torch.from_numpy(x), pp, pc, state, None, pq)
    assert got_st is state  # written in place
    _close(got_y.numpy(), want_y, what="time_mix y")
    for name in ("wkv", "x_tm", "x_cm"):
        _close(state[name].numpy(), want_st[name], what=f"time_mix {name}")
    want_y, want_st = RW.channel_mix(jnp.asarray(x), rp, rc, want_st, None, rq)
    got_y, _ = PW.channel_mix(torch.from_numpy(x), pp, pc, state, None, pq)
    _close(got_y.numpy(), want_y, what="channel_mix y")
    for name in ("wkv", "x_tm", "x_cm"):
        _close(state[name].numpy(), want_st[name], what=f"channel_mix {name}")


@pytest.mark.parametrize("which", ["tmix", "cmix"])
def test_rwkv_decode_step_matches_reference_with_a_carried_state(which):
    rc, pc, rp, pp = _rwkv(seed=1)
    x = _normal(_rng(5), 3, 1, rc.d_model)
    st = _rwkv_state(rc, 3, seed=6)
    rq, pq = _no_qat()
    want_y, want_st = RW.decode_step(jnp.asarray(x), rp, rc, {k: jnp.asarray(v) for k, v in st.items()}, None, rq,
                                     which)
    state = _t(st)
    got_y, got_st = PW.decode_step(torch.from_numpy(x), pp, pc, state, None, pq, which)
    assert got_st is state
    _close(got_y.numpy(), want_y, what=f"{which} y")
    for name in ("wkv", "x_tm", "x_cm"):
        _close(state[name].numpy(), want_st[name], what=f"{which} {name}")


def test_rwkv_decode_continues_the_chunked_forward():
    """The O(1) recurrence from the state a 256-token (two-chunk) time-mix
    leaves, against the reference on the same steps."""
    rc, pc, rp, pp = _rwkv(seed=2)
    x = _normal(_rng(7), 1, 260, rc.d_model)
    rq, pq = _no_qat()
    r_st = {k: jnp.asarray(v) for k, v in _rwkv_state(rc, 1, 8).items()}
    state = _t(_rwkv_state(rc, 1, 8))
    _, r_st = RW.time_mix(jnp.asarray(x[:, :256]), rp, rc, r_st, None, rq)
    PW.time_mix(torch.from_numpy(x[:, :256]), pp, pc, state, None, pq)
    for i in range(256, 260):
        want, r_st = RW.decode_step(jnp.asarray(x[:, i:i + 1]), rp, rc, r_st, None, rq, "tmix")
        got, _ = PW.decode_step(torch.from_numpy(x[:, i:i + 1]), pp, pc, state, None, pq, "tmix")
        _close(got.numpy(), want, what=f"step {i}")
    _close(state["wkv"].numpy(), r_st["wkv"], what="wkv")


@pytest.mark.parametrize("s", [129, 200, 300])
def test_rwkv_chunk_rule_raises_on_both_sides(s):
    """A sequence longer than the chunk must be a multiple of it: the
    reference asserts, the port raises; nothing is padded."""
    rc, pc, rp, pp = _rwkv()
    x = _normal(_rng(0), 1, s, rc.d_model)
    rq, pq = _no_qat()
    with pytest.raises(AssertionError, match="not divisible by chunk"):
        RW.time_mix(jnp.asarray(x), rp, rc, {k: jnp.asarray(v) for k, v in _rwkv_state(rc, 1, 0).items()}, None, rq)
    state = _t(_rwkv_state(rc, 1, 0))
    before = {k: v.clone() for k, v in state.items()}
    with pytest.raises(ValueError, match="not divisible by chunk"):
        PW.time_mix(torch.from_numpy(x), pp, pc, state, None, pq)
    assert all(torch.equal(state[k], before[k]) for k in state)  # the state is left as it was
    cfg = preg.get_smoke("rwkv6_1_6b")
    params = PT.init_params(0, cfg, device="cpu")
    with pytest.raises(ValueError, match="not divisible by chunk"):
        PT.prefill(params, {"tokens": torch.zeros((1, s), dtype=torch.int32)}, cfg,
                   cache=PT.init_cache(cfg, 1, s + 4, device="cpu"))


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------


def _rglru(seed=0):
    rc, pc = _cfgs("recurrentgemma_2b")
    rp = RG.rglru_init(jax.random.key(seed), rc)
    rng = _rng(seed + 20)
    rp = dict(rp, ba=jnp.asarray(_normal(rng, *rp["ba"].shape, scale=0.5)),
              conv_b=jnp.asarray(_normal(rng, *rp["conv_b"].shape, scale=0.1)))
    return rc, pc, rp, convert.lm_params_from_numpy(jax.tree.map(np.asarray, rp), device="cpu")


def _rglru_state(rc, b, seed):
    rng = _rng(seed)
    r = rc.rnn_state_dim or rc.d_model
    return {"h": _normal(rng, b, r), "conv": _normal(rng, b, rc.conv1d_width - 1, r)}


@pytest.mark.parametrize("s", [1, 2, 3, 37, 128, 1024])
def test_linear_scan_matches_associative_scan_with_a_carried_h(s):
    rng = _rng(s)
    a = rng.uniform(0.5, 1.0, (2, s, 16)).astype(np.float32)
    b = _normal(rng, 2, s, 16)
    h0 = _normal(rng, 2, 16)
    b_seeded = b.copy()
    b_seeded[:, 0] += a[:, 0] * h0

    def op(c1, c2):
        return c1[0] * c2[0], c2[0] * c1[1] + c2[1]

    _, want = jax.lax.associative_scan(op, (jnp.asarray(a), jnp.asarray(b_seeded)), axis=1)
    got = PG.linear_scan(torch.from_numpy(a), torch.from_numpy(b_seeded))
    _close(got.numpy(), want, what=f"scan S={s}")
    seq = np.empty_like(b)  # and against the plain recurrence in float64
    h = h0.astype(np.float64)
    for t in range(s):
        h = a[:, t] * h + b[:, t]
        seq[:, t] = h
    _close(got.numpy(), seq, what=f"recurrence S={s}")


def test_gates_match_reference():
    """a and the gated input in float32; the square root correctly rounded
    (`numerics.sqrt_rn`, the reference's XLA sqrt)."""
    rc, pc, rp, pp = _rglru()
    xc = _normal(_rng(3), 2, 9, rc.rnn_state_dim, scale=2.0)
    want_a, want_g = RG._gates(jnp.asarray(xc), rp)
    got_a, got_g = PG._gates(torch.from_numpy(xc), pp)
    _close(got_a.numpy(), want_a, 1e-6, "a")
    _close(got_g.numpy(), want_g, 1e-6, "gated input")
    assert torch.equal(PG._softplus(pp["lam"]), torch.logaddexp(pp["lam"], torch.zeros_like(pp["lam"])))


@pytest.mark.parametrize("s", [1, 3, 37, 128])
def test_rglru_forward_matches_reference_with_a_carried_state(s):
    rc, pc, rp, pp = _rglru()
    x = _normal(_rng(s), 2, s, rc.d_model)
    st = _rglru_state(rc, 2, seed=s + 1)
    rq, pq = _no_qat()
    want_y, want_st = RG.rglru_forward(jnp.asarray(x), rp, rc, {k: jnp.asarray(v) for k, v in st.items()}, None, rq)
    state = _t(st)
    got_y, got_st = PG.rglru_forward(torch.from_numpy(x), pp, pc, state, None, pq)
    assert got_st is state
    _close(got_y.numpy(), want_y, what="y")
    for name in ("h", "conv"):
        _close(state[name].numpy(), want_st[name], what=name)


def test_rglru_decode_step_matches_reference_with_a_carried_state():
    rc, pc, rp, pp = _rglru(seed=1)
    st = _rglru_state(rc, 3, seed=4)
    r_st = {k: jnp.asarray(v) for k, v in st.items()}
    state = _t(st)
    rq, pq = _no_qat()
    for i in range(5):  # the conv history shifts through its whole width
        x = _normal(_rng(10 + i), 3, 1, rc.d_model)
        want, r_st = RG.decode_step(jnp.asarray(x), rp, rc, r_st, None, rq)
        got, got_st = PG.decode_step(torch.from_numpy(x), pp, pc, state, None, pq)
        assert got_st is state
        _close(got.numpy(), want, what=f"step {i}")
        for name in ("h", "conv"):
            _close(state[name].numpy(), r_st[name], what=f"step {i} {name}")


# ---------------------------------------------------------------------------
# the states through the model, in bf16
# ---------------------------------------------------------------------------

RECURRENT = ["recurrentgemma_2b", "rwkv6_1_6b"]
STATE_LEAVES = {"recurrentgemma_2b": ("h", "conv"), "rwkv6_1_6b": ("wkv", "x_tm", "x_cm")}


def _state_leaves(cache, arch):
    return [slot[n] for slot in cache["scan"] + cache["tail"] for n in STATE_LEAVES[arch] if n in slot]


@pytest.mark.parametrize("arch", RECURRENT)
def test_states_stay_float32_under_bf16(arch):
    """init_cache, a prefill and a decode step keep the recurrent states
    float32 (K/V of recurrentgemma's local layers in bf16), written in
    place into the cache given."""
    cfg = preg.get_smoke(arch)
    assert cfg.compute_dtype == torch.bfloat16
    params = PT.serving_params(PT.init_params(0, cfg, device="cpu"), cfg)
    cache = PT.init_cache(cfg, 2, 24, device="cpu")
    leaves = _state_leaves(cache, arch)
    assert leaves and all(t.dtype == torch.float32 for t in leaves)
    assert all(slot[n].dtype == torch.bfloat16 for slot in cache["scan"] for n in ("k", "v") if n in slot)
    toks = torch.randint(0, cfg.vocab_size, (2, 16), generator=torch.Generator().manual_seed(3))
    _, out = PT.prefill(params, {"tokens": toks}, cfg, cache=cache)
    assert out is cache and all(a is b for a, b in zip(_state_leaves(out, arch), leaves))
    assert all(t.dtype == torch.float32 and float(t.abs().max()) > 0 for t in leaves)  # filled
    before = [t.clone() for t in leaves]
    PT.decode_step(params, toks[:, :1], cache, 16, cfg)
    assert all(t.dtype == torch.float32 for t in _state_leaves(cache, arch))
    assert all(not torch.equal(a, b) for a, b in zip(before, leaves))  # moved in place


@pytest.mark.parametrize("arch", RECURRENT)
def test_lm_cache_from_numpy_keeps_the_states_float32(arch):
    """The reference's bf16-config cache after a prefill: its float32
    states cross bitwise as float32, its K/V as bf16."""
    rc, pc = rreg.get_smoke(arch), preg.get_smoke(arch)
    rp = RT.init_params(jax.random.key(0), rc)
    toks = np.random.default_rng(4).integers(0, rc.vocab_size, (2, 16)).astype(np.int32)
    _, r_cache = RT.prefill(rp, {"tokens": jnp.asarray(toks)}, rc, cache=RT.init_cache(rc, 2, 24))
    r_np = jax.tree.map(np.asarray, r_cache)
    back = convert.lm_cache_from_numpy(r_np, pc, device="cpu")
    for part in ("scan", "tail"):
        for got_slot, want_slot in zip(back[part], r_np[part]):
            for name, want in want_slot.items():
                got = got_slot[name]
                if name in ("k", "v"):
                    assert got.dtype == torch.bfloat16
                    np.testing.assert_array_equal(got.float().numpy(), want.astype(np.float32))
                else:
                    assert want.dtype == np.float32 and got.dtype == torch.float32, name
                    np.testing.assert_array_equal(got.numpy(), want)
    round_trip = convert.lm_cache_to_numpy(back)
    assert all(a.dtype == np.float32 for slot in round_trip["scan"] for n, a in slot.items() if n not in ("k", "v"))


@pytest.mark.parametrize("arch", RECURRENT)
def test_prefill_then_decode_matches_reference(arch):
    """A prefill fills the states; decode continues at pos = S: logits of
    three steps and the final states against the reference's."""
    rc, pc = _cfgs(arch)
    rp = RT.init_params(jax.random.key(1), rc)
    pp = convert.lm_params_from_numpy(jax.tree.map(np.asarray, rp), device="cpu")
    toks = np.random.default_rng(5).integers(0, rc.vocab_size, (2, 43)).astype(np.int32)
    r_last, r_cache = RT.prefill(rp, {"tokens": jnp.asarray(toks[:, :40])}, rc, cache=RT.init_cache(rc, 2, 48))
    last, cache = PT.prefill(pp, {"tokens": torch.from_numpy(toks[:, :40])}, pc,
                             cache=PT.init_cache(pc, 2, 48, device="cpu"))
    _close(last.numpy(), r_last, what="prefill")
    for i in range(40, 43):
        want, r_cache = RT.decode_step(rp, jnp.asarray(toks[:, i:i + 1]), r_cache, jnp.int32(i), rc)
        got, cache = PT.decode_step(pp, torch.from_numpy(toks[:, i:i + 1]), cache, i, pc)
        _close(got.numpy(), want, what=f"decode {i}")
    want_leaves = _state_leaves(jax.tree.map(np.asarray, r_cache), arch)
    for got, want in zip(_state_leaves(cache, arch), want_leaves):
        _close(got.numpy(), want, what="state")
