"""Port parity: the LM zoo's layers (`repro_torch.models.layers`) against the
JAX reference's (`repro.models.layers`), on the same float32 inputs drawn
from numpy.

Tolerances (float32): products and reductions may sum in another order,
so norms, the MLP, masked attention and the QAT sites' inputs are held at
rtol = atol = 2e-5 — the reference's own contract for banded against
full attention (tests/kernels/test_attention.py).  RoPE: the frequency
table is a float32 `pow` (held within one ulp of the reference's) and the
rotation a float32 cos/sin, whose ulps XLA's and libm's may place apart;
an ulp of an angle below 128 rad is 2⁻¹⁷ ≈ 7.6e-6 and the inputs reach
|x| ≈ 4.5, so an angle one ulp apart moves an output by up to 3.4e-5:
rope is held at atol 5e-5.
Masks, the bf16 embedding scale, the ring cache's slot writes and the QAT
sites' outputs are exact.
"""

import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import registry as rreg
from repro.core.ranges import RangeStat as RRangeStat
from repro.models import layers as RL
from repro.models.config import ATTN_LOCAL, ModelConfig as RModelConfig

from repro_torch.configs import registry as preg
from repro_torch.core.ranges import RangeStat
from repro_torch.models import layers as PL
from repro_torch.models.config import ModelConfig

TOL = dict(rtol=2e-5, atol=2e-5)


def _cfgs(**kw):
    base = dict(name="t", family="dense", n_layers=1, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=64,
                vocab_size=64, dtype="float32")
    base.update(kw)
    return RModelConfig(**base), ModelConfig(**base)


def _normal(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


# ---- RoPE ---------------------------------------------------------------------


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
@pytest.mark.parametrize("hd", [4, 16, 64, 256])
def test_rope_matches_reference(theta, hd):
    x = _normal(hd, (2, 40, 3, hd))
    pos1 = np.arange(40, dtype=np.int32) + 80
    pos2 = np.stack([pos1, pos1[::-1] - 50])
    for pos in (pos1, pos2):
        want = np.asarray(RL.rope(jnp.asarray(x), jnp.asarray(pos), theta))
        got = PL.rope(_t(x), _t(pos), theta).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=5e-5)
    freqs = PL.rope_freqs(hd // 2, theta, torch.device("cpu")).numpy()
    ref = np.asarray(theta ** (-jnp.arange(0, hd // 2, dtype=jnp.float32) / (hd // 2)))
    np.testing.assert_array_max_ulp(freqs, ref, maxulp=1)


# ---- norms --------------------------------------------------------------------


@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
def test_norms_match_reference(norm):
    rc, pc = _cfgs(norm=norm)
    x = _normal(1, (2, 9, 64), 3.0) + 1.5
    p = {"scale": _normal(2, (64,)), "bias": _normal(3, (64,))}
    if norm == "rmsnorm":
        p.pop("bias")
    want = np.asarray(RL.apply_norm(jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()}, rc))
    got = PL.apply_norm(_t(x), {k: _t(v) for k, v in p.items()}, pc).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_layernorm_variance_is_the_population_variance():
    _, pc = _cfgs(norm="layernorm")
    x = torch.tensor([[1.0, 2.0, 3.0, 4.0] * 16])
    y = PL.apply_norm(x, {"scale": torch.ones(64), "bias": torch.zeros(64)}, pc)
    want = (x - 2.5) / torch.sqrt(torch.tensor(1.25 + 1e-6))
    torch.testing.assert_close(y, want, rtol=1e-6, atol=1e-6)


# ---- masks and attention --------------------------------------------------------


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("local", [True, False])
def test_mask_matches_reference(causal, local):
    rc, pc = _cfgs(window=5, causal=causal)
    q1 = np.arange(12, dtype=np.int32)
    q2 = np.stack([q1, q1 + 3])
    for qp, kp in ((q1, q1), (q2, q2), (q1[4:6], q1)):
        want = np.asarray(RL._mask(jnp.asarray(qp), jnp.asarray(kp), rc, local))
        got = PL._mask(_t(qp), _t(kp), pc, local).numpy()
        np.testing.assert_array_equal(got, want)


def _qkv_arrays(seed, s, hq, hk, b=2):
    return _normal(seed, (b, s, hq, 16)), _normal(seed + 1, (b, s, hk, 16)), _normal(seed + 2, (b, s, hk, 16))


@pytest.mark.parametrize("s,window", [(64, 16), (128, 32), (96, 32), (64, 32)])
@pytest.mark.parametrize("hq,hk", [(4, 2), (4, 1), (2, 2)])
def test_banded_matches_full_mask_and_reference(s, window, hq, hk):
    """tests/kernels/test_attention.py's cases: banded local attention
    against the full-score band mask in the port, and each path against the
    reference's."""
    rc, pc = _cfgs(window=window, n_heads=hq, n_kv_heads=hk, d_model=hq * 16)
    q, k, v = _qkv_arrays(s + window, s, hq, hk)
    positions = np.arange(s, dtype=np.int32)
    full = PL._sdpa(_t(q), _t(k), _t(v), PL._mask(_t(positions), _t(positions), pc, True), pc, None).numpy()
    banded = PL._banded_local_sdpa(_t(q), _t(k), _t(v), pc).numpy()
    np.testing.assert_allclose(banded, full, **TOL)
    ref_full = RL._sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        RL._mask(jnp.asarray(positions), jnp.asarray(positions), rc, True), rc, None)
    np.testing.assert_allclose(full, np.asarray(ref_full), **TOL)
    np.testing.assert_allclose(banded, np.asarray(RL._banded_local_sdpa(jnp.asarray(q), jnp.asarray(k),
                                                                          jnp.asarray(v), rc)), **TOL)


def _attn_params(seed, cfg, bias=False):
    d, hq, hk, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    p = {"wq": _normal(seed, (d, hq, hd), d ** -0.5), "wk": _normal(seed + 1, (d, hk, hd), d ** -0.5),
         "wv": _normal(seed + 2, (d, hk, hd), d ** -0.5), "wo": _normal(seed + 3, (hq, hd, d), (hq * hd) ** -0.5)}
    if bias:
        p.update(bq=_normal(seed + 4, (hq, hd), 0.1), bk=_normal(seed + 5, (hk, hd), 0.1),
                 bv=_normal(seed + 6, (hk, hd), 0.1))
    return p


@pytest.mark.parametrize("local", [True, False])
def test_attn_decode_ring_with_per_row_positions_matches_reference(local):
    """One decode step at per-row positions against a filled cache: the
    written cache (the ring slot pos % T for local layers, pos itself for
    global ones) exactly, the output within TOL."""
    rc, pc = _cfgs(window=8, qkv_bias=True)
    t = 8 if local else 24
    p = _attn_params(5, pc, bias=True)
    x = _normal(6, (4, 1, 64))
    cache = {"k": _normal(7, (4, t, 2, 16)), "v": _normal(8, (4, t, 2, 16))}
    pos = np.array([0, 7, 13, 21], np.int32)
    qat_r, qat_p = RL.LayerQAT(None, None), PL.LayerQAT(None, None)
    y_r, c_r = RL.attn_decode(jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()}, rc, local=local,
                              cache={k: jnp.asarray(v) for k, v in cache.items()}, pos=jnp.asarray(pos), rules=None,
                              qat=qat_r)
    c_p = {k: _t(v) for k, v in cache.items()}
    y_p, c_p2 = PL.attn_decode(_t(x), {k: _t(v) for k, v in p.items()}, pc, local=local, cache=c_p,
                               pos=_t(pos).long(), rules=None, qat=qat_p)
    assert c_p2["k"] is c_p["k"]  # written in place
    np.testing.assert_allclose(y_p.numpy(), np.asarray(y_r), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(c_p[name].numpy(), np.asarray(c_r[name]), **TOL)
        untouched = np.ones(cache[name].shape[:2], bool)
        untouched[np.arange(4), pos % t if local else pos] = False
        np.testing.assert_array_equal(c_p[name].numpy()[untouched], cache[name][untouched])


def test_attn_decode_scalar_position_raises_past_the_cache():
    _, pc = _cfgs()
    p = {k: _t(v) for k, v in _attn_params(1, pc).items()}
    cache = {"k": torch.zeros(1, 4, 2, 16), "v": torch.zeros(1, 4, 2, 16)}
    with pytest.raises(ValueError, match="outside the KV cache"):
        PL.attn_decode(torch.zeros(1, 1, 64), p, pc, local=False, cache=cache, pos=4, rules=None,
                       qat=PL.LayerQAT(None, None))


@pytest.mark.parametrize("local", [True, False])
def test_attn_forward_prefill_cache_write_matches_reference(local):
    rc, pc = _cfgs(window=8, qkv_bias=True)
    p = _attn_params(9, pc, bias=True)
    x = _normal(10, (2, 20, 64))
    t = 8 if local else 24
    positions = np.arange(20, dtype=np.int32)
    y_r, c_r = RL.attn_forward(jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()}, rc, local=local,
                               positions=jnp.asarray(positions), rules=None, qat=RL.LayerQAT(None, None),
                               cache={"k": jnp.zeros((2, t, 2, 16)), "v": jnp.zeros((2, t, 2, 16))})
    c_p = {"k": torch.zeros(2, t, 2, 16), "v": torch.zeros(2, t, 2, 16)}
    y_p, _ = PL.attn_forward(_t(x), {k: _t(v) for k, v in p.items()}, pc, local=local, positions=_t(positions),
                             rules=None, qat=PL.LayerQAT(None, None), cache=c_p)
    np.testing.assert_allclose(y_p.numpy(), np.asarray(y_r), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(c_p[name].numpy(), np.asarray(c_r[name]), **TOL)


def test_attn_forward_chunked_matches_unchunked():
    rc, pc = _cfgs(window=8)
    p = {k: _t(v) for k, v in _attn_params(11, pc).items()}
    x = _t(_normal(12, (2, 32, 64)))
    positions = torch.arange(32)
    for local in (True, False):
        full, _ = PL.attn_forward(x, p, pc, local=local, positions=positions, rules=None, qat=PL.LayerQAT(None, None))
        chunked, _ = PL.attn_forward(x, p, pc, local=local, positions=positions, rules=None,
                                     qat=PL.LayerQAT(None, None), chunk=8)
        torch.testing.assert_close(chunked, full, **TOL)


# ---- MLP, embedding, head ------------------------------------------------------


@pytest.mark.parametrize("mlp_type,act", [("glu", "silu"), ("glu", "gelu"), ("mlp", "gelu"), ("mlp", "silu")])
def test_mlp_matches_reference(mlp_type, act):
    rc, pc = _cfgs(mlp_type=mlp_type, act=act, d_ff=96)
    p = ({"wg": _normal(1, (64, 96), 0.125), "wu": _normal(2, (64, 96), 0.125), "wd": _normal(3, (96, 64), 0.1)}
         if mlp_type == "glu" else
         {"wu": _normal(2, (64, 96), 0.125), "wd": _normal(3, (96, 64), 0.1), "bu": _normal(4, (96,), 0.1),
          "bd": _normal(5, (64,), 0.1)})
    x = _normal(6, (2, 7, 64))
    want = RL.mlp_forward(jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()}, rc, None, RL.LayerQAT(None, None))
    got = PL.mlp_forward(_t(x), {k: _t(v) for k, v in p.items()}, pc, None, PL.LayerQAT(None, None))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_gelu_is_the_tanh_approximation():
    x = _normal(3, (4096,), 4.0)
    got = PL._act(_t(x), "gelu").numpy()
    np.testing.assert_allclose(got, np.asarray(jax.nn.gelu(jnp.asarray(x))), rtol=1e-6, atol=1e-6)
    exact = torch.nn.functional.gelu(_t(x)).numpy()
    assert np.abs(exact - got).max() > 1e-4  # the erf form is another function


def test_embedding_scale_is_rounded_to_bf16_first():
    """√d_model rounded to bfloat16 before the multiply, for every
    config's width; the embedded tokens bitwise the reference's."""
    for arch in preg.lm_archs():
        for cfg in (preg.get(arch), preg.get_smoke(arch)):
            want = np.asarray(jnp.asarray(math.sqrt(cfg.d_model), jnp.bfloat16)).astype(np.float32)
            got = PL._const(math.sqrt(cfg.d_model), torch.bfloat16, torch.device("cpu")).float().item()
            assert got == float(want), (arch, cfg.d_model)
    rc, pc = rreg.get_smoke("gemma3_1b"), preg.get_smoke("gemma3_1b")
    table = _normal(1, (pc.vocab_size, pc.d_model), pc.d_model ** -0.5)
    toks = np.random.default_rng(2).integers(0, pc.vocab_size, (2, 9)).astype(np.int32)
    want = RL.embed_tokens(jnp.asarray(toks), {"embedding": jnp.asarray(table)}, rc, None)
    got = PL.embed_tokens(_t(toks), {"embedding": _t(table)}, pc, None)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want).astype(np.float32))


@pytest.mark.parametrize("tie", [True, False])
def test_lm_head_matches_reference(tie):
    rc, pc = _cfgs(tie_embeddings=tie, vocab_size=96)
    p = {"embedding": _normal(1, (96, 64), 0.125)}
    if not tie:
        p["head"] = _normal(2, (64, 96), 0.125)
    x = _normal(3, (2, 5, 64))
    want = RL.lm_head(jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()}, rc, None, RL.LayerQAT(None, None))
    got = PL.lm_head(_t(x), {k: _t(v) for k, v in p.items()}, pc, None, PL.LayerQAT(None, None))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ---- QAT sites -------------------------------------------------------------------


@pytest.mark.parametrize("quant_phase", [False, True])
@pytest.mark.parametrize("stat", ["empty", "captured"])
def test_layer_qat_site_matches_reference(quant_phase, stat):
    """`LayerQAT.site` in both phases: the quantized activation and the
    range update bitwise the reference's."""
    x = _normal(4, (3, 5, 64), 2.0)
    a = (np.float32(np.inf), np.float32(-np.inf), 0) if stat == "empty" else (np.float32(-1.5), np.float32(2.25), 7)
    r_stat = RRangeStat(jnp.asarray(a[0]), jnp.asarray(a[1]), jnp.asarray(a[2], jnp.int32))
    p_stat = RangeStat(torch.tensor(a[0]), torch.tensor(a[1]), torch.tensor(a[2], dtype=torch.int32))
    r_qat = RL.LayerQAT({"s": r_stat}, jnp.asarray(quant_phase), 16)
    p_qat = PL.LayerQAT({"s": p_stat}, torch.tensor(quant_phase), 16)
    want, got = r_qat.site("s", jnp.asarray(x)), p_qat.site("s", _t(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    r_new, p_new = r_qat.collect()["s"], p_qat.collect()["s"]
    for f in ("a_min", "a_max", "count"):
        np.testing.assert_array_equal(getattr(p_new, f).numpy(), np.asarray(getattr(r_new, f)))
    # the shard-region extension points
    r_qat.fold_external("s", jnp.float32(-4.0), jnp.float32(4.0))
    p_qat.fold_external("s", torch.tensor(-4.0), torch.tensor(4.0))
    for f in ("a_min", "a_max", "count"):
        np.testing.assert_array_equal(getattr(p_qat.stats["s"], f).numpy(), np.asarray(getattr(r_qat.stats["s"], f)))
    for got_p, want_p in zip(p_qat.params_for("s")[:2], r_qat.params_for("s")[:2]):
        np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))
    assert PL.LayerQAT(None, None).site("s", _t(x)) is not None and PL.LayerQAT(None, None).params_for("s") is None


def test_init_site_ranges_layout():
    r = PL.init_site_ranges(PL.ATTN_SITES, 3, device=torch.device("cpu"))
    ref = RL.init_site_ranges(RL.ATTN_SITES, 3)
    assert list(r) == list(ref)
    for s in r:
        for f in ("a_min", "a_max", "count"):
            got, want = getattr(r[s], f), np.asarray(getattr(ref[s], f))
            assert got.numpy().dtype == want.dtype
            np.testing.assert_array_equal(got.numpy(), want)


def test_local_attention_masks_past_window():
    """tests/test_archs.py's case on the port: in one local layer a token
    beyond the window cannot move the output."""
    from repro_torch.models import transformer as PT

    cfg = dataclasses.replace(preg.get_smoke("gemma3_1b"), block_pattern=(ATTN_LOCAL,), n_layers=1)
    params = PT.init_params(0, cfg, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (1, 48), generator=torch.Generator().manual_seed(3))
    toks2 = toks.clone()
    toks2[0, 0] = (int(toks[0, 0]) + 7) % cfg.vocab_size
    l1, _ = PT.forward(params, {"tokens": toks}, cfg)
    l2, _ = PT.forward(params, {"tokens": toks2}, cfg)
    assert float((l1[0, 0] - l2[0, 0]).abs().max()) > 0.0
    assert float((l1[0, 47] - l2[0, 47]).abs().max()) == 0.0
