"""Port parity: the model assembly (`repro_torch.models.transformer`,
`repro_torch.serve.engine`) against the JAX reference, every LM arch's
smoke config (attention, MoE, RWKV-6 and RG-LRU blocks) in float32, on the
reference's own weights carried across by `convert.lm_params_from_numpy`.

Tolerances: logits, float32, QAT off — |Δ| ≤ 2e-5·scale + 2e-5 (scale =
max |logit|): the same products summed in another order through a few
layers.  With the QAT sites on, an input one float32 ulp apart can round
to the neighbouring Q15.16 point (monitor phase) or 16-bit affine code
(quant phase), so logits are held at 1e-3·scale + 1e-3 and the captured
ranges at rtol 1e-4 / atol 5e-5 (the counts exactly) — the reference's
quant-phase contract (tests/kernels/test_fxp_mlp_step.py).  Decode against
the full forward: the reference's own contract, |Δ| < 0.05·scale + 0.05
(tests/test_archs.py), and against the reference's decode the float32
bound above; for MoE archs on one row of 8 tokens, where the forward's
capacity (≥ 8) drops no (token, choice) pair — a longer prompt drops pairs
the one-token decode never drops, by the reference's semantics.  Greedy
tokens: exact.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import registry as rreg
from repro.models import transformer as RT
from repro.serve.engine import generate as rgenerate

from repro_torch import convert
from repro_torch.configs import registry as preg
from repro_torch.models import transformer as PT
from repro_torch.serve.engine import generate, make_prefill, make_serve_step

ARCHS = preg.lm_archs()
DECODER_ARCHS = [a for a in ARCHS if preg.get(a).causal]
B, S = 2, 24
_CACHE: dict = {}


def _setup(arch, dtype="float32", seed=0):
    key = (arch, dtype, seed)
    if key not in _CACHE:
        rc = dataclasses.replace(rreg.get_smoke(arch), dtype=dtype)
        pc = dataclasses.replace(preg.get_smoke(arch), dtype=dtype)
        rp = RT.init_params(jax.random.key(seed), rc)
        pp = convert.lm_params_from_numpy(jax.tree.map(np.asarray, rp), device="cpu")
        _CACHE[key] = rc, pc, rp, pp
    return _CACHE[key]


def _batch(rc, seed=1, s=S):
    rng = np.random.default_rng(seed)
    batch = {}
    if rc.frontend != "audio_stub":
        batch["tokens"] = rng.integers(0, rc.vocab_size, (B, s)).astype(np.int32)
    if rc.frontend == "vision_stub":
        batch["frontend"] = rng.normal(size=(B, rc.frontend_len, rc.frontend_dim)).astype(np.float32)
    if rc.frontend == "audio_stub":
        batch["frontend"] = rng.normal(size=(B, s, rc.frontend_dim)).astype(np.float32)
    return {k: jnp.asarray(v) for k, v in batch.items()}, {k: torch.from_numpy(v) for k, v in batch.items()}


def _close(got, want, rel, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= rel * scale + rel, f"{what}: max |Δ| {err} > {rel}·{scale} + {rel}"


def test_param_tree_matches_reference_layout():
    """init_params' tree: the reference's keys, list lengths, shapes and
    dtypes, leaf for leaf (gemma3's stacked slots and two-layer tail)."""
    for arch in ARCHS:
        rc, pc, rp, _ = _setup(arch)
        mine = PT.init_params(0, pc, device="cpu")
        ref = jax.tree_util.tree_flatten_with_path(rp)[0]
        got = jax.tree_util.tree_flatten_with_path(convert.lm_params_to_numpy(mine))[0]
        assert [jax.tree_util.keystr(p) for p, _ in got] == [jax.tree_util.keystr(p) for p, _ in ref], arch
        for path, leaf in ref:
            t = _leaf(mine, path)
            assert tuple(t.shape) == leaf.shape and t.dtype == torch.float32, (arch, path)


def _leaf(tree, path):
    for k in path:
        tree = tree[k.key if hasattr(k, "key") else k.idx]
    return tree


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    rc, pc, rp, pp = _setup(arch)
    br, bp = _batch(rc)
    want, _ = RT.forward(rp, br, rc)
    got, extras = PT.forward(pp, bp, pc)
    assert got.shape == want.shape and extras["ranges"] is None
    _close(got.numpy(), want, 2e-5, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_with_qat_ranges_matches_reference(arch):
    """Monitor phase from fresh ranges, then the quant phase on the ranges
    it captured: logits and the new range trees."""
    rc, pc, rp, pp = _setup(arch)
    br, bp = _batch(rc, seed=2)
    r_ranges = RT.init_ranges(rc)
    p_ranges = PT.init_ranges(pc, device="cpu")
    for phase in (False, True):
        want, er = RT.forward(rp, br, rc, ranges=r_ranges, quant_phase=jnp.asarray(phase))
        got, ep = PT.forward(pp, bp, pc, ranges=p_ranges, quant_phase=torch.tensor(phase))
        _close(got.numpy(), want, 1e-3, f"{arch} quant_phase={phase}")
        ref_leaves = jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, er["ranges"]))[0]
        for path, leaf in ref_leaves:
            mine = _range_leaf(ep["ranges"], path)
            if leaf.dtype == np.int32:
                np.testing.assert_array_equal(mine, leaf, err_msg=f"{arch} {path}")
            else:
                np.testing.assert_allclose(mine, leaf, rtol=1e-4, atol=5e-5, err_msg=f"{arch} {path}")
        r_ranges, p_ranges = er["ranges"], ep["ranges"]
    assert int(p_ranges["head"]["head_in"].count[0]) == 1  # the quant phase froze the monitor's capture


def _range_leaf(tree, path):
    for k in path:
        if hasattr(k, "key"):
            tree = tree[k.key]
        elif hasattr(k, "idx"):
            tree = tree[k.idx]
        else:
            tree = getattr(tree, k.name)
    return tree.numpy()


@pytest.mark.parametrize("arch", DECODER_ARCHS)
def test_decode_matches_forward_and_reference(arch):
    """Token-by-token decode with caches against the full forward (the
    reference's serving-parity contract) and against the reference's own
    decode on the same weights."""
    rc, pc, rp, pp = _setup(arch)
    br, bp = _batch(rc, seed=3, s=8)
    if pc.is_moe:  # one row: the forward's capacity drops nothing
        br, bp = {k: v[:1] for k, v in br.items()}, {k: v[:1] for k, v in bp.items()}
    b = bp["tokens"].shape[0]
    full, _ = PT.forward(pp, {"tokens": bp["tokens"]}, pc)
    cache = PT.init_cache(pc, b, 16, device="cpu")
    r_cache = RT.init_cache(rc, b, 16)
    r_step = jax.jit(lambda p, t, c, i: RT.decode_step(p, t, c, i, rc))
    outs, r_outs = [], []
    for i in range(8):
        lg, cache = PT.decode_step(pp, bp["tokens"][:, i:i + 1], cache, i, pc)
        rl, r_cache = r_step(rp, br["tokens"][:, i:i + 1], r_cache, jnp.int32(i))
        outs.append(lg)
        r_outs.append(np.asarray(rl))
    dec = torch.cat(outs, 1).numpy()
    scale = float(full.abs().max())
    assert float(np.abs(dec - full.numpy()).max()) < 0.05 * scale + 0.05
    _close(dec, np.concatenate(r_outs, 1), 2e-5, arch)
    for got, want in zip(_flat(convert.lm_cache_to_numpy(cache)), jax.tree.leaves(jax.tree.map(np.asarray, r_cache))):
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def _flat(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _flat(v)]
    return [tree]


def test_ring_cache_decode_matches_forward():
    """Local-attention decode with the O(window) ring cache equals the
    full-sequence forward (tests/kernels/test_attention.py's case)."""
    cfg = dataclasses.replace(preg.get_smoke("gemma3_1b"), block_pattern=("local",), n_layers=2, window=8,
                              vocab_size=128, dtype="float32")
    params = PT.init_params(0, cfg, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 24), generator=torch.Generator().manual_seed(1))
    full, _ = PT.forward(params, {"tokens": toks}, cfg)
    cache = PT.init_cache(cfg, 2, 24, device="cpu")
    assert cache["scan"][0]["k"].shape[2] == 8  # (L, B, ring=8, ...)
    outs = []
    for i in range(24):
        lg, cache = PT.decode_step(params, toks[:, i:i + 1], cache, i, cfg)
        outs.append(lg)
    torch.testing.assert_close(torch.cat(outs, 1), full, rtol=2e-4, atol=2e-4)


def _tokenwise_generate(params, cfg, prompt, max_new):
    """The pre-prefill path: feed the prompt token by token through
    serve_step, then decode greedily."""
    b, s = prompt.shape
    cache = PT.init_cache(cfg, b, s + max_new, device="cpu")
    step = make_serve_step(cfg)
    logits = None
    for i in range(s):
        logits, cache = step(params, prompt[:, i:i + 1], cache, i)
    out = [prompt]
    for i in range(max_new):
        tok = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
        out.append(tok)
        logits, cache = step(params, tok, cache, s + i)
    return torch.cat(out, 1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["qwen2_0_5b", "gemma3_1b", "recurrentgemma_2b", "rwkv6_1_6b"])
def test_generate_matches_tokenwise_serve_step(arch, dtype):
    """tests/serve/test_generate_prefill.py's case: the batched prefill path
    continues exactly where token-by-token serve_step does; in float32 its
    tokens are also the reference's `generate` tokens."""
    rc, pc, rp, pp = _setup(arch, dtype)
    prompt = torch.from_numpy(np.random.default_rng(1).integers(0, pc.vocab_size, (2, 9)).astype(np.int32))
    got = generate(pp, pc, prompt, max_new=5)
    want = _tokenwise_generate(PT.serving_params(pp, pc), pc, prompt, max_new=5)
    assert torch.equal(got, want), f"{arch}: prefill path diverged from stepwise"
    if dtype == "float32":
        np.testing.assert_array_equal(got.numpy(), np.asarray(rgenerate(rp, rc, jnp.asarray(prompt.numpy()), 5)))


@pytest.mark.parametrize("arch", DECODER_ARCHS)
def test_generate_tokens_match_reference(arch):
    """Every decoder arch, float32, on the reference's weights: the port's
    greedy `generate` emits the reference's tokens."""
    rc, pc, rp, pp = _setup(arch, seed=4)
    prompt = np.random.default_rng(6).integers(0, pc.vocab_size, (2, 9)).astype(np.int32)
    got = generate(pp, pc, torch.from_numpy(prompt), max_new=6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(rgenerate(rp, rc, jnp.asarray(prompt), 6)))


def test_generate_prompt_longer_than_window():
    """Ring-cache wraparound: prompt (40) > window (32) — prefill lands the
    surviving tail of the prompt in the exact ring slots decode uses."""
    rc, pc, rp, pp = _setup("gemma3_1b", seed=2)
    assert pc.window < 40
    prompt = torch.from_numpy(np.random.default_rng(3).integers(0, pc.vocab_size, (1, 40)).astype(np.int32))
    got = generate(pp, pc, prompt, max_new=4)
    assert torch.equal(got, _tokenwise_generate(pp, pc, prompt, max_new=4))
    np.testing.assert_array_equal(got.numpy(), np.asarray(rgenerate(rp, rc, jnp.asarray(prompt.numpy()), 4)))


@pytest.mark.parametrize("arch", ["qwen2_0_5b", "gemma3_1b", "recurrentgemma_2b", "rwkv6_1_6b"])
def test_prefill_cache_matches_reference(arch):
    """The caches and recurrent states a prefill writes (the ring slots of
    local layers among them: a 40-token prompt against gemma3's and
    recurrentgemma's 32-slot rings) against the reference's, leaf for
    leaf."""
    rc, pc, rp, pp = _setup(arch)
    toks = np.random.default_rng(4).integers(0, pc.vocab_size, (2, 40)).astype(np.int32)
    r_last, r_cache = RT.prefill(rp, {"tokens": jnp.asarray(toks)}, rc, cache=RT.init_cache(rc, 2, 48))
    cache = PT.init_cache(pc, 2, 48, device="cpu")
    last, out = make_prefill(pc)(pp, {"tokens": torch.from_numpy(toks)}, cache)
    assert out is cache
    _close(last.numpy(), r_last, 2e-5, arch)
    for got, want in zip(_flat(convert.lm_cache_to_numpy(cache)), jax.tree.leaves(jax.tree.map(np.asarray, r_cache))):
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    # the converter carries the reference's cache across as well
    back = convert.lm_cache_from_numpy(jax.tree.map(np.asarray, r_cache), pc, device="cpu")
    assert all(torch.equal(a, torch.from_numpy(np.array(b))) for a, b in
               zip(_flat(back), jax.tree.leaves(jax.tree.map(np.asarray, r_cache))))


def test_prefill_rejects_prompt_longer_than_global_cache():
    """An absolute-slot (global) cache shorter than the prompt fails loudly."""
    _, pc, _, pp = _setup("qwen2_0_5b")
    tokens = torch.randint(0, pc.vocab_size, (1, 12), generator=torch.Generator().manual_seed(1))
    with pytest.raises(ValueError, match="exceeds the KV cache"):
        make_prefill(pc)(pp, {"tokens": tokens}, PT.init_cache(pc, 1, 8, device="cpu"))


def test_prefill_without_cache_returns_logits_only():
    _, pc, _, pp = _setup("qwen2_0_5b")
    tokens = torch.randint(0, pc.vocab_size, (2, 8), generator=torch.Generator().manual_seed(1))
    out = make_prefill(pc)(pp, {"tokens": tokens})
    assert isinstance(out, torch.Tensor) and out.shape == (2, pc.vocab_size)
    logits, cache = make_prefill(pc)(pp, {"tokens": tokens}, PT.init_cache(pc, 2, 16, device="cpu"))
    assert logits.shape == (2, pc.vocab_size)
    assert float(cache["scan"][0]["k"].abs().max()) > 0


def test_sampling_takes_an_explicit_generator():
    _, pc, _, pp = _setup("qwen2_0_5b")
    prompt = torch.zeros((1, 4), dtype=torch.int32)
    a = generate(pp, pc, prompt, 6, temperature=1.0, generator=torch.Generator().manual_seed(5))
    b = generate(pp, pc, prompt, 6, temperature=1.0, generator=torch.Generator().manual_seed(5))
    assert torch.equal(a, b) and a.shape == (1, 10)
    with pytest.raises(ValueError, match="generator"):
        generate(pp, pc, prompt, 2, temperature=1.0)


def test_entry_points_need_a_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = preg.get_smoke("qwen2_0_5b")
    for fn in (lambda: PT.init_params(0, cfg), lambda: PT.init_cache(cfg, 1, 8), lambda: PT.init_ranges(cfg)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn()


def test_model_config_matches_reference():
    for arch in preg.ARCH_IDS:
        if arch == "fixar_ddpg":
            continue
        for r, p in ((rreg.get(arch), preg.get(arch)), (rreg.get_smoke(arch), preg.get_smoke(arch))):
            assert dataclasses.asdict(r) == dataclasses.asdict(p)
            assert (r.hd, r.n_periods, r.n_tail, r.layer_types()) == (p.hd, p.n_periods, p.n_tail, p.layer_types())
            assert (r.total_params(), r.params_per_token()) == (p.total_params(), p.params_per_token())
            assert str(r.compute_dtype) == str(p.compute_dtype).removeprefix("torch.")
    assert preg.lm_archs() == rreg.lm_archs() and preg.ALIASES == rreg.ALIASES
    from repro.models import config as rconfig
    from repro_torch.models import config as pconfig

    assert [dataclasses.asdict(s) for s in pconfig.ALL_SHAPES] == [dataclasses.asdict(s) for s in rconfig.ALL_SHAPES]
    assert preg.get("fixar_ddpg").env == rreg.get("fixar_ddpg").env


def test_greedy_ties_take_the_first_index_like_the_reference():
    """bf16 logits of a random model tie; both libraries' argmax take the
    first maximal index, on every row."""
    from repro_torch.serve.engine import _next_token

    rng = np.random.default_rng(5)
    logits = rng.integers(-3, 4, (64, 512)).astype(np.float32)  # many ties per row
    got = _next_token(torch.from_numpy(logits).to(torch.bfloat16), 0.0, None).numpy()
    want = np.asarray(jnp.argmax(jnp.asarray(logits, jnp.bfloat16), -1))
    np.testing.assert_array_equal(got, want)
    assert (got == np.argmax(logits, -1)).all()
