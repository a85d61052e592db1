"""Port parity: the continuously batched LM engine (`repro_torch.serve.lm`)
on the CPU — the reference's contract and tests (tests/serve/
test_lm_engine.py) on one arch per cache/state family: qwen2 (global KV
cache), gemma3 (local ring + global mix), recurrentgemma (RG-LRU states +
local ring) and rwkv6 (RWKV-6 states), in the configs' own bfloat16:

  * per-token parity — every sequence the engine decodes is exactly what
    the port's sequential `generate` produces, whatever shares the batch;
    and on float32 weights the engine's tokens are the REFERENCE's
    `generate` tokens;
  * deterministic scheduling, immediate eviction, dirty-lane safety;
  * lifecycle — threaded clients, stop drains, restart, trace spans.

Serving casts the float32 params to the compute dtype once
(`transformer.serving_params`); its logits are held bitwise to the
reference's cast-at-every-use order, for every LM arch.  Greedy tokens:
exact.
"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401  (one intra-op thread a worker)

import jax

from repro.configs import registry as rreg
from repro.models import transformer as RT
from repro.serve.engine import generate as rgenerate
from repro.serve.lm import LMEngine as RefLMEngine

from repro_torch import convert
from repro_torch.configs import registry as preg
from repro_torch.models import transformer as PT
from repro_torch.obs import Observability
from repro_torch.serve.engine import generate
from repro_torch.serve.lm import LMEngine
from repro_torch.serve.lm.engine import _insert_lane

ARCHS = ["qwen2_0_5b", "gemma3_1b", "recurrentgemma_2b", "rwkv6_1_6b"]
RECURRENT_ARCHS = ["recurrentgemma_2b", "rwkv6_1_6b"]
# with random weights a tied-embedding model (qwen2, gemma3, recurrentgemma)
# echoes its last prompt token greedily; an untied head (internlm2, rwkv6)
# makes the stream vary
PARITY_ARCHS = ARCHS + ["internlm2_1_8b"]
# every decoder arch (hubert is an encoder): the engine's tokens against the reference's generate
DECODER_ARCHS = [a for a in preg.lm_archs() if preg.get(a).causal]
# prompt lengths: 40 > the gemma3 / recurrentgemma smoke window (32), so the
# local-attention ring cache wraps during prefill
PROMPT_LENS = (6, 11, 40)
MAX_NEW = (6, 3, 4)
_CACHE: dict = {}


def _setup(arch, dtype=None, seed=0):
    key = (arch, dtype, seed)
    if key not in _CACHE:
        cfg = preg.get_smoke(arch)
        if dtype is not None:
            cfg = dataclasses.replace(cfg, dtype=dtype)
        params = PT.init_params(torch.Generator().manual_seed(seed), cfg, device="cpu")
        rng = np.random.default_rng(7)
        prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32) for n in PROMPT_LENS]
        _CACHE[key] = cfg, params, prompts
    return _CACHE[key]


def _generate(params, cfg, prompt, n):
    return generate(params, cfg, np.asarray(prompt)[None], n)[0].numpy()


@pytest.mark.parametrize("arch", PARITY_ARCHS)
def test_batched_decode_matches_sequential_generate(arch):
    """≥2 concurrently admitted sequences, token-exact vs generate()."""
    cfg, params, prompts = _setup(arch)
    eng = LMEngine(params, cfg, lanes=2, max_seq=64, device="cpu")
    outs = eng.generate_batch(prompts, list(MAX_NEW))
    for prompt, n, out in zip(prompts, MAX_NEW, outs):
        np.testing.assert_array_equal(out, _generate(params, cfg, prompt, n))


@pytest.mark.parametrize("arch", DECODER_ARCHS)
def test_engine_tokens_match_reference_generate(arch):
    """On the reference's float32 weights, the port's engine emits the
    reference's `generate` tokens, prompt for prompt."""
    rcfg = dataclasses.replace(rreg.get_smoke(arch), dtype="float32")
    pcfg = dataclasses.replace(preg.get_smoke(arch), dtype="float32")
    rparams = RT.init_params(jax.random.key(3), rcfg)
    params = convert.lm_params_from_numpy(jax.tree.map(np.asarray, rparams), device="cpu")
    _, _, prompts = _setup(arch)
    outs = LMEngine(params, pcfg, lanes=2, max_seq=64, device="cpu").generate_batch(prompts, list(MAX_NEW))
    for prompt, n, out in zip(prompts, MAX_NEW, outs):
        np.testing.assert_array_equal(out, np.asarray(rgenerate(rparams, rcfg, prompt[None], n))[0])


@pytest.mark.parametrize("arch", ARCHS)
def test_admission_eviction_invariants(arch):
    """The [6,3,4]-token schedule on 2 lanes runs exactly 5 decode steps
    (vs 10 sequential): req2 admits the tick req1's lane frees, and every
    tick decodes all active lanes at once."""
    cfg, params, prompts = _setup(arch)
    eng = LMEngine(params, cfg, lanes=2, max_seq=64, device="cpu")
    eng.generate_batch(prompts, list(MAX_NEW))
    st = eng.stats()
    assert st["decode_steps"] == 5
    assert st["admitted"] == 3 and st["evicted"] == 3
    assert st["requests"] == 3
    assert st["tokens"] == sum(MAX_NEW)     # prefill argmax + decode tokens
    assert st["decode_occupancy"] == 1.0    # both lanes busy every step


@pytest.mark.parametrize("arch", ARCHS)
def test_dirty_lane_reuse_is_exact(arch):
    """A second batch through the SAME engine reuses lanes whose caches
    still hold the first batch's KV — admission must fully overwrite."""
    cfg, params, prompts = _setup(arch)
    eng = LMEngine(params, cfg, lanes=2, max_seq=64, device="cpu")
    eng.generate_batch(prompts, list(MAX_NEW))
    outs = eng.generate_batch(prompts[::-1], list(MAX_NEW[::-1]))
    for prompt, n, out in zip(prompts[::-1], MAX_NEW[::-1], outs):
        np.testing.assert_array_equal(out, _generate(params, cfg, prompt, n))


@pytest.mark.parametrize("arch", ARCHS)
def test_max_new_one_resolves_at_admission(arch):
    """max_new=1 needs no decode step: the prefill argmax is the answer."""
    cfg, params, prompts = _setup(arch)
    eng = LMEngine(params, cfg, lanes=2, max_seq=64, device="cpu")
    (out,) = eng.generate_batch([prompts[0]], [1])
    np.testing.assert_array_equal(out, _generate(params, cfg, prompts[0], 1))
    assert eng.stats()["decode_steps"] == 0


def test_oversized_prompt_fails_only_that_request():
    """Global-attention arch: prompt + max_new past the cache length fails
    that request's future; the rest of the batch still serves."""
    cfg, params, prompts = _setup("qwen2_0_5b")
    eng = LMEngine(params, cfg, lanes=2, max_seq=32, device="cpu")
    big = np.random.default_rng(1).integers(0, cfg.vocab_size, size=30).astype(np.int32)
    futs = [eng._batcher.submit(prompts[0], 3), eng._batcher.submit(big, 8)]
    while eng._pending():
        eng._tick(0.0)
    np.testing.assert_array_equal(futs[0].result(timeout=0), _generate(params, cfg, prompts[0], 3))
    with pytest.raises(ValueError, match="exceeds the engine's KV cache length"):
        futs[1].result(timeout=0)


def test_oversized_prompt_fails_on_a_local_global_mix():
    """gemma3's ring slots never run out, but its global layers' slots do:
    the engine refuses, as the reference does for any arch with a global
    layer."""
    cfg, params, prompts = _setup("gemma3_1b")
    eng = LMEngine(params, cfg, lanes=1, max_seq=32, device="cpu")
    fut = eng._batcher.submit(prompts[2], 4)  # 40 + 4 > 32
    while eng._pending():
        eng._tick(0.0)
    with pytest.raises(ValueError, match="global-attention arch"):
        fut.result(timeout=0)


def test_submit_validation():
    cfg, params, _ = _setup("qwen2_0_5b")
    eng = LMEngine(params, cfg, lanes=1, max_seq=32, device="cpu")
    with pytest.raises(ValueError, match="empty prompt"):
        eng._batcher.submit([], 4)
    with pytest.raises(ValueError, match="max_new"):
        eng._batcher.submit([1, 2], 0)
    with pytest.raises(ValueError, match="lanes"):
        LMEngine(params, cfg, lanes=0, device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_threaded_lifecycle_and_tracing(arch, tmp_path):
    """Concurrent staggered clients through the serve thread; stop drains
    every lane; submit-after-stop raises; restart serves again; the trace
    shows the admission/decode lifecycle spans."""
    cfg, params, _ = _setup(arch)
    trace = tmp_path / "trace.jsonl"
    obs = Observability.tracing(trace_path=str(trace))
    eng = LMEngine(params, cfg, lanes=2, max_seq=64, obs=obs, device="cpu")
    rng = np.random.default_rng(3)

    with pytest.raises(RuntimeError, match="not serving"):
        eng.submit([1, 2, 3], 2)

    with eng:
        futs = [eng.submit(rng.integers(0, cfg.vocab_size, size=4 + i), 3) for i in range(6)]
        outs = [f.result(timeout=120.0) for f in futs]
    for i, out in enumerate(outs):
        assert out.shape == (4 + i + 3,)
    st = eng.stats()
    assert st["requests"] == 6 and st["evicted"] == 6

    with pytest.raises(RuntimeError, match="not serving"):
        eng.submit([1, 2, 3], 2)
    with eng:  # restart
        assert eng.submit([5, 6, 7], 2).result(timeout=120.0).shape == (5,)

    names = {json.loads(line)["name"] for line in trace.read_text().splitlines() if line.strip().startswith("{")}
    for span in ("serve_lm.admit", "serve_lm.launch", "serve_lm.block_until_ready", "serve_lm.reply",
                 "serve_lm.request"):
        assert span in names, f"missing span {span}"


def test_generate_batch_requires_stopped_engine():
    cfg, params, prompts = _setup("qwen2_0_5b")
    eng = LMEngine(params, cfg, lanes=1, max_seq=64, device="cpu")
    with eng:
        with pytest.raises(RuntimeError, match="serve thread owns ticks"):
            eng.generate_batch([prompts[0]], [2])
    assert len(eng.generate_batch([prompts[0]], [2])) == 1


def test_stats_keys_and_client_strings_match_reference():
    cfg, params, prompts = _setup("qwen2_0_5b")
    eng = LMEngine(params, cfg, lanes=2, max_seq=64, device="cpu")
    eng.generate_batch(prompts[:2], [2, 2])
    rcfg = rreg.get_smoke("qwen2_0_5b")
    ref = RefLMEngine(RT.init_params(jax.random.key(0), rcfg), rcfg, lanes=2, max_seq=64)
    ref.generate_batch([prompts[0]], [2])
    assert set(eng.stats()) == set(ref.stats())
    for attr in ("not_running_msg", "already_started_msg", "stopped_msg", "health_running_key", "thread_name"):
        assert getattr(LMEngine, attr) == getattr(RefLMEngine, attr)


def test_insert_lane_overwrites_the_whole_row():
    cfg, _, _ = _setup("gemma3_1b")
    big = PT.init_cache(cfg, 3, 40, device="cpu")
    for leaf in _leaves(big):
        leaf.fill_(7)
    small = PT.init_cache(cfg, 1, 40, device="cpu")
    for leaf in _leaves(small):
        leaf.copy_(torch.randn(leaf.shape, generator=torch.Generator().manual_seed(1)).to(leaf.dtype))
    _insert_lane(big, small, 1)
    for b, s in zip(big["scan"], small["scan"]):
        for name in b:
            assert torch.equal(b[name][:, 1], s[name][:, 0]) and bool((b[name][:, 0] == 7).all())
    for b, s in zip(big["tail"], small["tail"]):
        for name in b:
            assert torch.equal(b[name][1], s[name][0]) and bool((b[name][2] == 7).all())


def _leaves(tree):
    return [v for slot in tree["scan"] + tree["tail"] for v in slot.values()]


@pytest.mark.parametrize("arch", RECURRENT_ARCHS)
def test_insert_lane_overwrites_the_whole_recurrent_state(arch):
    """Every recurrent leaf of the lane (RWKV-6 wkv / x_tm / x_cm, RG-LRU h
    / conv, and the local layers' K/V) is overwritten on admission, in
    float32; the other lanes are untouched."""
    cfg, _, _ = _setup(arch)
    big = PT.init_cache(cfg, 3, 40, device="cpu")
    for leaf in _leaves(big):
        leaf.fill_(7)
    small = PT.init_cache(cfg, 1, 40, device="cpu")
    for leaf in _leaves(small):
        leaf.copy_(torch.randn(leaf.shape, generator=torch.Generator().manual_seed(2)).to(leaf.dtype))
    _insert_lane(big, small, 2)
    names = set()
    for b, s in zip(big["scan"], small["scan"]):
        for name in b:
            names.add(name)
            assert torch.equal(b[name][:, 2], s[name][:, 0]) and bool((b[name][:, :2] == 7).all())
    for b, s in zip(big["tail"], small["tail"]):
        for name in b:
            assert torch.equal(b[name][2], s[name][0]) and bool((b[name][:2] == 7).all())
    assert names >= ({"h", "conv"} if arch == "recurrentgemma_2b" else {"wkv", "x_tm", "x_cm"})
    assert all(leaf.dtype == torch.float32 for slot in big["scan"] for n, leaf in slot.items() if n not in ("k", "v"))


@pytest.mark.parametrize("arch", RECURRENT_ARCHS)
def test_lane_reused_after_a_recurrent_request_gives_generate_tokens(arch):
    """One lane: a request finishes and leaves its recurrent state in the
    lane; the next request admitted there emits `generate`'s tokens."""
    cfg, params, prompts = _setup(arch)
    eng = LMEngine(params, cfg, lanes=1, max_seq=64, device="cpu")
    first, second = eng.generate_batch([prompts[2], prompts[0]], [4, 6])
    np.testing.assert_array_equal(first, _generate(params, cfg, prompts[2], 4))
    np.testing.assert_array_equal(second, _generate(params, cfg, prompts[0], 6))
    state = eng._cache["scan"][0]["h" if arch == "recurrentgemma_2b" else "wkv"]
    assert state.dtype == torch.float32 and float(state.abs().max()) > 0  # the lane holds a state


def _forward_batch(cfg, seed=1, b=2, s=12):
    rng = np.random.default_rng(seed)
    batch = {}
    if cfg.frontend != "audio_stub":
        batch["tokens"] = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32))
    if cfg.frontend != "none":
        n = cfg.frontend_len if cfg.frontend == "vision_stub" else s
        batch["frontend"] = torch.from_numpy(rng.normal(size=(b, n, cfg.frontend_dim)).astype(np.float32))
    return batch


@pytest.mark.parametrize("arch", preg.lm_archs())
def test_serving_params_give_the_float32_trees_logits_bitwise(arch):
    """Every arch, every block family: the forward's logits through the
    once-cast serving tree are bitwise those of the float32 tree; the
    leaves the reference uses in float32 stay float32."""
    cfg, params, _ = _setup(arch)
    cast = PT.serving_params(params, cfg)
    batch = _forward_batch(cfg)
    want, _ = PT.forward(params, batch, cfg)
    got, _ = PT.forward(cast, batch, cfg)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    kept = {"router", "w0", "wA", "wB", "u", "wa", "ba", "wi", "bi", "lam", "scale", "bias", "gn_scale", "gn_bias"}
    for slot in cast["scan"]:
        for part in slot.values():
            for name, leaf in part.items():
                assert leaf.dtype == (torch.float32 if name in kept else torch.bfloat16), (arch, name)


@pytest.mark.parametrize("arch", ARCHS)
def test_once_cast_params_give_the_per_use_logits_bitwise(arch):
    """`serving_params` casts the product weights to bf16 once; every layer
    casting the float32 weights where it uses them (the reference's order)
    gives bitwise the same prefill and decode logits."""
    cfg, params, prompts = _setup(arch)
    cast = PT.serving_params(params, cfg)
    assert cast["embed"]["embedding"].dtype == torch.bfloat16
    assert cast["final_norm"]["scale"].dtype == torch.float32  # norms compute in float32
    tokens = torch.from_numpy(prompts[2][None])
    for p in (params, cast):
        cache = PT.init_cache(cfg, 1, 48, device="cpu")
        last, cache = PT.prefill(p, {"tokens": tokens}, cfg, cache=cache)
        step, _ = PT.decode_step(p, torch.argmax(last, -1)[:, None], cache, tokens.shape[1], cfg)
        if p is params:
            want = (last, step)
    assert torch.equal(last, want[0]) and torch.equal(step, want[1])


def test_engine_needs_a_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg, params, _ = _setup("qwen2_0_5b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LMEngine(params, cfg)
