"""Moonlight-16B-A3B (`configs/moonlight_16b_a3b`, the DeepSeek-V3 block:
latent attention, shared and sigmoid-routed experts behind a dense layer)
at its `SMOKE` size (1 dense + 2 MoE layers, 8 experts, 2 shared) against
the benchmark's plain reference, `bench/reference/moonlight_16b_a3b.py`,
the one file the check on the card runs too.

Float32 throughout.  Tolerances, relative L2: the loss and the logits
1e-5 with QAT off, 1e-4 in the monitor and the quant phase (a site's input
one ulp apart can take the neighbouring lattice point or affine code); each
gradient leaf 1e-4 off, 1e-3 in the monitor and the quant phase (the same
flips, seen by the straight-through gradient of the layers below).  The
quant phase runs on ranges a monitor-phase forward captured on another
batch, as training freezes them (`tests/_torch_lm_train.py` says why).

Also: the expert-share identity (the shares of an 8-way split of the
experts, with what every share computes alike counted once, add up to the
uncut reference layer), the dropless dispatch under a routing bias forced
to skew, the bias steering the choice and not the gates, the gates'
normalisation and scaling, one bias update by the sign rule, the MoE
counters, the CLI, the missing latent cache raising, and the registry's
lists.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import pathlib

import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401  (one intra-op thread a worker)

from repro_torch import tree  # noqa: E402
from repro_torch.configs import moonlight_16b_a3b as M  # noqa: E402
from repro_torch.configs import registry as preg  # noqa: E402
from repro_torch.launch.train import main as train_main  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.config import MLA  # noqa: E402
from repro_torch.optim import adam  # noqa: E402
from repro_torch.train import step as S  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]


def _load(rel: str, name: str):
    spec = importlib.util.spec_from_file_location(name, REPO / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _load("bench/reference/moonlight_16b_a3b.py", "moonlight_reference")
DRV = _load("bench/drivers/lm_train.py", "moonlight_driver")  # the program -> reference layouts

CFG = dataclasses.replace(M.SMOKE, dtype="float32")
B, SEQ = 2, 16


def _settings(cfg, held=None) -> dict:
    """The reference's settings for a program config (the configuration
    file's keys, `DRV.FIELDS`)."""
    c = {key: getattr(cfg, field) for key, field in DRV.FIELDS.items()}
    held = cfg.experts_held if held is None else held
    c.update(n_experts_held=len(held), first_expert_held=held.start, adam_lr=3e-4, adam_b1=0.9, adam_b2=0.999,
             adam_eps=1e-8)
    return REF.settings(c)


def _rel(a, b) -> float:
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _batch(seed: int):
    g = torch.Generator().manual_seed(seed)
    toks = torch.randint(0, CFG.vocab_size, (B, SEQ + 1), generator=g, dtype=torch.int32)
    return {"tokens": toks[:, :SEQ].contiguous(), "labels": toks[:, 1:].contiguous()}


def _bias(cfg, seed=7, scale=0.05):
    g = torch.Generator().manual_seed(seed)
    return scale * torch.randn((cfg.n_periods, cfg.n_experts), generator=g)


def _program(cfg, params, ranges, batch, quant, bias):
    """(loss, logits, grads in the reference's layout)."""
    phase = torch.tensor(quant)
    loss, _, grads = S.value_and_grad(cfg, params, ranges, batch, phase, router_bias=bias)
    with torch.no_grad():
        logits, _ = T.forward(params, batch, cfg, ranges=ranges, quant_phase=phase, router_bias=bias)
    return loss, logits, DRV.to_reference(grads)


@pytest.mark.parametrize("phase", ["off", "monitor", "quant"])
def test_program_matches_the_plain_reference(phase):
    cfg = dataclasses.replace(CFG, qat=phase != "off")
    params = T.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    bias = _bias(cfg)
    batch = _batch(1)
    ranges = T.init_ranges(cfg, device="cpu") if cfg.qat else None
    ref_ranges = None
    if phase == "quant":  # ranges folded by a monitor-phase forward on another batch, then frozen; each side its own
        _, extras = T.forward(params, _batch(2), cfg, ranges=ranges, quant_phase=torch.tensor(False),
                              router_bias=bias)
        ranges = extras["ranges"]
        ref_ranges = REF.monitor_ranges([(DRV.to_reference(params), bias, _batch(2)["tokens"], None)], _settings(cfg))
        assert DRV._range_gap(DRV.ranges_of(ranges, True), ref_ranges) <= 1e-5
    loss, logits, grads = _program(cfg, params, ranges, batch, phase == "quant", bias)
    r = REF.step_grads(DRV.to_reference(params), ref_ranges, bias, batch["tokens"], batch["labels"], phase,
                       _settings(cfg), logits_rows=B)
    tol, gtol = (1e-5, 1e-4) if phase == "off" else (1e-4, 1e-3)
    assert abs(float(loss) - float(r["loss"])) <= tol * abs(float(r["loss"]))
    assert _rel(logits, r["logits"]) <= tol
    leaves = dict(DRV._leaves(grads))
    ref_leaves = dict(DRV._leaves(r["grads"]))
    assert leaves.keys() == ref_leaves.keys()
    for name, g in leaves.items():
        assert ref_leaves[name].norm() > 0, name  # every leaf takes a gradient
        assert _rel(g, ref_leaves[name]) <= gtol, (name, _rel(g, ref_leaves[name]))


def _moe_layer(params, i=0):
    return tree.tree_map(lambda t: t[i], params["scan"][0])


def _share(bp, held: range):
    ffn = dict(bp["ffn"], **{k: bp["ffn"][k][held.start:held.stop] for k in ("wg", "wu", "wd")})
    return dict(bp, ffn=ffn)


def _program_layer(cfg, bp, x, bias):
    stats = []
    y, _, _ = T.block_forward(x, bp, cfg, MLA, positions=torch.arange(x.shape[1]), rules=None,
                              qat=L.LayerQAT(None, None), router_bias=bias, moe_stats=stats)
    return y, stats[0]


@pytest.mark.parametrize("n_shares", [2, 8])
def test_expert_shares_add_up_to_the_uncut_layer(n_shares):
    params = T.init_params(torch.Generator().manual_seed(3), CFG, device="cpu")
    bp = _moe_layer(params)
    ref_p = DRV.to_reference(params)["layers"][1]
    x = torch.randn((B, SEQ, CFG.d_model), generator=torch.Generator().manual_seed(4))
    bias = _bias(CFG)[0]
    per = CFG.n_experts // n_shares
    total = torch.zeros_like(x)
    rows, loads = 0, []
    for s in range(n_shares):
        held = range(s * per, (s + 1) * per)
        cfg = dataclasses.replace(CFG, n_experts_held=per, first_expert_held=held.start)
        y, stats = _program_layer(cfg, _share(bp, held), x, bias)
        total = total + y
        rows += int(stats["rows_held"])
        assert int(stats["rows_dropped"]) == 0
        loads.append(stats["load"])  # over all experts, whichever are held
    with torch.no_grad():
        common, _, _ = REF.layer(x, ref_p, {}, bias, "off", _settings(CFG, held=range(0)))  # attention, shared
        whole, _, _ = REF.layer(x, ref_p, {}, bias, "off", _settings(CFG))
    assert rows == B * SEQ * CFG.experts_per_token
    assert all(torch.equal(load, loads[0]) for load in loads) and int(loads[0].sum()) == rows
    assert _rel(total - (n_shares - 1) * common, whole) <= 1e-5


def test_dropless_under_a_skewing_bias():
    params = T.init_params(torch.Generator().manual_seed(5), CFG, device="cpu")
    bp = _moe_layer(params)
    ref_p = DRV.to_reference(params)["layers"][1]
    x = torch.randn((B, SEQ, CFG.d_model), generator=torch.Generator().manual_seed(6))
    bias = torch.zeros(CFG.n_experts)
    bias[[6, 7]] = 10.0  # every token to experts 6 and 7
    held = range(4, 8)
    cfg = dataclasses.replace(CFG, n_experts_held=4, first_expert_held=4)
    y, stats = _program_layer(cfg, _share(bp, held), x, bias)
    t = B * SEQ
    assert stats["load"].tolist() == [0] * 6 + [t, t]
    assert int(stats["rows_held"]) == 2 * t and int(stats["rows_dropped"]) == 0
    ref_p = dict(ref_p, **{k: ref_p[k][held.start:held.stop] for k in ("wg", "wu", "wd")})  # the held ones
    with torch.no_grad():
        want, _, _ = REF.layer(x, ref_p, {}, bias, "off", _settings(CFG, held=held))
    assert _rel(y, want) <= 1e-5


class _Poison(torch.autograd.Function):
    """NaN in the rows past `ends[-1]`, forward and backward: what a
    grouped product may leave there."""

    @staticmethod
    def forward(ctx, y, ends):
        ctx.ends = ends
        return _Poison.fill(y, ends)

    @staticmethod
    def backward(ctx, g):
        return _Poison.fill(g, ctx.ends), None

    @staticmethod
    def fill(y, ends):
        pad = torch.arange(y.shape[0]) >= ends[-1]
        return torch.where(pad[:, None], torch.full_like(y, float("nan")), y)


@pytest.mark.parametrize("quant", [False, True])
def test_the_rows_past_the_held_ones_may_hold_anything(monkeypatch, quant):
    """The dispatch's buffer holds all T·k pairs, the held ones first: the
    rows past them, NaN here in the products' outputs and in the
    gradients they pass back, change nothing, ranges included."""
    cfg = dataclasses.replace(CFG, qat=True, n_experts_held=4, first_expert_held=2)
    params = T.init_params(torch.Generator().manual_seed(11), cfg, device="cpu")
    ranges = T.init_ranges(cfg, device="cpu")
    if quant:
        _, extras = T.forward(params, _batch(12), cfg, ranges=ranges, quant_phase=torch.tensor(False))
        ranges = extras["ranges"]
    batch, phase = _batch(13), torch.tensor(quant)

    def run():
        loss, extras, grads = S.value_and_grad(cfg, params, ranges, batch, phase)
        return [loss] + tree.leaves(grads) + [x for r in tree.leaves(extras["ranges"]) for x in r]

    clean = run()
    real = moe._grouped
    monkeypatch.setattr(moe, "_grouped", lambda a, b, ends: _Poison.apply(real(_Poison.apply(a, ends), b, ends), ends))
    poisoned = run()
    assert all(torch.isfinite(t).all() for t in poisoned[:-1] if t.is_floating_point())
    assert all(torch.equal(a, b) for a, b in zip(clean, poisoned))


@pytest.mark.parametrize("norm", [True, False])
def test_the_bias_steers_the_choice_not_the_gates(norm):
    cfg = dataclasses.replace(CFG, norm_topk_prob=norm)
    g = torch.Generator().manual_seed(8)
    flat = torch.randn((64, cfg.d_model), generator=g)
    router = torch.randn((cfg.d_model, cfg.n_experts), generator=g) * cfg.d_model ** -0.5
    bias = torch.randn(cfg.n_experts, generator=g)
    r = moe.route_sigmoid(flat, router, bias, cfg)
    scores = torch.sigmoid(flat @ router)
    assert torch.allclose(r["scores"], scores, rtol=1e-6, atol=1e-7)
    # the choice: the top k of score + bias, not of the score
    want = torch.topk(scores + bias, cfg.experts_per_token, -1).indices
    assert torch.equal(r["experts"].sort(-1).values, want.sort(-1).values)
    assert not torch.equal(r["experts"].sort(-1).values,
                           torch.topk(scores, cfg.experts_per_token, -1).indices.sort(-1).values)
    # the gates: the chosen scores, without the bias, normalised and scaled by 2.446
    chosen = scores.gather(1, r["experts"])
    gates = (chosen / chosen.sum(-1, keepdim=True) if norm else chosen) * 2.446
    assert cfg.routed_scaling == 2.446
    assert torch.allclose(r["gates"], gates, rtol=1e-6, atol=1e-7)
    if norm:
        assert torch.allclose(r["gates"].sum(-1), torch.full((64,), 2.446), rtol=1e-6)
    assert torch.equal(r["load"], torch.bincount(r["experts"].reshape(-1), minlength=cfg.n_experts))


def test_one_step_moves_the_bias_by_the_sign_rule_and_reports_the_counters():
    cfg = CFG
    state = S.init_state(torch.Generator().manual_seed(9), cfg, device="cpu")
    assert state.router_bias.shape == (cfg.n_periods, cfg.n_experts) and not state.router_bias.any()
    step = S.make_train_step(cfg, adam.AdamConfig(lr=3e-4))
    batch = _batch(10)
    r = REF.step_grads(DRV.to_reference(state.params), None, state.router_bias, batch["tokens"], batch["labels"],
                       "off", _settings(cfg))
    new, m = step(state, batch)
    assert torch.equal(m["moe_load"], r["load"])
    load = m["moe_load"].to(torch.float32)
    want = 0.001 * torch.sign(load.mean(-1, keepdim=True) - load)
    assert torch.equal(new.router_bias, want)
    assert torch.equal(new.router_bias, REF.bias_rule(state.router_bias, m["moe_load"], 0.001))
    t = B * SEQ
    assert int(m["moe_rows_held"]) == cfg.n_periods * t * cfg.experts_per_token
    assert int(m["moe_rows_dropped"]) == 0
    assert float(m["moe_load_max_over_mean"]) == pytest.approx(float((load.max(-1).values / load.mean(-1)).max()))
    assert float(m["moe_bias_absmax"]) == pytest.approx(0.001)
    assert not any(p.requires_grad for p in tree.leaves(new.params))


def test_the_cli_trains_the_smoke_config():
    _, records = train_main(["--arch", "moonlight-16b-a3b", "--smoke", "--device", "cpu", "--steps", "2",
                             "--batch", "2", "--seq", "16", "--qat", "--qat-delay", "1", "--log-every", "1"])
    assert [r["quant_phase"] for r in records] == [0, 1]
    for r in records:
        assert r["moe_rows_dropped"] == 0.0 and r["moe_rows_held"] == 2 * 2 * 16 * M.SMOKE.experts_per_token
        assert r["moe_bias_absmax"] > 0 and r["moe_load_max_over_mean"] >= 1.0


def test_no_latent_cache_yet():
    from repro_torch.serve.lm import LMEngine

    params = T.init_params(torch.Generator().manual_seed(0), CFG, device="cpu")
    with pytest.raises(NotImplementedError, match="latent"):
        T.init_cache(CFG, 1, 8, device="cpu")
    with pytest.raises(NotImplementedError, match="latent"):
        T.decode_step(params, torch.zeros((1, 1), dtype=torch.int32), {}, 0, CFG)
    with pytest.raises(NotImplementedError, match="latent"):
        T.prefill(params, {"tokens": torch.zeros((1, 4), dtype=torch.int32)}, CFG, cache={})
    with pytest.raises(NotImplementedError, match="latent"):
        LMEngine(params, CFG, lanes=1, max_seq=8, device="cpu")
    logits = T.prefill(params, {"tokens": torch.zeros((1, 4), dtype=torch.int32)}, CFG)  # no cache: a forward
    assert logits.shape == (1, CFG.vocab_size)


def test_the_published_config_and_the_one_chip_cut():
    cfg = preg.get("moonlight-16b-a3b")
    assert cfg is M.CONFIG
    assert (cfg.n_layers, cfg.first_k_dense, cfg.n_periods, cfg.d_model, cfg.dense_d_ff, cfg.d_ff) == (
        27, 1, 26, 2048, 11_264, 1408)
    assert (cfg.n_heads, cfg.kv_lora_rank, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim) == (
        16, 512, 128, 64, 128)
    assert (cfg.n_experts, cfg.experts_per_token, cfg.n_shared_experts, len(cfg.experts_held)) == (64, 6, 2, 64)
    assert (cfg.routed_scaling, cfg.norm_topk_prob, cfg.rope_theta, cfg.norm_eps) == (2.446, True, 50_000.0, 1e-5)
    assert (cfg.vocab_size, cfg.tie_embeddings, cfg.bias_update_rate, cfg.seq_aux_coef) == (
        163_840, False, 0.001, 0.0001)
    cut = dataclasses.replace(cfg, n_layers=13, n_experts_held=8, vocab_size=20_480)
    # the dense layer 83.0 M; a MoE layer 100.4 M; the embedding and head 83.9 M: 1.372 B
    assert cut.total_params() == pytest.approx(1.372e9, rel=5e-4)


def test_the_registry_lists_are_the_jax_packages():
    rreg = pytest.importorskip("repro.configs.registry")
    assert preg.ARCH_IDS == rreg.ARCH_IDS and preg.ALIASES == rreg.ALIASES and preg.lm_archs() == rreg.lm_archs()
    assert "moonlight_16b_a3b" in preg.PORT_ARCH_IDS and "moonlight_16b_a3b" not in preg.ARCH_IDS
    for arch in preg.PORT_ARCH_IDS:
        assert preg.get(arch).name == preg.get(arch.replace("_", "-")).name
