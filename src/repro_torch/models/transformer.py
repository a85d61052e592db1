"""Model assembly for all 10 architectures (port of
`repro.models.transformer`).

Layer stacks are grouped by `block_pattern` period: the params of every
period are stacked along a leading axis and the stack is walked period by
period (a Python loop over the period index: the reference's `lax.scan`
and its `unroll=True` branch alike), the remainder layers run as the
"tail".  The tree layout is the reference's — ``{"embed", "final_norm",
"frontend", "scan": [per pattern slot, leading n_periods axis], "tail":
[...]}``, with its leaf names — so `convert.lm_params_from_numpy` carries
the reference's weights across leaf for leaf.

Public API
----------
  init_params(gen, cfg, device=)               parameter tree
  param_specs(cfg)                             matching Logical tree
  init_ranges(cfg, device=)                    stacked QAT range tree
  ranges_specs(cfg)                            its Logical tree
  forward(params, batch, cfg, ...)             logits (train / prefill path)
  loss_fn(params, batch, cfg, ...)             scalar loss + extras
  init_cache(cfg, batch, max_seq, device=)     decode KV caches / recurrent states
  cache_specs(cfg)                             Logical tree for caches
  decode_step(params, tokens, cache, pos, ...) one-token serve step
  prefill(params, batch, cfg, cache=)          prompt pass (+ cache writes)
  serving_params(params, cfg)                  frozen params in the compute dtype

Blocks: `ATTN_GLOBAL` and `ATTN_LOCAL` with a dense MLP or the MoE FFN
(`models.moe`, the dense dispatch), `RWKV6` (`models.rwkv6`) and `RGLRU`
with a dense MLP (`models.rglru`), and `MLA` (`config.DeepSeekV3Config`):
latent attention with the DeepSeek MoE, after `n_lead` leading
layers of latent attention with a dense MLP, whose trees are the list
"lead" (params and ranges; only where there are such layers).  An MLA
model trains and runs full forwards; it has no decode cache yet (the
latent cache), so `init_cache`, `decode_step` and a prefill with a cache
raise for it.  KV caches and recurrent states are
written in place: a prefill with a cache or a decode step leaves the cache
it was given updated (the per-layer caches are views of the stacked tree),
ready for the next step.  `loss_fn` is the training path: remat per
pattern period, the chunked cross-entropy, fresh recurrent states that the
blocks return rather than write.
"""

from __future__ import annotations

import functools
from typing import Any, Optional, Union

import torch
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from repro_torch import tree
from repro_torch.core.parallelism import (_AMBIENT, Logical, ShardingRules, ambient_mesh, constrain, is_dtensor,
                                          map_logical, replicated, sharded_scope)
from repro_torch.core.ranges import RangeStat
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import frontend as fe
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import rwkv6 as rwkv_mod
from repro_torch.models.config import ATTN_GLOBAL, ATTN_LOCAL, MLA, RGLRU, RWKV6, ModelConfig

Tensor = torch.Tensor
Params = dict[str, Any]
ATTN = (ATTN_GLOBAL, ATTN_LOCAL)


# ---------------------------------------------------------------------------
# trees: index / stack along the leading layer axis
# ---------------------------------------------------------------------------


def _at(node, i: int):
    """Every leaf of `node` indexed at `i` along its leading axis (views)."""
    if isinstance(node, Tensor):
        return node[i]
    if isinstance(node, RangeStat):
        return RangeStat(node.a_min[i], node.a_max[i], node.count[i])
    if isinstance(node, dict):
        return {k: _at(v, i) for k, v in node.items()}
    raise TypeError(f"not a tree node: {type(node).__name__}")


def _stack(trees: list):
    """The trees (same structure) stacked leaf by leaf on a new leading axis."""
    first = trees[0]
    if isinstance(first, Tensor):
        return torch.stack(trees)
    if isinstance(first, RangeStat):
        return RangeStat(*(torch.stack([getattr(t, f) for t in trees]) for f in ("a_min", "a_max", "count")))
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    raise TypeError(f"not a tree node: {type(first).__name__}")


def _lead(node):
    """`node` with a leading axis of one added to every leaf."""
    return _stack([node])


# ---------------------------------------------------------------------------
# per-block init / specs
# ---------------------------------------------------------------------------


def block_sites(cfg: ModelConfig, bt: str) -> tuple[str, ...]:
    if bt == MLA:
        return L.MLA_MOE_SITES
    if bt in ATTN:
        return L.MOE_SITES if cfg.is_moe else L.ATTN_SITES
    if bt == RWKV6:
        return L.RWKV_SITES
    if bt == RGLRU:
        return L.RGLRU_SITES
    raise ValueError(bt)


def block_init(gen: torch.Generator, cfg: ModelConfig, bt: str, lead: tuple = ()) -> Params:
    if bt == MLA:
        return _mla_block_init(gen, cfg, False, lead)
    if bt in ATTN:
        ffn = moe_mod.moe_init(gen, cfg, lead) if cfg.is_moe else L.mlp_init(gen, cfg, lead)
        return {"ln1": L.norm_init(gen, cfg, lead), "attn": L.attn_init(gen, cfg, lead),
                "ln2": L.norm_init(gen, cfg, lead), "ffn": ffn}
    if bt == RWKV6:
        return {"ln1": L.norm_init(gen, cfg, lead), "ln2": L.norm_init(gen, cfg, lead),
                "rwkv": rwkv_mod.rwkv_init(gen, cfg, lead)}
    if bt == RGLRU:
        return {"ln1": L.norm_init(gen, cfg, lead), "rnn": rglru_mod.rglru_init(gen, cfg, lead),
                "ln2": L.norm_init(gen, cfg, lead), "ffn": L.mlp_init(gen, cfg, lead)}
    raise ValueError(bt)


def _mla_block_init(gen: torch.Generator, cfg: ModelConfig, dense: bool, lead: tuple = ()) -> Params:
    ffn = L.mlp_init(gen, cfg, lead, cfg.dense_d_ff) if dense else moe_mod.ds_moe_init(gen, cfg, lead)
    return {"ln1": L.norm_init(gen, cfg, lead), "attn": L.mla_init(gen, cfg, lead),
            "ln2": L.norm_init(gen, cfg, lead), "ffn": ffn}


def _mla_block_specs(cfg: ModelConfig, dense: bool) -> Params:
    return {"ln1": L.norm_specs(cfg), "attn": L.mla_specs(cfg), "ln2": L.norm_specs(cfg),
            "ffn": L.mlp_specs(cfg) if dense else moe_mod.ds_moe_specs(cfg)}


def block_specs(cfg: ModelConfig, bt: str) -> Params:
    if bt == MLA:
        return _mla_block_specs(cfg, False)
    if bt in ATTN:
        ffn = moe_mod.moe_specs(cfg) if cfg.is_moe else L.mlp_specs(cfg)
        return {"ln1": L.norm_specs(cfg), "attn": L.attn_specs(cfg), "ln2": L.norm_specs(cfg), "ffn": ffn}
    if bt == RWKV6:
        return {"ln1": L.norm_specs(cfg), "ln2": L.norm_specs(cfg), "rwkv": rwkv_mod.rwkv_specs(cfg)}
    if bt == RGLRU:
        return {"ln1": L.norm_specs(cfg), "rnn": rglru_mod.rglru_specs(cfg), "ln2": L.norm_specs(cfg),
                "ffn": L.mlp_specs(cfg)}
    raise ValueError(bt)


# ---------------------------------------------------------------------------
# whole-model init / specs
# ---------------------------------------------------------------------------


def _generator(gen: Union[torch.Generator, int], device: DeviceLike) -> torch.Generator:
    if isinstance(gen, torch.Generator):
        return gen
    return torch.Generator(device=resolve_device(device)).manual_seed(int(gen))


def init_params(gen: Union[torch.Generator, int], cfg: ModelConfig, *, device: DeviceLike = None) -> Params:
    """Random float32 params: uniform(±fan_in^−½) weights, N(0, 1/d)
    embeddings, unit norm scales, zero biases (the reference's
    distributions; its `jax.random` draws are not reproduced — carry the
    reference's own weights across with `convert.lm_params_from_numpy`).
    `gen` is a `torch.Generator` (its device is where the draws run) or a
    seed for a new generator on `device`; the tree ends on `device`."""
    dev = resolve_device(device)
    gen = _generator(gen, dev)
    params: Params = {"embed": L.embed_init(gen, cfg), "final_norm": L.norm_init(gen, cfg),
                      "frontend": fe.frontend_init(gen, cfg)}
    if cfg.n_lead:
        params["lead"] = [_mla_block_init(gen, cfg, True) for _ in range(cfg.n_lead)]
    params["scan"] = [block_init(gen, cfg, bt, (cfg.n_periods,)) for bt in cfg.block_pattern]
    params["tail"] = [block_init(gen, cfg, cfg.block_pattern[i]) for i in range(cfg.n_tail)]
    return tree.tree_map(lambda t: t.to(dev), params)


def _add_leading(spec_tree):
    """Prefix a `layers` (never-sharded) axis for stacked params."""
    return map_logical(lambda lg: Logical("layers", *lg.axes), spec_tree)


def param_specs(cfg: ModelConfig) -> Params:
    specs: Params = {"embed": L.embed_specs(cfg), "final_norm": L.norm_specs(cfg),
                     "frontend": fe.frontend_specs(cfg)}
    if cfg.n_lead:
        specs["lead"] = [_mla_block_specs(cfg, True) for _ in range(cfg.n_lead)]
    specs["scan"] = [_add_leading(block_specs(cfg, bt)) for bt in cfg.block_pattern]
    specs["tail"] = [block_specs(cfg, cfg.block_pattern[i]) for i in range(cfg.n_tail)]
    return specs


def init_ranges(cfg: ModelConfig, *, device: DeviceLike = None) -> Params:
    """QAT range trees (stacked for scan slots, (1,) for tail/head)."""
    dev = resolve_device(device)
    out = {"scan": [L.init_site_ranges(block_sites(cfg, bt), cfg.n_periods, device=dev)
                    for bt in cfg.block_pattern],
           "tail": [L.init_site_ranges(block_sites(cfg, cfg.block_pattern[i]), 1, device=dev)
                    for i in range(cfg.n_tail)],
           "head": L.init_site_ranges(L.HEAD_SITES, 1, device=dev)}
    if cfg.n_lead:
        out["lead"] = [L.init_site_ranges(L.MLA_DENSE_SITES, 1, device=dev) for _ in range(cfg.n_lead)]
    return out


def ranges_specs(cfg: ModelConfig) -> Params:
    """Every range leaf replicated (`Logical(None)`), as the reference's."""
    rep = lambda sites: {s: RangeStat(Logical(None), Logical(None), Logical(None)) for s in sites}  # noqa: E731
    out = {"scan": [rep(block_sites(cfg, bt)) for bt in cfg.block_pattern],
           "tail": [rep(block_sites(cfg, cfg.block_pattern[i])) for i in range(cfg.n_tail)],
           "head": rep(L.HEAD_SITES)}
    if cfg.n_lead:
        out["lead"] = [rep(L.MLA_DENSE_SITES) for _ in range(cfg.n_lead)]
    return out


# the leaves a serving tree holds in the compute dtype: exactly those every
# family casts where it uses them.  Norm scales and biases (the RWKV group
# norm's too) stay float32, and so do the leaves the reference uses in
# float32: the MoE router, RWKV-6's decay (w0, wA, wB) and bonus (u), the
# RG-LRU gates (wa, ba, wi, bi, lam).  wg / wo / wk / wv are cast wherever
# they occur (attention, MLP, MoE experts, RWKV-6, RG-LRU).
_MATMUL_LEAVES = frozenset({"wq", "wk", "wv", "wo", "bq", "bk", "bv", "wg", "wu", "wd", "bu", "bd",
                            "embedding", "head", "proj",
                            "tm_A", "tm_B", "tm_base", "wr", "cm_wk", "cm_wv", "cm_wr", "cm_mu_k", "cm_mu_r",
                            "wx", "conv_w", "conv_b"})


def serving_params(params: Params, cfg: ModelConfig) -> Params:
    """`params` with every product weight cast to the compute dtype, once.

    Serving params are frozen, and every layer casts a weight to the compute
    dtype where it uses it (`.to` is the identity on a tensor already in
    that dtype): so a tree cast here gives bitwise the logits of the float32
    tree, without a per-step pass over the float32 weights."""
    dt = cfg.compute_dtype

    def cast(node, key=None):
        if isinstance(node, Tensor):
            return node.to(dt) if key in _MATMUL_LEAVES else node
        if isinstance(node, dict):
            return {k: cast(v, k) for k, v in node.items()}
        return [cast(v, key) for v in node]

    return cast(params)


# ---------------------------------------------------------------------------
# block forward (full-sequence)
# ---------------------------------------------------------------------------


def block_forward(x: Tensor, bp: Params, cfg: ModelConfig, bt: str, *, positions: Tensor,
                  rules: Optional[ShardingRules], qat: L.LayerQAT, state: Optional[dict] = None,
                  attn_chunk: int = 0, router_bias: Optional[Tensor] = None,
                  moe_stats: Optional[list] = None) -> tuple[Tensor, Optional[dict], Optional[Tensor]]:
    """Returns (x_out, state, aux_loss): the state given, updated in place,
    or for a recurrent block given none (a training forward or a stateless
    prefill: a fresh zero state) its new state as a new dict; and the MoE
    balance loss (None for other blocks).  An MLA block runs its dense MLP
    or, where its params have a router, the DeepSeek MoE routed with
    `router_bias`, whose stats (`moe.ds_moe_forward`) it appends to
    `moe_stats`."""
    aux = None
    if bt == MLA:
        h = L.apply_norm(x, bp["ln1"], cfg)
        x = x + L.mla_forward(h, bp["attn"], cfg, positions=positions, qat=qat)
        h = L.apply_norm(x, bp["ln2"], cfg)
        if "router" not in bp["ffn"]:
            return x + L.mlp_forward(h, bp["ffn"], cfg, None, qat), state, aux
        h, aux, stats = moe_mod.ds_moe_forward(h, bp["ffn"], cfg, qat, router_bias)
        moe_stats.append(stats)
        return x + h, state, aux
    if bt in ATTN:
        h = L.apply_norm(x, bp["ln1"], cfg)
        h, state = L.attn_forward(h, bp["attn"], cfg, local=(bt == ATTN_LOCAL), positions=positions,
                                  rules=rules, qat=qat, chunk=attn_chunk, cache=state)
        x = x + h
        h = L.apply_norm(x, bp["ln2"], cfg)
        if cfg.is_moe:
            h, aux = moe_mod.moe_forward(h, bp["ffn"], cfg, rules, qat)
        else:
            h = L.mlp_forward(h, bp["ffn"], cfg, rules, qat)
        return x + h, state, aux
    if bt == RWKV6:
        h = L.apply_norm(x, bp["ln1"], cfg)
        h, tm = rwkv_mod.time_mix(h, bp["rwkv"], cfg, state, rules, qat)
        x = x + h
        h = L.apply_norm(x, bp["ln2"], cfg)
        h, cm = rwkv_mod.channel_mix(h, bp["rwkv"], cfg, state, rules, qat)
        return x + h, state if state is not None else {**tm, **cm}, aux
    if bt == RGLRU:
        h = L.apply_norm(x, bp["ln1"], cfg)
        h, state = rglru_mod.rglru_forward(h, bp["rnn"], cfg, state, rules, qat)
        x = x + h
        h = L.apply_norm(x, bp["ln2"], cfg)
        h = L.mlp_forward(h, bp["ffn"], cfg, rules, qat)
        return x + h, state, aux
    raise ValueError(bt)


def _block_state_init(cfg: ModelConfig, bt: str, batch: int, max_seq: int, dev: torch.device, lead: tuple = ()):
    """Zero recurrent state (float32) or decode KV cache (compute dtype) for
    one layer of type bt; local layers use a window ring."""
    if bt == RWKV6:
        return rwkv_mod.init_state(cfg, batch, dev, lead)
    if bt == RGLRU:
        return rglru_mod.init_state(cfg, batch, dev, lead)
    t = min(max_seq, cfg.window) if bt == ATTN_LOCAL else max_seq
    shape = lead + (batch, t, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=cfg.compute_dtype, device=dev),
            "v": torch.zeros(shape, dtype=cfg.compute_dtype, device=dev)}


def _block_state_specs(cfg: ModelConfig, bt: str):
    if bt == RWKV6:
        return rwkv_mod.state_specs(cfg)
    if bt == RGLRU:
        return rglru_mod.state_specs(cfg)
    s = Logical("batch", "kv_seq", "kv_heads", "head_dim")
    return {"k": s, "v": s}


# ---------------------------------------------------------------------------
# full forward (train / prefill)
# ---------------------------------------------------------------------------


def _unbind(node, n: int) -> list:
    """The tree split into its `n` slices along the leading axis: one
    `unbind` per leaf, whose backward stacks the slices' gradients in one
    op (a per-slice index would scatter each into a zero tensor of the
    whole stack)."""
    if isinstance(node, Tensor):
        return list(torch.unbind(node, 0))
    if isinstance(node, dict):
        parts = {k: _unbind(v, n) for k, v in node.items()}
        return [{k: parts[k][i] for k in node} for i in range(n)]
    raise TypeError(f"not a tree node: {type(node).__name__}")


_MATMUL_OPS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.bmm.default, torch.ops.aten.addmm.default,
                         torch.ops.aten.baddbmm.default})


def _save_matmuls(ctx, op, *args, **kwargs):
    """The "dots" policy: keep every matrix product's output, recompute the
    rest in the backward (`jax.checkpoint_policies.checkpoint_dots`)."""
    return CheckpointPolicy.MUST_SAVE if op in _MATMUL_OPS else CheckpointPolicy.PREFER_RECOMPUTE


def _remat_wrap(fn, cfg: ModelConfig, enable: bool):
    """`fn` under `torch.utils.checkpoint` per `cfg.remat` ("full": keep
    only its inputs; "dots": also the matrix products' outputs; "none": as
    it is).  The wrapped period builds its QAT contexts from its inputs and
    returns the ranges it collected, so the backward's recompute leaves the
    range tree as it is; the forward draws no random numbers, so no RNG
    state is stashed."""
    if not enable or cfg.remat == "none":
        return fn
    kw = {"use_reentrant": False, "preserve_rng_state": False}
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts, _save_matmuls)
    fn = _in_this_mesh(fn)
    return lambda *args: checkpoint(fn, *args, **kw)


def _in_this_mesh(fn):
    """`fn` run under the mesh in scope now (`ambient_mesh`) and its
    `sharded_scope`, wherever it is called from: a checkpoint's backward
    recomputes it on the autograd engine's thread (on the card, a device
    thread of its own), where the forward's mesh — a context variable — is
    not set, so its `constrain`s and the MoE's path choice would silently
    differ from the forward's."""
    mesh = ambient_mesh()

    def run(*args):
        token = _AMBIENT.set(mesh)
        try:
            with sharded_scope():
                return fn(*args)
        finally:
            _AMBIENT.reset(token)

    return run


def forward(params: Params, batch: dict[str, Tensor], cfg: ModelConfig, *,
            rules: Optional[ShardingRules] = None, ranges: Optional[Params] = None,
            quant_phase: Optional[Tensor] = None, states: Optional[Params] = None,
            remat: bool = False, attn_chunk: int = 0, unroll: bool = False,
            skip_head: bool = False, router_bias: Optional[Tensor] = None) -> tuple[Tensor, dict[str, Any]]:
    """Full-sequence forward. Returns (logits, {"ranges", "states", "aux"}).

    `ranges` (with `quant_phase`, a bool tensor) turns the QAT sites on and
    returns the updated range tree.  `states` (prefill): a cache tree from
    `init_cache` — attention blocks write the prompt's K/V into it and
    recurrent blocks consume its states and write their new ones, in
    place; it comes back as "states".  "aux" is the MoE balance loss summed
    over the layers (zero for other archs).  `remat` checkpoints each
    pattern period per `cfg.remat` (`_remat_wrap`).  `unroll` is accepted
    for the reference's signature and changes nothing: the periods are
    walked in a Python loop either way.  `skip_head` returns the final
    norm's output through the head's QAT site instead of logits (the
    chunked cross-entropy of `loss_fn`).

    An MLA model walks its `n_lead` dense layers ("lead") before the
    periods, takes `router_bias`, its MoE layers' (n_periods, n_experts)
    routing bias (zeros if None), and adds "moe" to the extras: each MoE
    layer's expert loads (n_periods, n_experts) and chosen experts
    (n_periods, B·S, k), and the rows its held experts computed and left
    out, summed over the layers."""
    del unroll
    with sharded_scope():
        if cfg.is_mla and (rules is not None or states is not None):
            raise NotImplementedError("an MLA model runs unsharded and without a cache (no latent cache yet)")
        return _forward(params, batch, cfg, rules, ranges, quant_phase, states, remat, attn_chunk, skip_head,
                        router_bias)


def _forward(params, batch, cfg, rules, ranges, quant_phase, states, remat, attn_chunk, skip_head, router_bias):
    qat_on = ranges is not None
    if "tokens" in batch:
        x = L.embed_tokens(batch["tokens"], params["embed"], cfg, rules)
        b, s = batch["tokens"].shape
    else:  # audio frontend: embeddings only
        b, s, _ = batch["frontend"].shape
        x = torch.zeros((b, s, cfg.d_model), dtype=cfg.compute_dtype, device=batch["frontend"].device)
    x = fe.apply_frontend(x, params["frontend"], batch, cfg, rules)
    positions = torch.arange(s, device=x.device)
    has_states = states is not None
    new_ranges = {"scan": [], "tail": []} if qat_on else None
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    n_slots = len(cfg.block_pattern)
    if cfg.is_mla and router_bias is None:
        router_bias = torch.zeros((cfg.n_periods, cfg.n_experts), dtype=torch.float32, device=x.device)
    moe_stats: list = []

    def period(x, aux, bts, bps, rngs, sts, biases):
        new_rngs, stats = [], []
        for si, bt in enumerate(bts):
            qat = L.LayerQAT(rngs[si], quant_phase, cfg.qat_bits)
            x, _, a = block_forward(x, bps[si], cfg, bt, positions=positions, rules=rules, qat=qat,
                                    state=sts[si], attn_chunk=attn_chunk, router_bias=biases[si], moe_stats=stats)
            if a is not None:
                aux = aux + a
            new_rngs.append(qat.collect())
        return constrain(x, rules, "batch", "seq", "embed"), aux, new_rngs, stats

    run = _remat_wrap(period, cfg, remat)

    # ---- lead layers (an MLA model's dense layers) -----------------------------
    for i in range(cfg.n_lead):
        rngs = [_at(ranges["lead"][i], 0) if qat_on else None]
        x, aux_total, got, _ = run(x, aux_total, cfg.block_pattern[:1], [params["lead"][i]], rngs, [None], [None])
        if qat_on:
            new_ranges.setdefault("lead", []).append(_lead(got[0]))

    # ---- stacked periods -----------------------------------------------------
    if cfg.n_periods > 0:
        slot_params = [_unbind(p, cfg.n_periods) for p in params["scan"]]
        slot_ranges = []
        for i in range(cfg.n_periods):
            rngs = [_at(r, i) for r in ranges["scan"]] if qat_on else [None] * n_slots
            sts = [_at(c, i) for c in states["scan"]] if has_states else [None] * n_slots
            biases = [router_bias[i] if cfg.is_mla else None] * n_slots
            x, aux_total, got, stats = run(x, aux_total, cfg.block_pattern, [p[i] for p in slot_params], rngs, sts,
                                           biases)
            slot_ranges.append(got)
            moe_stats += stats
        if qat_on:
            new_ranges["scan"] = [_stack([got[si] for got in slot_ranges]) for si in range(n_slots)]

    # ---- tail layers ---------------------------------------------------------
    for i in range(cfg.n_tail):
        bt = cfg.block_pattern[i]
        qat = L.LayerQAT(_at(ranges["tail"][i], 0) if qat_on else None, quant_phase, cfg.qat_bits)
        st = states["tail"][i] if has_states else None
        x, _, aux = block_forward(x, params["tail"][i], cfg, bt, positions=positions, rules=rules, qat=qat,
                                  state=st, attn_chunk=attn_chunk)
        if aux is not None:
            aux_total = aux_total + aux
        if qat_on:
            new_ranges["tail"].append(_lead(qat.collect()))

    # ---- head ----------------------------------------------------------------
    x = L.apply_norm(x, params["final_norm"], cfg)
    qat = L.LayerQAT(_at(ranges["head"], 0) if qat_on else None, quant_phase, cfg.qat_bits)
    if skip_head:
        # the chunked cross-entropy fuses the head product and the loss per
        # sequence chunk; the head's QAT site still applies here
        out = qat.site("head_in", x)
    else:
        out = L.lm_head(x, params["embed"], cfg, rules, qat)
    if qat_on:
        new_ranges["head"] = _lead(qat.collect())
    extras = {"ranges": new_ranges, "states": states, "aux": aux_total}
    if moe_stats:
        extras["moe"] = {"load": torch.stack([st["load"] for st in moe_stats]),
                         "experts": torch.stack([st["experts"] for st in moe_stats]),
                         "rows_held": torch.stack([st["rows_held"] for st in moe_stats]).sum(),
                         "rows_dropped": torch.stack([st["rows_dropped"] for st in moe_stats]).sum()}
    return out, extras


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------


def _nll_sums(logits: Tensor, labels: Tensor) -> tuple[Tensor, Tensor]:
    """(Σ NLL over the labelled positions, their count), float32; labels
    < 0 are masked."""
    if is_dtensor(logits):
        return _sharded_nll_sums(logits, labels)
    lf = logits.to(torch.float32)
    lse = torch.logsumexp(lf, dim=-1)
    target = torch.gather(lf, -1, labels.clamp_min(0).long()[..., None])[..., 0]
    valid = (labels >= 0).to(torch.float32)
    return torch.sum((lse - target) * valid), torch.sum(valid)


def _sharded_nll_sums(logits: Tensor, labels: Tensor) -> tuple[Tensor, Tensor]:
    """`_nll_sums` of DTensor logits, an explicit site (the label gather has
    no DTensor rule on a vocab-sharded dim), vocab-parallel: each rank
    keeps its (batch, seq) shard and its vocab slice, in float32; the
    log-sum-exp combines the slices' own (an all-reduce of their max, no
    gradient: any shift gives the same value, then of their shifted
    exponentials), the target logit comes from the slice that holds the
    label (an all-reduce), and the two sums come back as partial sums over
    the ranks that hold different rows.  So no rank holds the vocab whole:
    at the production layouts a (rows, vocab) float32 copy on every rank
    was the train step's largest tensor.  With the vocab on one slice the
    combination adds 0 and scales the gradient by 1, exactly: bitwise
    `_nll_sums`."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    dm = logits.device_mesh
    rows = tuple(p if isinstance(p, Shard) and p.dim < 2 else Replicate() for p in logits.placements)
    on_vocab = [isinstance(p, Shard) and p.dim == 2 for p in logits.placements]
    place = tuple(Shard(2) if v else r for r, v in zip(rows, on_vocab))
    lf = logits.redistribute(dm, place).to_local().to(torch.float32)
    lab = replicated(labels, dm).redistribute(dm, rows).to_local().long()
    offset, n = L._local_span(logits.shape[2], dm, place, 2)

    def over_vocab(t: Tensor, op: str = "sum") -> Tensor:  # the local (rows) values reduced over the vocab slices
        pl = tuple(Partial(op) if v else r for r, v in zip(rows, on_vocab))
        return DTensor.from_local(t, dm, pl, run_check=False).redistribute(dm, rows).to_local()

    lse_slice = torch.logsumexp(lf, dim=-1)
    m = over_vocab(lse_slice.detach(), "max")
    lse = m + torch.log(over_vocab(torch.exp(lse_slice - m)))
    mine = (lab >= offset) & (lab < offset + n)
    picked = torch.gather(lf, -1, (lab - offset).clamp(0, n - 1)[..., None])[..., 0]
    target = over_vocab(torch.where(mine, picked, torch.zeros((), dtype=lf.dtype, device=lf.device)))
    valid = (lab >= 0).to(torch.float32)
    sums = torch.sum((lse - target) * valid), torch.sum(valid)
    partial = [Partial() if isinstance(p, Shard) else Replicate() for p in rows]
    return tuple(DTensor.from_local(t, dm, partial, run_check=False) for t in sums)


def _chunk_nll(x: Tensor, w: Tensor, labels: Tensor, rules: Optional[ShardingRules]) -> tuple[Tensor, Tensor]:
    return _nll_sums(constrain(x @ w, rules, "batch", "seq", "vocab"), labels)


def loss_fn(params: Params, batch: dict[str, Tensor], cfg: ModelConfig, *,
            rules: Optional[ShardingRules] = None, ranges: Optional[Params] = None,
            quant_phase: Optional[Tensor] = None, remat: bool = True, attn_chunk: int = 0,
            aux_coef: float = 0.01, unroll: bool = False, ce_chunk: int = 0,
            router_bias: Optional[Tensor] = None) -> tuple[Tensor, dict[str, Any]]:
    """Masked mean next-token NLL in float32 (labels < 0 masked), plus
    `aux_coef`·aux / n_layers for MoE archs; for an MLA model plus
    `cfg.seq_aux_coef` times its layers' summed sequence-wise balance loss
    (`router_bias` as `forward` takes it).  Returns (loss, forward's
    extras).

    `ce_chunk > 0` (with S a multiple of it) fuses the head product and the
    cross-entropy per sequence chunk: each chunk runs under
    `torch.utils.checkpoint`, so its (B, chunk, V) logits exist in the
    forward and again in the backward, one chunk at a time, never the
    (B, S, V) whole.  Every quotient has a tensor divisor (on the card a
    division by a Python number multiplies by its rounded reciprocal)."""
    with sharded_scope():
        return _loss(params, batch, cfg, rules, ranges, quant_phase, remat, attn_chunk, aux_coef, ce_chunk,
                     router_bias)


def _loss(params, batch, cfg, rules, ranges, quant_phase, remat, attn_chunk, aux_coef, ce_chunk, router_bias):
    labels = batch["labels"]
    s = labels.shape[1]
    one = torch.ones((), dtype=torch.float32, device=labels.device)
    if ce_chunk and s > ce_chunk and s % ce_chunk == 0:
        hidden, extras = forward(params, batch, cfg, rules=rules, ranges=ranges, quant_phase=quant_phase,
                                 remat=remat, attn_chunk=attn_chunk, skip_head=True, router_bias=router_bias)
        w = (params["embed"]["embedding"].T if cfg.tie_embeddings else params["embed"]["head"]).to(cfg.compute_dtype)
        nll_sum = v_sum = torch.zeros((), dtype=torch.float32, device=labels.device)
        for c in range(s // ce_chunk):
            sl = slice(c * ce_chunk, (c + 1) * ce_chunk)
            nll, v = checkpoint(_in_this_mesh(_chunk_nll), hidden[:, sl], w, labels[:, sl], rules, use_reentrant=False,
                                preserve_rng_state=False)
            nll_sum, v_sum = nll_sum + nll, v_sum + v
        loss = nll_sum / torch.maximum(v_sum, one)
    else:
        logits, extras = forward(params, batch, cfg, rules=rules, ranges=ranges, quant_phase=quant_phase,
                                 remat=remat, attn_chunk=attn_chunk, router_bias=router_bias)
        nll_sum, v_sum = _nll_sums(logits, labels)
        loss = nll_sum / torch.maximum(v_sum, one)
    if cfg.is_mla:
        loss = loss + cfg.seq_aux_coef * extras["aux"]
    elif cfg.is_moe:
        loss = loss + aux_coef * extras["aux"] / torch.full((), float(max(cfg.n_layers, 1)), device=loss.device)
    return loss, extras


# ---------------------------------------------------------------------------
# serve: caches + decode
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, *, device: DeviceLike = None) -> Params:
    """Zero decode caches: per pattern slot a tree whose leaves lead with
    n_periods, per tail layer the unstacked tree.  Attention layers hold
    K/V in the compute dtype, (…, B, T, Hk, hd), T = max_seq for global
    layers, min(max_seq, window) (a ring) for local ones; recurrent layers
    their float32 states (RWKV-6 "wkv", "x_tm", "x_cm"; RG-LRU "h",
    "conv"), which no max_seq bounds."""
    _no_latent_cache(cfg)
    dev = resolve_device(device)
    scan = [_block_state_init(cfg, bt, batch, max_seq, dev, (cfg.n_periods,)) for bt in cfg.block_pattern]
    tail = [_block_state_init(cfg, cfg.block_pattern[i], batch, max_seq, dev) for i in range(cfg.n_tail)]
    return {"scan": scan, "tail": tail}


def _no_latent_cache(cfg: ModelConfig) -> None:
    if cfg.is_mla:
        raise NotImplementedError(f"{cfg.name}: latent attention has no decode cache yet (the (kv_lora_rank + "
                                  "qk_rope_head_dim) latent cache); it trains and runs full forwards only")


def cache_specs(cfg: ModelConfig) -> Params:
    scan = [_add_leading(_block_state_specs(cfg, bt)) for bt in cfg.block_pattern]
    tail = [_block_state_specs(cfg, cfg.block_pattern[i]) for i in range(cfg.n_tail)]
    return {"scan": scan, "tail": tail}


def _block_decode(x: Tensor, bp: Params, cfg: ModelConfig, bt: str, *, cache, pos, rules, qat):
    if bt in ATTN:
        h = L.apply_norm(x, bp["ln1"], cfg)
        h, cache = L.attn_decode(h, bp["attn"], cfg, local=(bt == ATTN_LOCAL), cache=cache, pos=pos,
                                 rules=rules, qat=qat)
        x = x + h
        h = L.apply_norm(x, bp["ln2"], cfg)
        if cfg.is_moe:
            h, _ = moe_mod.moe_forward(h, bp["ffn"], cfg, rules, qat)
        else:
            h = L.mlp_forward(h, bp["ffn"], cfg, rules, qat)
        return x + h, cache
    if bt == RWKV6:
        h = L.apply_norm(x, bp["ln1"], cfg)
        h, cache = rwkv_mod.decode_step(h, bp["rwkv"], cfg, cache, rules, qat, "tmix")
        x = x + h
        h = L.apply_norm(x, bp["ln2"], cfg)
        h, cache = rwkv_mod.decode_step(h, bp["rwkv"], cfg, cache, rules, qat, "cmix")
        return x + h, cache
    if bt == RGLRU:
        h = L.apply_norm(x, bp["ln1"], cfg)
        h, cache = rglru_mod.decode_step(h, bp["rnn"], cfg, cache, rules, qat)
        x = x + h
        h = L.apply_norm(x, bp["ln2"], cfg)
        h = L.mlp_forward(h, bp["ffn"], cfg, rules, qat)
        return x + h, cache
    raise ValueError(bt)


def decode_step(params: Params, tokens: Tensor, cache: Params, pos, cfg: ModelConfig, *,
                rules: Optional[ShardingRules] = None, ranges: Optional[Params] = None,
                quant_phase: Optional[Tensor] = None) -> tuple[Tensor, Params]:
    """One-token decode. tokens: (B, 1); pos: an int, the current position
    of every row, or a (B,) int tensor of per-row positions for
    continuously batched decode (serve/lm) — attention layers scatter and
    mask per lane; recurrent blocks are position-independent either way.
    Writes the caches and states in place and returns (logits (B, 1, V),
    cache)."""
    _no_latent_cache(cfg)
    with sharded_scope():
        return _decode(params, tokens, cache, pos, cfg, rules, ranges, quant_phase)


def _decode(params, tokens, cache, pos, cfg, rules, ranges, quant_phase):
    qat_on = ranges is not None
    x = L.embed_tokens(tokens, params["embed"], cfg, rules)
    for i in range(cfg.n_periods):
        for si, bt in enumerate(cfg.block_pattern):
            qat = L.LayerQAT(_at(ranges["scan"][si], i) if qat_on else None, quant_phase, cfg.qat_bits)
            x, _ = _block_decode(x, _at(params["scan"][si], i), cfg, bt, cache=_at(cache["scan"][si], i),
                                 pos=pos, rules=rules, qat=qat)
    for i in range(cfg.n_tail):
        bt = cfg.block_pattern[i]
        qat = L.LayerQAT(_at(ranges["tail"][i], 0) if qat_on else None, quant_phase, cfg.qat_bits)
        x, _ = _block_decode(x, params["tail"][i], cfg, bt, cache=cache["tail"][i], pos=pos, rules=rules,
                             qat=qat)
    x = L.apply_norm(x, params["final_norm"], cfg)
    qat = L.LayerQAT(_at(ranges["head"], 0) if qat_on else None, quant_phase, cfg.qat_bits)
    return L.lm_head(x, params["embed"], cfg, rules, qat), cache


def prefill(params: Params, batch: dict[str, Tensor], cfg: ModelConfig, *,
            rules: Optional[ShardingRules] = None, attn_chunk: int = 0, cache: Optional[Params] = None):
    """Prompt processing; returns last-position logits.

    Without `cache` this is the logits-only path.  With `cache` (from
    `init_cache`), the whole prompt is processed in ONE batched pass that
    also fills the KV caches and recurrent states — returns (last_logits,
    cache) ready for `decode_step` at pos = S."""
    if cache is not None:
        _no_latent_cache(cfg)
    logits, extras = forward(params, batch, cfg, rules=rules, states=cache, attn_chunk=attn_chunk)
    last = logits[:, -1, :]
    return last if cache is None else (last, extras["states"])


__all__ = ["init_params", "param_specs", "init_ranges", "ranges_specs", "serving_params", "forward", "loss_fn",
           "init_cache", "cache_specs", "decode_step", "prefill", "block_sites"]
