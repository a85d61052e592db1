"""Mixture-of-Experts FFN (dbrx 16e/top-4, moonshot 64e/top-6): port of
`repro.models.moe`'s dense dispatch; and the DeepSeek-V3 MoE of
`config.DeepSeekV3Config` (`ds_moe_forward`, last section).

Capacity-based GShard-style dispatch: each (token, choice) pair takes the
next free slot of its expert's (C, d) buffer, in token-major order; pairs
past the capacity C are dropped (they add zero).  Every expert then runs
over its whole buffer (a batched product over E), and each token gathers
its k outputs back, weighted by its renormalised gates.  QAT: the experts'
activations flow through the layer's shared sites ("expert_in" over the
whole (E, C, d) buffer, empty slots included; "expert_down_in") — ranges
are per layer, not per expert, as in the reference.

Numerics kept from the reference: the router runs in float32 (its weight
is never cast); top-k ties go to the lower expert index (`lax.top_k`'s
order: a stable descending sort here, since `torch.topk` promises no order
among ties on the card); the slot positions are an exclusive integer
cumsum (bitwise the reference's `_blocked_cumsum`, an XLA workaround not
ported), taken along the pairs of an (E, T·K) hit mask.  The reference
scatter-adds every pair's row onto a zero buffer, a dropped pair's row
zeroed into slot C − 1; since every kept (expert, slot) pair is unique,
the port assigns the kept rows (`index_put_`, no accumulation: no atomics,
no serialised adds at an overflowing expert's last slot) and sends the
dropped ones to a spare slot C that is cut off before use.  The rows are
`x + 0` first, so a −0.0 lands as the reference's 0 + (−0.0) = +0.0: the
reference's buffer bitwise.

Since the dense dispatch runs every expert over its capacity buffer, a
decode step reads every expert's weights, not only the active ones.

On a sharded run (DTensor operands under a mesh, `core.parallelism`) the
dense dispatch computes the routing, the buffer scatter and the combine
gather on the whole token stream, replicated on every rank (DTensor has no
sharding rule for the stable sort, the integer cumsum along the tokens or
`index_put_`): three explicit `Replicate()` sites; the expert FFN runs on
the buffer laid out (experts, exp_cap) by the rules.

The reference's expert-parallel `shard_map` path (`_moe_forward_sharded`,
taken under an ambient mesh with a "model" axis, rules given, T ≥ 65,536
tokens and the experts divisible by the model axis) is per-rank code here:
each rank takes its batch shard of the token stream (replicated over
"model") and the weights of its E / model experts, gathered over "data";
the capacity is per batch shard (`capacity(T / batch shards)`), the
"router_in" / "expert_in" sites apply to the token stream, and the
combine is a sum over "model".  The balance loss is the mean over the
batch shards, the "expert_down_in" range the min / max over every rank.
Its gradients are the reference's: the token stream's and the router's
are summed over the ranks that share them, and the balance loss enters on
model rank 0 only.  On a mesh of one device with no process group the same
body runs with no collectives; on a mesh of several devices it takes
DTensors only, and a plain input raises.
"""

from __future__ import annotations

import math
from typing import Any, Optional

import torch
import torch.nn.functional as F

from repro_torch.core import fixedpoint as fxp
from repro_torch.core.parallelism import (Logical, Mesh, ShardingRules, ambient_mesh, constrain, is_dtensor,
                                          replicated)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import LayerQAT, _act, _uniform, mlp_forward, mlp_init
from repro_torch.models.spans import spanned

Tensor = torch.Tensor
Params = dict[str, Any]

SHARDED_MIN_TOKENS = 65_536  # the reference's switch to its shard_map path


def moe_init(gen: torch.Generator, cfg: ModelConfig, lead: tuple = ()) -> Params:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "router": _uniform(gen, lead + (d, e), d),
        "wg": _uniform(gen, lead + (e, d, f), d),
        "wu": _uniform(gen, lead + (e, d, f), d),
        "wd": _uniform(gen, lead + (e, f, d), f),
    }


def moe_specs(cfg: ModelConfig) -> Params:
    return {
        "router": Logical("embed", "experts"),
        "wg": Logical("experts", "embed", "expert_ffn"),
        "wu": Logical("experts", "embed", "expert_ffn"),
        "wd": Logical("experts", "expert_ffn", "embed"),
    }


def capacity(n_tokens: int, cfg: ModelConfig) -> int:
    c = int(math.ceil(n_tokens * cfg.experts_per_token / cfg.n_experts * cfg.moe_capacity_factor))
    return max(8, -(-c // 8) * 8)  # round up to 8 for tiling


def top_k(probs: Tensor, k: int) -> tuple[Tensor, Tensor]:
    """The k largest entries of each row and their indices, ties to the
    lower index (`lax.top_k`'s order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(flat: Tensor, router: Tensor, cfg: ModelConfig, c: Optional[int] = None) -> dict[str, Tensor]:
    """The router's decisions for (T, d) tokens: the renormalised top-k
    gates and their experts (from float32 probabilities), the balance loss,
    and each (token, choice) pair's slot in its expert's buffer with its
    keep flag against the capacity `c` (default `capacity(T)`)."""
    t, k, e = flat.shape[0], cfg.experts_per_token, cfg.n_experts
    logits = flat.to(torch.float32) @ router.to(torch.float32)
    probs = torch.softmax(logits, -1)  # (T, E)
    gate_vals, expert_idx = top_k(probs, k)  # (T, K)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True)

    # Switch-style load-balance aux loss
    density = F.one_hot(expert_idx[:, 0], e).to(torch.float32).mean(0)
    aux = (density * probs.mean(0)).sum() * e

    # position of each (token, choice) within its expert buffer: the pairs of
    # that expert before it, in token-major order
    flat_idx = expert_idx.reshape(1, t * k)
    hit = flat_idx == torch.arange(e, device=flat.device)[:, None]  # (E, T·K)
    pos_in_e = (torch.cumsum(hit, 1, dtype=torch.int32).gather(0, flat_idx)[0] - 1).reshape(t, k)
    c = capacity(t, cfg) if c is None else c
    return {"gates": gate_vals, "experts": expert_idx, "aux": aux,
            "pos": pos_in_e, "keep": pos_in_e < c, "capacity": c}


def _ep_mesh(rules: Optional[ShardingRules], n_tokens: int, cfg: ModelConfig) -> Optional[Mesh]:
    """The ambient mesh when the reference's condition for its
    expert-parallel path holds, else None."""
    mesh = ambient_mesh() if rules is not None else None
    if (mesh is not None and "model" in mesh.axis_names and n_tokens >= SHARDED_MIN_TOKENS
            and cfg.n_experts % mesh.shape["model"] == 0):
        return mesh
    return None


def moe_forward(x: Tensor, p: Params, cfg: ModelConfig, rules: Optional[ShardingRules],
                qat: LayerQAT) -> tuple[Tensor, Tensor]:
    """x: (B, S, d) -> (y, aux_loss).  The expert-parallel path under the
    reference's condition (`_ep_mesh`), the dense dispatch otherwise."""
    mesh = _ep_mesh(rules, x.shape[0] * x.shape[1], cfg)
    if mesh is not None:
        return _moe_forward_sharded(x, p, cfg, rules, qat, mesh)
    return _moe_forward_dense(x, p, cfg, rules, qat)


def _whole(x: Tensor) -> Tensor:
    """A DTensor as the full plain tensor on every rank (a `Replicate()`
    site, differentiable: every rank then computes the same), a plain
    tensor as it is."""
    return x.full_tensor() if is_dtensor(x) else x


def _like(value: Tensor, ref: Tensor) -> Tensor:
    """`value` (the same on every rank) as a replicated DTensor on `ref`'s
    mesh when `ref` is a DTensor, else as it is."""
    return replicated(value, ref.device_mesh) if is_dtensor(ref) else value


def _moe_forward_dense(x: Tensor, p: Params, cfg: ModelConfig, rules: Optional[ShardingRules],
                       qat: LayerQAT) -> tuple[Tensor, Tensor]:
    b, s, d = x.shape
    t, k, e = b * s, cfg.experts_per_token, cfg.n_experts
    dt = cfg.compute_dtype

    flat = qat.site("router_in", x.reshape(t, d))
    # Replicate() site: the routing and the scatter below run on the whole
    # token stream on every rank
    flat_w = _whole(flat)
    r = route(flat_w, _whole(p["router"]), cfg)
    c = r["capacity"]
    keep = r["keep"].to(dt)
    experts = r["experts"].reshape(-1)
    slots = r["pos"].clamp_max(c - 1).reshape(-1)

    # scatter tokens -> (E, C, d): kept pairs to their slots, dropped ones to
    # the spare slot C (cut off)
    rows = (flat_w.to(dt) + 0.0)[:, None, :].expand(t, k, d).reshape(t * k, d)
    buf = torch.zeros((e, c + 1, d), dtype=dt, device=flat_w.device)
    buf.index_put_((experts, torch.where(r["keep"].reshape(-1), slots, c)), rows)
    buf = constrain(_like(buf[:, :c], flat), rules, "experts", "exp_cap", None)

    # expert FFN, batched over E
    buf_q = qat.site("expert_in", buf)
    h = _act(torch.bmm(buf_q, p["wg"].to(dt)), cfg.act) * torch.bmm(buf_q, p["wu"].to(dt))
    h = constrain(h, rules, "experts", "exp_cap", "expert_ffn")
    h = qat.site("expert_down_in", h)
    out_buf = constrain(torch.bmm(h, p["wd"].to(dt)), rules, "experts", "exp_cap", None)

    # gather back + weighted combine (Replicate() site: the gather by slot)
    gathered = _whole(out_buf)[experts, slots].reshape(t, k, d) * keep[..., None]
    y = (gathered * r["gates"].to(dt)[..., None]).sum(1).reshape(b, s, d)
    return constrain(_like(y, flat), rules, "batch", "seq", "embed"), _like(r["aux"], flat)


def _moe_forward_sharded(x: Tensor, p: Params, cfg: ModelConfig, rules: ShardingRules, qat: LayerQAT,
                         mesh: Mesh) -> tuple[Tensor, Tensor]:
    """The expert-parallel dispatch (module docstring): per-rank code on
    the local shards, with the reference's collectives."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    if mesh.size > 1 and not is_dtensor(x):
        mesh.runnable()  # raises for a layout: no process group behind it
        raise ValueError(f"the expert-parallel MoE body on {mesh!r} needs its input laid out on the mesh as a "
                         "DTensor (core.parallelism.distribute_tree), not a plain tensor")
    names = mesh.axis_names
    batch_axes = ("pod", "data") if "pod" in names else ("data",)
    n_model = mesh.shape["model"]
    e, k = cfg.n_experts, cfg.experts_per_token
    e_local = e // n_model
    dt = cfg.compute_dtype
    b, s, d = x.shape

    # QAT: the router / expert input sites on the token stream (replicated
    # over "model") — the same content as the dispatched buffer
    x = qat.site("router_in", x)
    x = qat.site("expert_in", x)
    hidden_qat = qat.params_for("expert_down_in")
    n_batch_shards = math.prod(mesh.shape[a] for a in batch_axes)
    c_local = capacity(b * s // n_batch_shards, cfg)

    dm = mesh.device_mesh if is_dtensor(x) else None
    if dm is not None:
        # to_local in: the tokens by batch shard, the router whole, the
        # expert weights by "model" shard and whole over the batch axes
        # (the FSDP gather); the gradients of what several ranks share are
        # summed over them (Partial)
        batch = tuple(Shard(0) if n in batch_axes else Replicate() for n in names)
        xl = x.to(dt).redistribute(dm, batch).to_local(
            grad_placements=tuple(Partial() if n == "model" else pl for n, pl in zip(names, batch)))
        router = p["router"].to(torch.float32).redistribute(dm, (Replicate(),) * len(names)).to_local(
            grad_placements=(Partial(),) * len(names))
        by_model = tuple(Shard(0) if n == "model" else Replicate() for n in names)
        model_partial = tuple(Shard(0) if n == "model" else Partial() for n in names)
        wg, wu, wd = (p[w].redistribute(dm, by_model).to_local(grad_placements=model_partial).to(dt)
                      for w in ("wg", "wu", "wd"))
        model_rank = dm.get_local_rank("model")
    else:
        xl, router = x.to(dt), p["router"].to(torch.float32)
        wg, wu, wd = (_whole(p[w]).to(dt) for w in ("wg", "wu", "wd"))
        model_rank = 0

    tl = xl.shape[0] * xl.shape[1]
    flat = xl.reshape(tl, d)
    r = route(flat, router, cfg, c_local)
    aux = r["aux"] if model_rank == 0 else r["aux"].detach()  # its gradient enters once over "model"

    # ---- local dispatch (no collectives) -----------------------------------
    rel_e = r["experts"] - model_rank * e_local
    mine = (rel_e >= 0) & (rel_e < e_local)
    use = (r["keep"] & mine).reshape(-1)
    rel_clip = rel_e.clamp(0, e_local - 1).reshape(-1)
    slots = r["pos"].clamp_max(c_local - 1).reshape(-1)
    rows = (flat + 0.0)[:, None, :].expand(tl, k, d).reshape(tl * k, d)
    buf = torch.zeros((e_local, c_local + 1, d), dtype=dt, device=flat.device)
    buf.index_put_((rel_clip, torch.where(use, slots, c_local)), rows)
    buf = buf[:, :c_local]

    # ---- expert FFN ----------------------------------------------------------
    h = _act(torch.bmm(buf, wg), cfg.act) * torch.bmm(buf, wu)
    if hidden_qat is not None:
        a_min, a_max, quant_phase = (_whole(v) if torch.is_tensor(v) else v for v in hidden_qat)
        h32 = h.to(torch.float32)
        h_q = fxp.fake_quant_affine(h32, a_min, a_max, cfg.qat_bits)
        h_full = fxp.fake_quant(h32, fxp.FXP32)
        phase = torch.as_tensor(quant_phase, dtype=torch.bool, device=h.device)
        h = torch.where(phase, h_q, h_full).to(dt)
        h_min, h_max = h32.detach().min(), h32.detach().max()
        if dm is not None:  # pmin / pmax over every axis
            h_min, h_max = h_min.clone(), h_max.clone()
            torch.distributed.all_reduce(h_min, torch.distributed.ReduceOp.MIN)
            torch.distributed.all_reduce(h_max, torch.distributed.ReduceOp.MAX)
    out_buf = torch.bmm(h, wd)

    # ---- combine: my experts' outputs, summed over "model" ---------------------
    gathered = out_buf[rel_clip, slots].reshape(tl, k, d) * use.reshape(tl, k, 1).to(dt)
    y = (gathered * r["gates"].to(dt)[..., None]).sum(1).reshape(xl.shape)
    if dm is not None:
        partial = tuple(Partial() if n == "model" else pl for n, pl in zip(names, batch))
        y = DTensor.from_local(y, dm, partial, run_check=False).redistribute(dm, batch)
        # pmean over the batch axes: a sum, then the quotient by a tensor
        aux = DTensor.from_local(aux, dm, tuple(Partial() if n in batch_axes else Replicate() for n in names),
                                 run_check=False).redistribute(dm, (Replicate(),) * len(names))
        aux = aux / torch.full((), float(n_batch_shards), dtype=torch.float32, device=flat.device)
    if hidden_qat is not None:
        qat.fold_external("expert_down_in", h_min, h_max)
    return y, aux


# ---------------------------------------------------------------------------
# DeepSeek-V3 MoE: sigmoid routing with the aux-loss-free bias, shared
# experts, a dropless dispatch over the experts this chip holds
# ---------------------------------------------------------------------------


def ds_moe_init(gen: torch.Generator, cfg: ModelConfig, lead: tuple = ()) -> Params:
    """The router over all `n_experts`, the held experts' weights
    (`cfg.experts_held`, in that order) and the shared experts, one SwiGLU
    of width `n_shared_experts`·`d_ff`."""
    d, f, e = cfg.d_model, cfg.d_ff, len(cfg.experts_held)
    return {"router": _uniform(gen, lead + (d, cfg.n_experts), d),
            "wg": _uniform(gen, lead + (e, d, f), d),
            "wu": _uniform(gen, lead + (e, d, f), d),
            "wd": _uniform(gen, lead + (e, f, d), f),
            "shared": mlp_init(gen, cfg, lead, cfg.n_shared_experts * f)}


def ds_moe_specs(cfg: ModelConfig) -> Params:
    return {"router": Logical("embed", "experts"),
            "wg": Logical("experts", "embed", "expert_ffn"),
            "wu": Logical("experts", "embed", "expert_ffn"),
            "wd": Logical("experts", "expert_ffn", "embed"),
            "shared": {"wg": Logical("embed", "mlp"), "wu": Logical("embed", "mlp"), "wd": Logical("mlp", "embed")}}


def route_sigmoid(flat: Tensor, router: Tensor, bias: Tensor, cfg: ModelConfig) -> dict[str, Tensor]:
    """DeepSeek-V3's routing of (T, d) tokens (HF `noaux_tc` with one
    group): s = sigmoid(x·W_r) in float32 over all experts; the top k
    chosen by s + bias (ties to the lower index), the bias steering the
    choice but not the gates; gates the chosen s over their sum (plus
    1e-20, `norm_topk_prob`) times `routed_scaling`.  "load" counts the
    (token, choice) pairs of each expert."""
    k, e = cfg.experts_per_token, cfg.n_experts
    scores = torch.sigmoid(flat.to(torch.float32) @ router.to(torch.float32))  # (T, E)
    _, idx = top_k(scores.detach() + bias, k)
    gates = scores.gather(1, idx)
    if cfg.norm_topk_prob:
        gates = gates / (gates.sum(-1, keepdim=True) + 1e-20)
    gates = gates * cfg.routed_scaling
    load = _count(idx.reshape(-1), e)
    return {"scores": scores, "experts": idx, "gates": gates, "load": load}


def _count(idx: Tensor, n: int) -> Tensor:
    """`torch.bincount(idx, minlength=n)` for ids below n, without its read
    of the largest id on the host."""
    return torch.zeros(n, dtype=torch.int64, device=idx.device).scatter_add_(0, idx, torch.ones_like(idx))


def seq_balance_loss(scores: Tensor, experts: Tensor, batch: int, cfg: ModelConfig) -> Tensor:
    """DeepSeek-V3's sequence-wise balance loss (arXiv:2412.19437 eqs.
    17–20) of one layer, the mean over the `batch` sequences:
    Σ_i f_i·P_i, f_i = E/(k·S)·(pairs of expert i in the sequence),
    P_i = the mean over its tokens of s_i / Σ_j s_j."""
    k, e = cfg.experts_per_token, cfg.n_experts
    s = scores.shape[0] // batch
    hits = torch.zeros((batch, e), dtype=torch.float32, device=scores.device)
    hits.scatter_add_(1, experts.reshape(batch, s * k), torch.ones((batch, s * k), device=scores.device))
    f = hits * (e / (k * s))
    p = (scores / scores.sum(-1, keepdim=True)).reshape(batch, s, e).mean(1)
    return (f * p).sum(-1).mean()


def _held_experts(rows: Tensor, wg: Tensor, wu: Tensor, wd: Tensor, ends: Tensor, valid: Tensor, cfg: ModelConfig,
                  qat: LayerQAT) -> Tensor:
    """The held experts' SwiGLU over their contiguous rows of the (T·k, d)
    buffer `rows`: one grouped product a weight, expert i over the rows up
    to `ends[i]` (int32, on the device); the down product's input through
    one QAT site folded over the `valid` rows.  The rows past `ends[-1]`
    come out undefined."""
    dt = cfg.compute_dtype
    hidden = _act(_grouped(rows, wg.to(dt), ends), cfg.act) * _grouped(rows, wu.to(dt), ends)
    hidden = qat.site("expert_down_in", hidden, valid)
    return _grouped(hidden, wd.to(dt), ends)


def _grouped(a: Tensor, b: Tensor, ends: Tensor) -> Tensor:
    """a (M, K) times b (G, K, N) by groups of a's rows: group i is the rows
    from ends[i − 1] (0 for the first) to ends[i], rows past ends[-1]
    undefined.  `torch._grouped_mm`: one launch for all the groups."""
    return torch._grouped_mm(a, b, offs=ends)


def ds_moe_forward(x: Tensor, p: Params, cfg: ModelConfig, qat: LayerQAT,
                   bias: Tensor) -> tuple[Tensor, Tensor, dict[str, Tensor]]:
    """x: (B, S, d) -> (y, balance loss, stats).

    y = shared(x) + Σ over the chosen experts that this chip holds of
    gate·FFN_e(x).  Dropless, and nothing is read on the host: the
    (token, choice) pairs are sorted by expert, the held ones first
    (tokens in order within one) and the rest last, into a buffer of all
    T·k rows; the held experts run grouped products over their contiguous
    rows, whose ends are the row counts' running sums on the device; the
    gated rows go back to their pairs, the rows of pairs held elsewhere
    masked to zero, and are summed per token in a fixed order.  The
    `expert_in` site quantizes the tokens before the gather (the same
    values, row for row) and folds its range over the tokens with a held
    pair; `expert_down_in` over the held rows.  Nothing stands in for the
    experts held elsewhere: their part is left out.  stats: "load" (E,)
    pairs per expert over all experts, "experts" (T, k) the chosen
    experts, "rows_held" the rows computed, "rows_dropped" the held pairs
    left uncomputed (0)."""
    b, s, d = x.shape
    t, k = b * s, cfg.experts_per_token
    held = cfg.experts_held
    dt = cfg.compute_dtype
    flat = qat.site("router_in", x.reshape(t, d))
    gates, aux, experts, load = spanned(
        "lm.moe.route", lambda f, w: _route_outputs(f, w, bias, b, cfg), flat, p["router"])
    rel = experts.reshape(-1) - held.start
    is_held = (rel >= 0) & (rel < len(held))  # (T·k,)
    routed = qat.site("expert_in", flat, is_held.reshape(t, k).any(-1))

    def permute(f):
        key = torch.where(is_held, rel, len(held))  # pairs held elsewhere last
        order = torch.argsort(key, stable=True)
        counts = _count(key, len(held) + 1)[:len(held)]
        ends = torch.cumsum(counts, 0).to(torch.int32)
        valid = torch.arange(t * k, device=f.device) < ends[-1]
        rows = torch.where(valid[:, None], f[order // k].to(dt), 0)
        return rows, order, ends, valid

    rows, order, ends, valid = spanned("lm.moe.dispatch", permute, routed)
    out = spanned("lm.moe.experts", lambda r, g, u, w: _held_experts(r, g, u, w, ends, valid, cfg, qat),
                  rows, p["wg"], p["wu"], p["wd"])

    def combine(out, gates):
        gated = torch.where(valid[:, None], out, 0) * gates.reshape(-1)[order].to(dt)[:, None]
        per_pair = torch.empty((t * k, d), dtype=dt, device=x.device).index_copy(0, order, gated)
        return per_pair.reshape(t, k, d).sum(1)

    y = spanned("lm.moe.dispatch", combine, out, gates).reshape(b, s, d)
    y = mlp_forward(flat.reshape(b, s, d), p["shared"], cfg, None, qat, site_prefix="shared") + y
    stats = {"load": load, "experts": experts, "rows_held": ends[-1].to(torch.int64),
             "rows_dropped": is_held.sum() - ends[-1]}
    return y, aux, stats


def _route_outputs(flat, router, bias, batch, cfg):
    r = route_sigmoid(flat, router, bias, cfg)
    aux = seq_balance_loss(r["scores"], r["experts"], batch, cfg)
    return r["gates"], aux, r["experts"], r["load"]


__all__ = ["moe_init", "moe_specs", "capacity", "top_k", "route", "moe_forward", "ds_moe_init", "ds_moe_specs",
           "route_sigmoid", "seq_balance_loss", "ds_moe_forward"]
