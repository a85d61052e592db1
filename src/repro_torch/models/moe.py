"""Mixture-of-Experts FFN (dbrx 16e/top-4, moonshot 64e/top-6): port of
`repro.models.moe`'s dense dispatch.

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

The reference's expert-parallel `shard_map` path (taken under an ambient
mesh with a "model" axis for T ≥ 65,536 tokens) is not ported: that case
raises (ROADMAP queue 1 item 5).  Since the dense dispatch runs every
expert over its capacity buffer, a decode step reads every expert's
weights, not only the active ones.
"""

from __future__ import annotations

import math
from typing import Any, Optional

import torch
import torch.nn.functional as F

from repro_torch.core.parallelism import Logical, ShardingRules, ambient_mesh, constrain
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import LayerQAT, _act, _uniform

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


def route(flat: Tensor, router: Tensor, cfg: ModelConfig) -> dict[str, Tensor]:
    """The router's decisions for (T, d) tokens: the renormalised top-k
    gates and their experts (from float32 probabilities), the balance loss,
    and each (token, choice) pair's slot in its expert's buffer with its
    keep flag."""
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
    c = capacity(t, cfg)
    return {"gates": gate_vals, "experts": expert_idx, "aux": aux,
            "pos": pos_in_e, "keep": pos_in_e < c, "capacity": c}


def moe_forward(x: Tensor, p: Params, cfg: ModelConfig, rules: Optional[ShardingRules],
                qat: LayerQAT) -> tuple[Tensor, Tensor]:
    """x: (B, S, d) -> (y, aux_loss).  The dense dispatch; the reference's
    condition for its expert-parallel path raises."""
    mesh = ambient_mesh() if rules is not None else None
    if (mesh is not None and "model" in mesh.axis_names and x.shape[0] * x.shape[1] >= SHARDED_MIN_TOKENS
            and cfg.n_experts % mesh.shape["model"] == 0):
        raise NotImplementedError(
            f"{cfg.name}: {x.shape[0] * x.shape[1]} tokens under a mesh with a 'model' axis take the reference's "
            "expert-parallel shard_map dispatch, which is not ported (ROADMAP queue 1 item 5)")
    return _moe_forward_dense(x, p, cfg, rules, qat)


def _moe_forward_dense(x: Tensor, p: Params, cfg: ModelConfig, rules: Optional[ShardingRules],
                       qat: LayerQAT) -> tuple[Tensor, Tensor]:
    b, s, d = x.shape
    t, k, e = b * s, cfg.experts_per_token, cfg.n_experts
    dt = cfg.compute_dtype

    flat = qat.site("router_in", x.reshape(t, d))
    r = route(flat, p["router"], cfg)
    c = r["capacity"]
    keep = r["keep"].to(dt)
    experts = r["experts"].reshape(-1)
    slots = r["pos"].clamp_max(c - 1).reshape(-1)

    # scatter tokens -> (E, C, d): kept pairs to their slots, dropped ones to
    # the spare slot C (cut off)
    rows = (flat.to(dt) + 0.0)[:, None, :].expand(t, k, d).reshape(t * k, d)
    buf = torch.zeros((e, c + 1, d), dtype=dt, device=x.device)
    buf.index_put_((experts, torch.where(r["keep"].reshape(-1), slots, c)), rows)
    buf = constrain(buf[:, :c], rules, "experts", "exp_cap", None)

    # expert FFN, batched over E
    buf_q = qat.site("expert_in", buf)
    h = _act(torch.bmm(buf_q, p["wg"].to(dt)), cfg.act) * torch.bmm(buf_q, p["wu"].to(dt))
    h = constrain(h, rules, "experts", "exp_cap", "expert_ffn")
    h = qat.site("expert_down_in", h)
    out_buf = constrain(torch.bmm(h, p["wd"].to(dt)), rules, "experts", "exp_cap", None)

    # gather back + weighted combine
    gathered = out_buf[experts, slots].reshape(t, k, d) * keep[..., None]
    y = (gathered * r["gates"].to(dt)[..., None]).sum(1).reshape(b, s, d)
    return constrain(y, rules, "batch", "seq", "embed"), r["aux"]


__all__ = ["moe_init", "moe_specs", "capacity", "top_k", "route", "moe_forward"]
