"""RWKV-6 "Finch" block (arXiv:2404.05892), port of `repro.models.rwkv6`:
token shift with data-dependent interpolation (ddlerp), per-channel
data-dependent decay, and the WKV matrix recurrence in a chunk-parallel
formulation.

Per head (dim n): state S ∈ R^{n×n},
    o_t = r_t · (S_t + (u ⊙ k_t) v_tᵀ)
    S_{t+1} = diag(w_t) S_t + k_t v_tᵀ,     w_t = exp(-exp(w0 + lora_w(x)))

Chunked closed form over a chunk of length c with Lx_t = Σ_{i<t} log w_i:
    o_t  = (r_t ⊙ e^{Lx_t}) S_0
         + Σ_{j<t} [(r_t ⊙ e^{Lx_t}) · (k_j ⊙ e^{-Lx_{j+1}})] v_j
         + (r_t ⊙ u ⊙ k_t) v_t
    S_c  = diag(e^{Lx_c}) S_0 + Σ_j (k_j ⊙ e^{Lx_c - Lx_{j+1}}) v_jᵀ

The forward walks the S / c chunks in a Python loop (the reference's
`lax.scan`), c = min(128, S); S must be a multiple of c, as the reference
asserts — a prompt is never padded, which would change the state.  Decode
is the O(1) recurrence.  The WKV arithmetic and the state are float32;
`w0`, `wA`, `wB` and `u` are used in float32, every other product weight
in the compute dtype.

State in place: `time_mix`, `channel_mix` and `decode_step` write the new
state into the tensors of the `state` dict they are given (`copy_`) and
return that dict, as attention blocks write their KV caches: the per-layer
caches are views of the stacked cache tree.  `time_mix` and `channel_mix`
also take `state=None`, a training forward's fresh zero state: they then
start from zeros and return their new state as a new dict, writing nothing
(`layers.carry_state`), so autograd can differentiate them.
"""

from __future__ import annotations

import functools
from typing import Any, Optional

import torch
import torch.nn.functional as F

from repro_torch.core.parallelism import Logical, ShardingRules, constrain, is_dtensor, replicated
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import LayerQAT, _uniform, _whole_heads, carry_state, group_norm_heads

Tensor = torch.Tensor
Params = dict[str, Any]

LORA_R = 32
DECAY_LORA_R = 64
CHUNK = 128


def _n_heads(cfg: ModelConfig) -> int:
    return cfg.d_model // cfg.rwkv_head_dim


def rwkv_init(gen: torch.Generator, cfg: ModelConfig, lead: tuple = ()) -> Params:
    d, f = cfg.d_model, cfg.d_ff
    h, n = _n_heads(cfg), cfg.rwkv_head_dim
    full = lambda shape, v: torch.full(lead + shape, v, dtype=torch.float32, device=gen.device)  # noqa: E731
    return {
        # time-mix: ddlerp base vectors for (r,k,v,w,g) + shared lora
        "tm_base": full((5, d), 0.0),
        "tm_A": _uniform(gen, lead + (d, 5 * LORA_R), d),
        "tm_B": _uniform(gen, lead + (5, LORA_R, d), LORA_R) * 0.1,
        # decay: w0 + lora
        "w0": full((d,), -6.0),
        "wA": _uniform(gen, lead + (d, DECAY_LORA_R), d),
        "wB": _uniform(gen, lead + (DECAY_LORA_R, d), DECAY_LORA_R) * 0.1,
        "u": full((h, n), 0.0),  # bonus
        "wr": _uniform(gen, lead + (d, d), d),
        "wk": _uniform(gen, lead + (d, d), d),
        "wv": _uniform(gen, lead + (d, d), d),
        "wg": _uniform(gen, lead + (d, d), d),
        "wo": _uniform(gen, lead + (d, d), d),
        "gn_scale": full((d,), 1.0),
        "gn_bias": full((d,), 0.0),
        # channel-mix
        "cm_mu_k": full((d,), 0.5),
        "cm_mu_r": full((d,), 0.5),
        "cm_wk": _uniform(gen, lead + (d, f), d),
        "cm_wv": _uniform(gen, lead + (f, d), f),
        "cm_wr": _uniform(gen, lead + (d, d), d),
    }


def rwkv_specs(cfg: ModelConfig) -> Params:
    emb2 = Logical("embed", "state")
    return {
        "tm_base": Logical(None, "embed"),
        "tm_A": Logical("embed", None),
        "tm_B": Logical(None, None, "embed"),
        "w0": Logical("embed"),
        "wA": Logical("embed", None),
        "wB": Logical(None, "embed"),
        "u": Logical("heads_rwkv", None),
        "wr": emb2, "wk": emb2, "wv": emb2, "wg": emb2,
        "wo": Logical("state", "embed"),
        "gn_scale": Logical("embed"), "gn_bias": Logical("embed"),
        "cm_mu_k": Logical("embed"), "cm_mu_r": Logical("embed"),
        "cm_wk": Logical("embed", "mlp"),
        "cm_wv": Logical("mlp", "embed"),
        "cm_wr": Logical("embed", "state"),
    }


def init_state(cfg: ModelConfig, batch: int, device: torch.device, lead: tuple = ()) -> dict[str, Tensor]:
    h, n = _n_heads(cfg), cfg.rwkv_head_dim
    zeros = lambda *shape: torch.zeros(lead + shape, dtype=torch.float32, device=device)  # noqa: E731
    return {"wkv": zeros(batch, h, n, n),
            "x_tm": zeros(batch, cfg.d_model),  # last token (time-mix shift)
            "x_cm": zeros(batch, cfg.d_model)}  # last token (channel-mix)


def state_specs(cfg: ModelConfig) -> dict[str, Logical]:
    return {"wkv": Logical("batch", "heads_rwkv", None, None),
            "x_tm": Logical("batch", "embed"),
            "x_cm": Logical("batch", "embed")}


def _ddlerp(x: Tensor, x_prev: Tensor, p: Params, dt: torch.dtype) -> Tensor:
    """Data-dependent lerp producing the 5 mixed inputs (r,k,v,w,g).

    For DTensor operands an explicit site: each rank mixes its own rows
    (the batch and sequence shards of x; every other placement made
    `Replicate()`) with the lerp's weights whole, so no collective runs;
    the weights' gradients are partial sums over the row shards.  (On the
    (pod, data, model) mesh DTensor's planner lays the lora's gradient out
    as a strided shard of the merged rows, whose product it takes apart
    only by reading data.)"""
    if is_dtensor(x):
        return _rows_by_rank(lambda xl, pl, wl: _ddlerp(xl, pl, wl, dt), x, x_prev,
                             {k: p[k] for k in ("tm_A", "tm_B", "tm_base")})
    delta = (x_prev - x).to(dt)
    lora = torch.tanh(x @ p["tm_A"].to(dt))
    lora = lora.reshape(*x.shape[:-1], 5, LORA_R)
    mix = p["tm_base"].to(dt) + torch.einsum("...fr,frd->...fd", lora, p["tm_B"].to(dt))
    # x_f = x + delta * mix_f  for f in (r,k,v,w,g)
    return x[..., None, :] + delta[..., None, :] * mix  # (..., 5, d)


def _rows_by_rank(fn, x: Tensor, x_prev: Tensor, weights: Params) -> Tensor:
    """`fn(x, x_prev, weights)` on each rank's rows of x and x_prev (their
    shards of every dim but the last), the weights whole; the output laid
    out as those rows."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    dm = x.device_mesh
    rows = tuple(pl if isinstance(pl, Shard) and pl.dim < x.ndim - 1 else Replicate() for pl in x.placements)
    grad = [Partial() if isinstance(pl, Shard) else Replicate() for pl in rows]
    xl, pl = (replicated(t, dm).redistribute(dm, rows).to_local() for t in (x, x_prev))
    wl = {k: replicated(w, dm).redistribute(dm, [Replicate()] * dm.ndim).to_local(grad_placements=grad)
          for k, w in weights.items()}
    out = fn(xl, pl, wl)
    return DTensor.from_local(out, dm, rows, run_check=False)


def _shift(x: Tensor, x_last: Tensor) -> Tensor:
    """Token shift: x_prev[t] = x[t-1], seeded by the carried last token."""
    return torch.cat([x_last[:, None, :], x[:, :-1, :]], dim=1)


def _wkv_chunk(r: Tensor, k: Tensor, v: Tensor, logw: Tensor, u: Tensor, s0: Tensor) -> tuple[Tensor, Tensor]:
    """One chunk of the WKV recurrence.

    r,k,v: (B,c,H,n); logw: (B,c,H,n) (negative); u: (H,n);
    s0: (B,H,n,n), the state's dtype (float32 in the model) is the
    arithmetic's.  Returns (o: (B,c,H,n), s_next)."""
    c = r.shape[1]
    ft = s0.dtype
    rf, kf, vf = (t.to(ft) for t in (r, k, v))
    lw = logw.to(ft)
    lx = torch.cumsum(lw, dim=1)  # inclusive: Lx_{t+1} in the notation
    lx_excl = lx - lw  # exclusive: Lx_t

    r_dec = rf * torch.exp(lx_excl)  # r_t ⊙ e^{Lx_t}
    k_dec = kf * torch.exp(-lx)  # k_j ⊙ e^{-Lx_{j+1}}

    # inter-chunk: (r ⊙ e^{Lx}) @ S0
    o_inter = torch.einsum("bchn,bhnm->bchm", r_dec, s0)
    # intra-chunk: strictly-lower-triangular scores
    scores = torch.einsum("bchn,bdhn->bhcd", r_dec, k_dec)
    tri = torch.tril(torch.ones((c, c), dtype=ft, device=r.device), diagonal=-1)
    o_intra = torch.einsum("bhcd,bdhn->bchn", scores * tri, vf)
    # diagonal bonus term
    o_diag = (rf * u[None, None] * kf).sum(-1, keepdim=True) * vf

    o = o_inter + o_intra + o_diag

    # state update
    decay_all = torch.exp(lx[:, -1])  # e^{Lx_c}  (B,H,n)
    k_rem = kf * torch.exp(lx[:, -1:] - lx)  # k_j ⊙ e^{Lx_c - Lx_{j+1}}
    s_next = decay_all[..., None] * s0 + torch.einsum("bchn,bchm->bhnm", k_rem, vf)
    return o, s_next


def _wkv_scan(r: Tensor, k: Tensor, v: Tensor, logw: Tensor, u: Tensor, s0: Tensor, *,
              chunk: int) -> tuple[Tensor, Tensor]:
    """The WKV recurrence over the whole sequence, chunk by chunk
    (`_wkv_chunk`'s shapes, S a multiple of `chunk`): (o, the last state)."""
    s_cur, outs = s0, []
    for i in range(r.shape[1] // chunk):
        sl = slice(i * chunk, (i + 1) * chunk)
        oc, s_cur = _wkv_chunk(r[:, sl], k[:, sl], v[:, sl], logw[:, sl], u, s_cur)
        outs.append(oc)
    return torch.cat(outs, 1), s_cur


def _wkv_step(r: Tensor, k: Tensor, v: Tensor, w: Tensor, u: Tensor, s0: Tensor) -> tuple[Tensor, Tensor]:
    """One decode step of the recurrence: r,k,v,w: (B,H,n) float32, u:
    (H,n), s0: (B,H,n,n) -> (o: (B,H,n), s1)."""
    wkv = s0 + (u[None] * k)[..., None] * v[..., None, :]
    o = torch.einsum("bhn,bhnm->bhm", r, wkv)
    return o, w[..., None] * s0 + k[..., None] * v[..., None, :]


def _by_rank(fn, r: Tensor, k: Tensor, v: Tensor, w: Tensor, u: Tensor, s0: Tensor, *, heads: int):
    """`fn(r, k, v, w, u, s0) -> (o, s1)` (the WKV recurrence: batch on dim
    0 and heads on dim `heads` of r, k, v, w and o; u (H, n); the state
    (B, H, n, n)).  For DTensor operands an explicit site: each rank runs
    it on its own (batch, head) shards — the recurrence is independent per
    (batch, head) — so no collective is issued.  Mesh dims that shard the
    batch or the heads of r keep that sharding, every other placement is
    made `Replicate()`.  (DTensor's einsum rules would merge the two
    sharded dims into one strided shard, whose batched product the
    planner takes apart only by reading data: fake tensors refuse it.)
    u's gradient is a partial sum over the batch shards."""
    if not is_dtensor(r):
        return fn(r, k, v, w, u, s0)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    dm = r.device_mesh
    place = tuple(p if isinstance(p, Shard) and p.dim in (0, heads) else Replicate() for p in r.placements)
    on_heads = [p == Shard(heads) for p in place]
    u_place = tuple(Shard(0) if oh else Replicate() for oh in on_heads)
    u_grad = [Shard(0) if oh else Partial() if p == Shard(0) else Replicate() for p, oh in zip(place, on_heads)]
    s_place = tuple(Shard(1) if oh else p for p, oh in zip(place, on_heads))
    loc = [replicated(t, dm).redistribute(dm, place).to_local() for t in (r, k, v, w)]
    u = replicated(u, dm).redistribute(dm, u_place).to_local(grad_placements=u_grad)
    s0 = replicated(s0, dm).redistribute(dm, s_place).to_local()
    o, s1 = fn(*loc, u, s0)
    return DTensor.from_local(o, dm, place, run_check=False), DTensor.from_local(s1, dm, s_place, run_check=False)


def _decay_log(xw: Tensor, p: Params) -> Tensor:
    """log w = −exp(w0 + lora_w(x)), in float32."""
    return -torch.exp(p["w0"].to(torch.float32) + (xw.to(torch.float32) @ p["wA"]) @ p["wB"])


def _zeros(*shape, like: Tensor) -> Tensor:
    return torch.zeros(shape, dtype=torch.float32, device=like.device)


def time_mix(x: Tensor, p: Params, cfg: ModelConfig, state: Optional[dict[str, Tensor]],
             rules: Optional[ShardingRules], qat: LayerQAT) -> tuple[Tensor, dict[str, Tensor]]:
    """Full-sequence time-mix. x: (B, S, d).  Writes the new "wkv" and
    "x_tm" into `state`, or returns them as a new dict when `state` is None
    (a fresh zero state)."""
    b, s, d = x.shape
    h, n = _n_heads(cfg), cfg.rwkv_head_dim
    dt = cfg.compute_dtype
    c = min(CHUNK, s)
    if s % c:
        raise ValueError(f"seq {s} not divisible by chunk {c}: an RWKV-6 prompt longer than {CHUNK} tokens "
                         f"must be a multiple of {CHUNK}")

    x = qat.site("tmix_in", x)
    x_last = state["x_tm"] if state is not None else _zeros(b, d, like=x)
    xm = _ddlerp(x, _shift(x, x_last.to(x.dtype)), p, dt)
    xr, xk, xv, xw, xg = xm.unbind(-2)

    r, k, v = (_whole_heads(xi @ p[wi].to(dt), h).reshape(b, s, h, n)
               for xi, wi in ((xr, "wr"), (xk, "wk"), (xv, "wv")))
    g = F.silu(xg @ p["wg"].to(dt))
    logw = _whole_heads(_decay_log(xw, p), h).reshape(b, s, h, n)

    s0 = state["wkv"] if state is not None else _zeros(b, h, n, n, like=x)
    o, s_cur = _by_rank(functools.partial(_wkv_scan, chunk=c), r, k, v, logw, p["u"].to(torch.float32), s0, heads=2)
    o = o.reshape(b, s, d)

    o = group_norm_heads(o.to(dt), p["gn_scale"], p["gn_bias"], h)
    y = (o * g) @ p["wo"].to(dt)
    new = carry_state(state, {"wkv": s_cur, "x_tm": x[:, -1, :]})
    return constrain(y, rules, "batch", "seq", "embed"), new


def channel_mix(x: Tensor, p: Params, cfg: ModelConfig, state: Optional[dict[str, Tensor]],
                rules: Optional[ShardingRules], qat: LayerQAT) -> tuple[Tensor, dict[str, Tensor]]:
    """Channel-mix (squared-ReLU FFN on a token-shifted input).  Writes the
    new "x_cm" into `state`, or returns it as a new dict when `state` is
    None (a fresh zero state)."""
    dt = cfg.compute_dtype
    x = qat.site("cmix_in", x)
    x_last = state["x_cm"] if state is not None else _zeros(x.shape[0], x.shape[2], like=x)
    xp = _shift(x, x_last.to(x.dtype))
    xk = x + (xp - x) * p["cm_mu_k"].to(dt)
    xr = x + (xp - x) * p["cm_mu_r"].to(dt)
    kk = torch.square(torch.relu(xk @ p["cm_wk"].to(dt)))
    kk = constrain(kk, rules, "batch", "seq", "mlp")
    v = kk @ p["cm_wv"].to(dt)
    y = torch.sigmoid(xr @ p["cm_wr"].to(dt)) * v
    new = carry_state(state, {"x_cm": x[:, -1, :]})
    return constrain(y, rules, "batch", "seq", "embed"), new


def decode_step(x: Tensor, p: Params, cfg: ModelConfig, state: dict[str, Tensor],
                rules: Optional[ShardingRules], qat: LayerQAT, which: str) -> tuple[Tensor, dict[str, Tensor]]:
    """O(1) single-token step; x: (B, 1, d). `which` in {"tmix","cmix"}."""
    if which != "tmix":
        return channel_mix(x, p, cfg, state, rules, qat)
    b, _, d = x.shape
    h, n = _n_heads(cfg), cfg.rwkv_head_dim
    dt = cfg.compute_dtype
    x = qat.site("tmix_in", x)
    xm = _ddlerp(x, state["x_tm"].to(x.dtype)[:, None, :], p, dt)
    xr, xk, xv, xw, xg = xm.unbind(-2)
    r, k, v = (_whole_heads(xi @ p[wi].to(dt), h).reshape(b, h, n)
               for xi, wi in ((xr, "wr"), (xk, "wk"), (xv, "wv")))
    g = F.silu(xg @ p["wg"].to(dt))[:, 0]
    w = _whole_heads(torch.exp(_decay_log(xw[:, 0], p)), h).reshape(b, h, n)
    rf, kf, vf = (t.to(torch.float32) for t in (r, k, v))
    o, s1 = _by_rank(_wkv_step, rf, kf, vf, w, p["u"].to(torch.float32), state["wkv"], heads=1)
    o = o.reshape(b, d)
    o = group_norm_heads(o.to(dt), p["gn_scale"], p["gn_bias"], h)
    y = ((o * g) @ p["wo"].to(dt))[:, None, :]
    state["wkv"].copy_(s1)
    state["x_tm"].copy_(x[:, 0, :])
    # as `time_mix`: the product over the sharded state dim is a partial
    # sum, reduced here, not left in the residual stream for the next
    # layer's lora to be reduce-scattered onto its (5, 32) split
    return constrain(y, rules, "batch", "seq", "embed"), state


__all__ = ["rwkv_init", "rwkv_specs", "init_state", "state_specs", "time_mix", "channel_mix", "decode_step",
           "CHUNK"]
