"""Shared neural layers for the architecture zoo (port of
`repro.models.layers`: norms (the RWKV per-head group norm among them),
RoPE, grouped attention with its KV caches, the dense MLP, embedding and
head).

Everything is functional: params are plain dicts of tensors, each `*_init`
has a matching `*_specs` returning the same tree with `Logical` leaves
(logical sharding axes, resolved by `core.parallelism` rules), and every
activation entering a product passes through a `LayerQAT` site so FIXAR's
Algorithm 1 applies to any architecture.

Numerics kept from the reference: scores and softmax in float32, masked
with −1e30, the probabilities cast back to the compute dtype before the PV
product; `gelu` is the tanh approximation (`jax.nn.gelu`'s default); the
layer norm's variance is the population variance; the embedding scale
√d_model is rounded to the compute dtype before the multiply; the ring
cache's slot arithmetic is a floor-mod.  The products are plain
`torch.matmul` / `einsum`: the reference computes them in jnp, outside any
Pallas kernel.

Differences from the reference: KV caches are written in place (a decode
step or a prefill with a cache returns the cache it was given, updated),
so a step costs no copy of the cache; a weight already in the compute
dtype is used as it is (`.to` is then a no-op), so serving casts its
frozen params once (`models.transformer.serving_params`).
"""

from __future__ import annotations

import functools
import math
from typing import Any, Optional, Union

import torch
import torch.nn.functional as F

from repro_torch.core import fixedpoint as fxp
from repro_torch.core.parallelism import Logical, ShardingRules, constrain, is_dtensor, replicated
from repro_torch.core.ranges import RangeStat, finalized, update_minmax, update_minmax_scalar
from repro_torch.models.config import ModelConfig
from repro_torch.models.spans import spanned

Tensor = torch.Tensor
Params = dict[str, Any]
Pos = Union[int, Tensor]

NEG_INF = -1e30  # the reference's mask fill (a float32 constant, not -inf)

# ---------------------------------------------------------------------------
# QAT sites for stacked layers
# ---------------------------------------------------------------------------

# site names per block type (used to build the stacked (L,) range trees)
ATTN_SITES = ("attn_in", "attn_o_in", "mlp_in", "mlp_down_in")
MOE_SITES = ("attn_in", "attn_o_in", "router_in", "expert_in", "expert_down_in")
RWKV_SITES = ("tmix_in", "cmix_in")
RGLRU_SITES = ("rnn_in", "mlp_in", "mlp_down_in")
HEAD_SITES = ("head_in",)
# latent attention (`mla_forward`): its input, the normalised latent before
# W_kv_b, the attention output; then the dense MLP's or the DeepSeek MoE's
MLA_SITES = ("attn_in", "attn_kv_in", "attn_o_in")
MLA_DENSE_SITES = MLA_SITES + ("mlp_in", "mlp_down_in")
MLA_MOE_SITES = MLA_SITES + ("router_in", "expert_in", "expert_down_in", "shared_in", "shared_down_in")


def _select(flag: Tensor, old: RangeStat, new: RangeStat) -> RangeStat:
    return RangeStat(*(torch.where(flag, o, n) for o, n in
                       ((old.a_min, new.a_min), (old.a_max, new.a_max), (old.count, new.count))))


class LayerQAT:
    """Per-layer QAT context: scalar RangeStats (sliced from the stacked
    (L,) tree by the layer walk), the phase flag (a bool tensor: True once
    the ranges are frozen and sites quantize), and the collected updates.
    None-stats => QAT disabled (plain passthrough)."""

    def __init__(self, stats: Optional[dict[str, RangeStat]], quant_phase: Optional[Tensor], n_bits: int = 16):
        self.stats = dict(stats) if stats is not None else None
        self.quant_phase = quant_phase
        self.n_bits = n_bits

    def _phase(self, like: Tensor) -> Tensor:
        return torch.as_tensor(self.quant_phase, dtype=torch.bool, device=like.device)

    def site(self, name: str, x: Tensor, valid: Optional[Tensor] = None) -> Tensor:
        """`x` through the site `name`.  `valid` (a bool per row of `x`,
        its leading axes) limits the range fold to those rows: the other
        rows are quantized alike and may hold anything, NaN included."""
        if self.stats is None:
            return x
        return spanned("lm.qat.site", lambda x: self._site(name, x, valid), x)

    def _site(self, name: str, x: Tensor, valid: Optional[Tensor] = None) -> Tensor:
        stat = self.stats[name]
        xf = x.to(torch.float32)
        phase = self._phase(stat.a_min)
        if valid is None:
            folded = update_minmax(stat, xf.detach())
        else:
            lo, hi = torch.aminmax(xf.detach(), dim=-1)
            folded = update_minmax_scalar(stat, torch.where(valid, lo, math.inf).min(),
                                          torch.where(valid, hi, -math.inf).max())
        new_stat = _select(phase, stat, folded)
        self.stats[name] = new_stat
        a_min, a_max = finalized(new_stat)
        x_q = fxp.fake_quant_affine(xf, a_min, a_max, self.n_bits)
        x_full = fxp.fake_quant(xf, fxp.FXP32)
        return torch.where(phase.to(x.device), x_q, x_full).to(x.dtype)

    def collect(self) -> Optional[dict[str, RangeStat]]:
        return self.stats

    # -- extension points for regions that quantize outside `site` --------
    def params_for(self, name: str):
        """(a_min, a_max, quant_phase) for quantizing where `site()` cannot
        thread the stat update itself."""
        if self.stats is None:
            return None
        a_min, a_max = finalized(self.stats[name])
        return a_min, a_max, self.quant_phase

    def fold_external(self, name: str, local_min: Tensor, local_max: Tensor) -> None:
        """Fold externally computed (already reduced) min/max into a site's
        running stats (same freeze-after-delay rule)."""
        if self.stats is None:
            return
        stat = self.stats[name]
        cand = RangeStat(
            a_min=torch.minimum(stat.a_min, local_min).to(torch.float32),
            a_max=torch.maximum(stat.a_max, local_max).to(torch.float32),
            count=stat.count + 1)
        self.stats[name] = _select(self._phase(stat.a_min), stat, cand)


def carry_state(state: Optional[dict[str, Tensor]], new: dict[str, Tensor]) -> dict[str, Tensor]:
    """A recurrent block's new state: written in place into the caller's
    `state` tensors (serving: the per-layer caches are views of the stacked
    tree, so a fresh dict would be dropped) and that dict returned; or,
    when the block started from a fresh zero state (`state` None: a
    training forward), `new` as it is — autograd saved the tensors the
    block read, so nothing may be written into them."""
    if state is None:
        return new
    for name, value in new.items():
        state[name].copy_(value)
    return state


def init_site_ranges(sites: tuple[str, ...], n: int, *, device: torch.device) -> dict[str, RangeStat]:
    """Stacked (n,) range tree for n layers of one pattern slot."""
    mk = lambda v: torch.full((n,), v, dtype=torch.float32, device=device)  # noqa: E731
    return {s: RangeStat(a_min=mk(math.inf), a_max=mk(-math.inf),
                         count=torch.zeros((n,), dtype=torch.int32, device=device)) for s in sites}


# ---------------------------------------------------------------------------
# Constants on a device
# ---------------------------------------------------------------------------


def _per_device(fn):
    """`functools.lru_cache(fn)`, bypassed while a fake-tensor mode is
    active (`launch.dryrun`): a fake constant must not outlive its mode, and
    a real one cannot enter it."""
    cached = functools.lru_cache(maxsize=None)(fn)

    @functools.wraps(fn)
    def lookup(*args):
        if torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE) is not None:
            return fn(*args)
        return cached(*args)

    lookup.cache_clear = cached.cache_clear
    return lookup


@_per_device
def _const(value: float, dtype: torch.dtype, device: torch.device) -> Tensor:
    """A 0-d tensor of `value` rounded to `dtype` (made once per device: a
    product or quotient by it is the reference's by a weak-typed constant,
    and on the card a quotient by a tensor is IEEE where one by a Python
    number is not).  Made outside inference mode, whoever asks first: a
    serving call under `torch.inference_mode` would otherwise cache an
    inference tensor, which autograd cannot save for a training backward."""
    with torch.inference_mode(False):
        return torch.tensor(value, dtype=dtype).to(device)


@_per_device
def rope_freqs(half: int, theta: float, device: torch.device) -> Tensor:
    """`theta ** (−arange(half) / half)` in float32, built once on the CPU
    and copied, so every device holds the same table (outside inference
    mode, as `_const`).  The reference's float32 `pow` is XLA's: the two
    can differ by an ulp (held within tolerance by the tests)."""
    with torch.inference_mode(False):
        exps = -torch.arange(0, half, dtype=torch.float32) / half
        return torch.pow(torch.tensor(theta, dtype=torch.float32), exps).to(device)


# ---------------------------------------------------------------------------
# Init helpers
# ---------------------------------------------------------------------------


def _uniform(gen: torch.Generator, shape, fan_in: int) -> Tensor:
    bound = fan_in ** -0.5
    return torch.empty(shape, dtype=torch.float32, device=gen.device).uniform_(-bound, bound, generator=gen)


def _zeros(gen: torch.Generator, shape) -> Tensor:
    return torch.zeros(shape, dtype=torch.float32, device=gen.device)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def norm_init(gen: torch.Generator, cfg: ModelConfig, lead: tuple = ()) -> Params:
    p = {"scale": torch.ones(lead + (cfg.d_model,), dtype=torch.float32, device=gen.device)}
    if cfg.norm == "layernorm":
        p["bias"] = _zeros(gen, lead + (cfg.d_model,))
    return p


def norm_specs(cfg: ModelConfig) -> Params:
    p = {"scale": Logical("embed")}
    if cfg.norm == "layernorm":
        p["bias"] = Logical("embed")
    return p


def apply_norm(x: Tensor, p: Params, cfg: ModelConfig, eps: Optional[float] = None) -> Tensor:
    eps = cfg.norm_eps if eps is None else eps
    xf = x.to(torch.float32)
    if cfg.norm == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, correction=0)  # jnp.var: population variance
        y = (xf - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    else:
        ms = xf.square().mean(-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * p["scale"]
    return y.to(x.dtype)


def group_norm_heads(x: Tensor, scale: Tensor, bias: Tensor, n_heads: int, eps: float = 64e-5) -> Tensor:
    """Per-head group norm (RWKV wkv output norm), in float32 with the
    population variance. x: (..., H*hd).

    For a DTensor x an explicit site: each rank normalizes its own whole
    heads (x laid out by `_whole_heads`) with its slices of scale and bias,
    and the output is laid out as those heads.  (DTensor's view rules
    cannot split a dim sharded into pieces that cut heads — the smoke
    config's 4 heads on a "model" axis of 8 — and the gradient the gate
    product hands back arrives sharded so.)"""
    if is_dtensor(x):
        return _rows_by_heads(lambda xl, sl, bl: group_norm_heads(xl, sl, bl, xl.shape[-1] * n_heads // x.shape[-1],
                                                                  eps), x, (scale, bias), n_heads)
    shape = x.shape
    xf = x.to(torch.float32).reshape(*shape[:-1], n_heads, -1)
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y.reshape(shape) * scale + bias).to(x.dtype)


def _whole_heads(t: Tensor, h: int) -> Tensor:
    """`t` (..., d = h·n) laid out so that its last dim splits into (h, n):
    a DTensor keeps each mesh dim that shards d where the shards still hold
    whole heads (h divides by the product of those dims' sizes so far) and
    is made `Replicate()` on the others — the head-aligned placement the
    reference's GSPMD reshards to before its reshape (4 heads of the smoke
    config on a "model" axis of 8: d = 64 divides 8, the heads do not).  A
    plain tensor, or one already aligned, is returned as it is."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate, Shard

    dm, last, kept, place = t.device_mesh, t.ndim - 1, 1, []
    for i, pl in enumerate(t.placements):
        if isinstance(pl, Shard) and pl.dim == last:
            if h % (kept * dm.size(i)) == 0:
                kept *= dm.size(i)
            else:
                pl = Replicate()
        place.append(pl)
    return t if tuple(place) == tuple(t.placements) else t.redistribute(dm, tuple(place))


def _rows_by_heads(fn, x: Tensor, vectors: tuple, n_heads: int) -> Tensor:
    """`fn(x, *vectors)` per rank for a DTensor x (..., d = h·n) laid out on
    whole heads (`_whole_heads`) and vectors (d,) cut as x's last dim is:
    each rank computes on its own rows and heads, the vectors' gradients a
    partial sum over the mesh dims that shard x's rows.  The output is
    laid out as the aligned x."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    x = _whole_heads(x, n_heads)
    dm, last = x.device_mesh, x.ndim - 1
    on_d = [isinstance(p, Shard) and p.dim == last for p in x.placements]
    grad = [Shard(0) if od else Partial() if isinstance(p, Shard) else Replicate()
            for p, od in zip(x.placements, on_d)]
    vl = [replicated(v, dm).redistribute(dm, tuple(Shard(0) if od else Replicate() for od in on_d))
          .to_local(grad_placements=grad) for v in vectors]
    return DTensor.from_local(fn(x.to_local(), *vl), dm, x.placements, run_check=False)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope(x: Tensor, positions: Tensor, theta: float) -> Tensor:
    """Rotary embedding. x: (B, S, H, hd), positions: (B, S) or (S,)."""
    half = x.shape[-1] // 2
    freqs = rope_freqs(half, float(theta), x.device)
    ang = positions.to(torch.float32)[..., None] * freqs  # (B,S,half)|(S,half)
    if ang.ndim == 2:  # (S, half) -> broadcast over batch
        ang = ang[None]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    xf1, xf2 = x[..., :half].to(torch.float32), x[..., half:].to(torch.float32)
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], -1).to(x.dtype)


# ---------------------------------------------------------------------------
# GQA attention (global / sliding-window, causal / bidirectional)
# ---------------------------------------------------------------------------


def attn_init(gen: torch.Generator, cfg: ModelConfig, lead: tuple = ()) -> Params:
    d, hq, hk, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    p = {
        "wq": _uniform(gen, lead + (d, hq, hd), d),
        "wk": _uniform(gen, lead + (d, hk, hd), d),
        "wv": _uniform(gen, lead + (d, hk, hd), d),
        "wo": _uniform(gen, lead + (hq, hd, d), hq * hd),
    }
    if cfg.qkv_bias:
        p["bq"] = _zeros(gen, lead + (hq, hd))
        p["bk"] = _zeros(gen, lead + (hk, hd))
        p["bv"] = _zeros(gen, lead + (hk, hd))
    return p


def attn_specs(cfg: ModelConfig) -> Params:
    p = {
        "wq": Logical("embed", "q_heads", "head_dim"),
        "wk": Logical("embed", "kv_heads", "head_dim"),
        "wv": Logical("embed", "kv_heads", "head_dim"),
        "wo": Logical("q_heads", "head_dim", "embed"),
    }
    if cfg.qkv_bias:
        p["bq"] = Logical("q_heads", "head_dim")
        p["bk"] = Logical("kv_heads", "head_dim")
        p["bv"] = Logical("kv_heads", "head_dim")
    return p


def _heads(x: Tensor, w: Tensor, dt: torch.dtype) -> Tensor:
    """einsum("bsd,dhk->bshk", x, w) as one matmul."""
    d, h, k = w.shape
    if _head_dim_sharded(w, 2):
        return _heads_by_rank(x, w, dt)
    return (x @ w.to(dt).reshape(d, h * k)).reshape(*x.shape[:-1], h, k)


def _head_dim_sharded(w: Tensor, dim: int) -> bool:
    """Whether a DTensor weight shards its head_dim (`dim`) on some mesh
    dim: merging (heads, head_dim) into one matmul dim then makes a strided
    shard, which DTensor's matmul planner takes apart only by reading
    data (it fails under fake tensors: `launch.dryrun`)."""
    from torch.distributed.tensor import Shard

    return is_dtensor(w) and any(isinstance(p, Shard) and p.dim == dim for p in w.placements)


def _heads_by_rank(x: Tensor, w: Tensor, dt: torch.dtype) -> Tensor:
    """`_heads` of a weight whose head_dim is sharded (the serve rules'
    `prefer_head_dim` layout, or heads that do not divide the model axis):
    an explicit site, each rank multiplying x by its own head_dim slice.
    x keeps its batch / sequence shards on the other mesh dims and is made
    whole on the weight's; the output is sharded on head_dim as the weight
    is.  x's gradient is a partial sum over the ranks of the weight's
    shards."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    dm = w.device_mesh
    x = replicated(x, dm)
    on_w = [isinstance(p, Shard) and p.dim == 2 for p in w.placements]
    xp = tuple(px if isinstance(px, Shard) and px.dim < x.ndim - 1 and not ow else Replicate()
               for px, ow in zip(x.placements, on_w))
    wl = w.redistribute(dm, tuple(Shard(2) if ow else Replicate() for ow in on_w)).to_local()
    xl = x.redistribute(dm, xp).to_local(grad_placements=[Partial() if ow else p for p, ow in zip(xp, on_w)])
    d, h, k = wl.shape
    out = (xl @ wl.to(dt).reshape(d, h * k)).reshape(*xl.shape[:-1], h, k)
    return DTensor.from_local(out, dm, tuple(Shard(x.ndim) if ow else p for p, ow in zip(xp, on_w)),
                              run_check=False)


def _qkv(x: Tensor, p: Params, cfg: ModelConfig, qat: LayerQAT):
    x = qat.site("attn_in", x)
    dt = cfg.compute_dtype
    q, k, v = _heads(x, p["wq"], dt), _heads(x, p["wk"], dt), _heads(x, p["wv"], dt)
    if cfg.qkv_bias:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    return q, k, v


def _out_proj(out: Tensor, p: Params, cfg: ModelConfig) -> Tensor:
    """einsum("bshk,hkd->bsd", out, wo) as one matmul."""
    h, k, d = p["wo"].shape
    if _head_dim_sharded(p["wo"], 1):
        return _out_proj_by_rank(out, p["wo"], cfg.compute_dtype)
    return out.reshape(*out.shape[:2], h * k) @ p["wo"].to(cfg.compute_dtype).reshape(h * k, d)


def _out_proj_by_rank(out: Tensor, wo: Tensor, dt: torch.dtype) -> Tensor:
    """`_out_proj` of a weight whose head_dim is sharded (see
    `_heads_by_rank`): an explicit site, each rank contracting its own
    head_dim slice of the attention output; the product is a partial sum
    over the ranks of the weight's shards (the row-parallel all-reduce
    follows at the caller's `constrain`)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    dm = wo.device_mesh
    h, k, d = wo.shape
    out = replicated(out, dm)
    on_w = [isinstance(p, Shard) and p.dim == 1 for p in wo.placements]
    op = tuple(Shard(3) if ow else (po if isinstance(po, Shard) and po.dim < 2 else Replicate())
               for po, ow in zip(out.placements, on_w))
    wl = wo.redistribute(dm, tuple(Shard(1) if ow else Replicate() for ow in on_w)).to_local()
    ol = out.reshape(*out.shape[:2], h, k).redistribute(dm, op).to_local()
    y = ol.reshape(*ol.shape[:2], -1) @ wl.to(dt).reshape(-1, d)
    return DTensor.from_local(y, dm, tuple(Partial() if ow else p for p, ow in zip(op, on_w)), run_check=False)


def _mask(q_pos: Tensor, k_pos: Tensor, cfg: ModelConfig, local: bool) -> Tensor:
    """(…, Sq, Sk) boolean mask. q_pos/k_pos: (..., S)."""
    qp = q_pos[..., :, None]
    kp = k_pos[..., None, :]
    m = torch.ones(q_pos.shape[:-1] + (q_pos.shape[-1], k_pos.shape[-1]), dtype=torch.bool, device=q_pos.device)
    if cfg.causal:
        m = m & (kp <= qp)
    if local:
        m = m & (kp > qp - cfg.window)
    return m


def _scale_scores(scores: Tensor, hd: int) -> Tensor:
    return scores / _const(math.sqrt(hd), torch.float32, scores.device)


def _sdpa(q: Tensor, k: Tensor, v: Tensor, mask: Tensor, cfg: ModelConfig, rules) -> Tensor:
    """Grouped scaled-dot-product attention.
    q: (B,Sq,Hq,hd), k/v: (B,Sk,Hk,hd), mask: (B,Sq,Sk) or (Sq,Sk)."""
    if is_dtensor(q):
        return _attend(lambda q, k, v, m: _sdpa(q, k, v, m, cfg, rules), q, k, v, mask)
    b, sq, hq, hd = q.shape
    hk = k.shape[2]
    g = hq // hk
    qg = q.reshape(b, sq, hk, g, hd)
    scores = _scale_scores(torch.einsum("bskgh,btkh->bkgst", qg, k).to(torch.float32), hd)
    if mask.ndim == 2:
        mask = mask[None]
    scores = torch.where(mask[:, None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkh->bskgh", probs, v)
    return out.reshape(b, sq, hq, hd)


def _attend(fn, q: Tensor, k: Tensor, v: Tensor, mask: Optional[Tensor]) -> Tensor:
    """`fn(q, k, v, mask)` (grouped attention on (B, S, H, hd) operands) for
    DTensor operands: each rank runs it on its own (batch, head) shards.
    The mesh dims that shard the batch, or the heads, of q and of k alike
    keep that sharding (a rank's q heads then hold whole kv groups); every
    other placement is made `Replicate()` first (a sharded sequence or
    head_dim, or heads sharded on one side only: an explicit site, since
    DTensor's einsum rules cannot split the heads into kv groups, and on a
    three-axis mesh its planner stalls on the merged batch dims).  A mask
    with a batch dim is cut to the rank's rows; the output is laid out as
    the operands were."""
    from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

    dm = q.device_mesh
    k, v = replicated(k, dm), replicated(v, dm)
    place = tuple(pq if pq == pk and isinstance(pq, Shard) and pq.dim in (0, 2) else Replicate()
                  for pq, pk in zip(q.placements, k.placements))
    q, k, v = (t.redistribute(dm, place) for t in (q, k, v))
    if mask is not None and mask.ndim == 3 and mask.shape[0] > 1:  # per-row mask: the rank's rows
        rows = tuple(Shard(0) if p == Shard(0) else Replicate() for p in place)
        mask = distribute_tensor(mask, dm, rows, src_data_rank=None).to_local()
    out = fn(q.to_local(), k.to_local(), v.to_local(), mask)
    return DTensor.from_local(out, dm, place, run_check=False)


def _banded_local_sdpa(q: Tensor, k: Tensor, v: Tensor, cfg: ModelConfig) -> Tensor:
    """Sliding-window attention over (prev, self) key chunks — O(S·2w)
    scores instead of O(S²).  Exactly the full-score band mask for window
    w = chunk width.  q: (B,S,Hq,hd), k/v: (B,S,Hk,hd)."""
    if is_dtensor(q):
        return _attend(lambda q, k, v, _: _banded_local_sdpa(q, k, v, cfg), q, k, v, None)
    w = cfg.window
    b, s, hq, hd = q.shape
    hk = k.shape[2]
    g = hq // hk
    nc = s // w
    qc = q.reshape(b, nc, w, hk, g, hd)
    kc = k.reshape(b, nc, w, hk, hd)
    vc = v.reshape(b, nc, w, hk, hd)
    kk = torch.cat([torch.cat([torch.zeros_like(kc[:, :1]), kc[:, :-1]], 1), kc], 2)
    vv = torch.cat([torch.cat([torch.zeros_like(vc[:, :1]), vc[:, :-1]], 1), vc], 2)

    scores = _scale_scores(torch.einsum("znakgh,znmkh->znkgam", qc, kk).to(torch.float32), hd)
    dev = q.device
    a_idx = torch.arange(w, device=dev)[:, None]
    m_idx = torch.arange(2 * w, device=dev)[None, :]
    band = (m_idx <= w + a_idx) & (m_idx > a_idx)
    first_ok = m_idx >= w  # chunk 0 has no previous chunk
    chunk_i = torch.arange(nc, device=dev)[:, None, None]
    mask = band[None] & ((chunk_i > 0) | first_ok[None])
    scores = torch.where(mask[None, :, None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("znkgam,znmkh->znakgh", probs, vv)
    return out.reshape(b, s, hq, hd)


def attn_forward(x: Tensor, p: Params, cfg: ModelConfig, *, local: bool, positions: Tensor,
                 rules: Optional[ShardingRules], qat: LayerQAT, chunk: int = 0,
                 cache: Optional[dict[str, Tensor]] = None) -> tuple[Tensor, Optional[dict[str, Tensor]]]:
    """Full-sequence attention (prefill). x: (B, S, d).

    `chunk` bounds the score-matrix working set by walking query chunks.

    `cache` (prefill): a decode-shaped KV cache ({"k","v"}: (B, T, Hk, hd));
    the prompt's roped K / raw V are written, in place, into the exact slots
    `attn_decode` would have used (ring layout p % T for local layers,
    absolute positions for global), so decode can continue at pos = S.
    Returns (y, cache) — cache is None when none was passed."""
    q, k, v = _qkv(x, p, cfg, qat)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    q = constrain(q, rules, "batch", "seq", "q_heads", "head_dim")
    k = constrain(k, rules, "batch", "seq", "kv_heads", "head_dim")

    if cache is not None and positions.ndim == 1:
        # a prompt's positions are 0 .. S-1 (`transformer.forward`'s), so its
        # slots follow from the shapes: the last `keep` positions, at their
        # own slots, or at p % t in a ring (one wrap at most: keep <= t)
        s_all = x.shape[1]
        t = cache["k"].shape[1]
        keep = min(s_all, t)  # ring keeps only the last window of the prompt
        first = s_all - keep
        if local and t <= cfg.window:
            runs = [(first % t, first, min(keep, t - first % t))]
            runs.append((0, first + runs[0][2], keep - runs[0][2]))
        elif s_all > t:
            # absolute-slot cache: positions >= t have no slot, and decode
            # would read zeros
            raise ValueError(
                f"prompt length {s_all} exceeds the KV cache length {t}; "
                "init_cache with max_seq >= prompt + max_new")
        else:
            runs = [(first, first, keep)]
        for slot, src, n in runs:
            if n:
                _cache_write(cache["k"], slot, k[:, src:src + n])
                _cache_write(cache["v"], slot, v[:, src:src + n])

    b, s = x.shape[0], x.shape[1]
    if local and s >= 2 * cfg.window and s % cfg.window == 0 and positions.ndim == 1:
        out = _banded_local_sdpa(q, k, v, cfg)
    elif chunk and s > chunk:
        if s % chunk:
            raise ValueError(f"sequence {s} is no multiple of the attention chunk {chunk}")
        outs = []
        for c in range(s // chunk):
            pc = positions[..., c * chunk:(c + 1) * chunk]
            m = _mask(pc, positions, cfg, local)
            outs.append(_sdpa(q[:, c * chunk:(c + 1) * chunk], k, v, m, cfg, rules))
        out = torch.cat(outs, 1)
    else:
        m = _mask(positions, positions, cfg, local)
        out = _sdpa(q, k, v, m, cfg, rules)

    out = qat.site("attn_o_in", out.reshape(b, s, -1))
    y = _out_proj(out, p, cfg)
    return constrain(y, rules, "batch", "seq", "embed"), cache


def _cache_write(cache: Tensor, start: int, values: Tensor) -> None:
    """`cache[:, start:start + n] = values` in place, n = values.shape[1]
    (slots along the sequence dim).  A DTensor cache is written shard by
    shard — an explicit site: DTensor's rules for `index_put_` and for a
    copy into a view differ between releases — the values laid out as the
    cache with their sequence dim whole, each rank writing the slots that
    fall in its piece of a sequence-sharded cache: the range's overlap with
    the rank's piece, from the shapes and offsets alone (no tensor is read,
    so fake tensors run it too)."""
    n = values.shape[1]
    if not is_dtensor(cache):
        cache[:, start:start + n] = values.to(cache.dtype)
        return
    from torch.distributed.tensor import Replicate, Shard

    dm = cache.device_mesh
    values = replicated(values, dm)
    place = tuple(Replicate() if isinstance(p, Shard) and p.dim == 1 else p for p in cache.placements)
    vals = values.to(cache.dtype).redistribute(dm, place).to_local()
    offset, length = _local_span(cache.shape[1], dm, cache.placements, 1)
    lo, hi = max(start, offset), min(start + n, offset + length)
    if lo < hi:
        cache.to_local()[:, lo - offset:hi - offset] = vals[:, lo - start:hi - start]


def _cache_write_rows(cache: Tensor, slot: Tensor, values: Tensor) -> None:
    """`cache[i, slot[i]] = values[i, 0]` for every row i, in place (slot:
    (B,) int, each row's own slot: continuous batching).  A DTensor cache
    is written shard by shard, as `_cache_write` writes one: the values
    laid out as the cache with their sequence dim whole, each rank taking
    the slots of its own rows (its piece of a batch-sharded cache) and
    writing those that fall in its piece of a sequence-sharded one.  Which
    piece holds a slot depends on the row's position, a value: the rank
    writes every row at its slot less the piece's offset, clamped into the
    piece, and keeps the old entry (`torch.where` on the row's flag) where
    the slot lies outside — no boolean index and nothing read back, so
    fake tensors run it too."""
    if not is_dtensor(cache):
        cache[torch.arange(cache.shape[0], device=cache.device), slot] = values[:, 0].to(cache.dtype)
        return
    from torch.distributed.tensor import Replicate, Shard

    dm = cache.device_mesh
    values = replicated(values, dm)
    place = tuple(Replicate() if isinstance(p, Shard) and p.dim == 1 else p for p in cache.placements)
    vals = values.to(cache.dtype).redistribute(dm, place).to_local()[:, 0]
    row0, n_rows = _local_span(cache.shape[0], dm, cache.placements, 0)
    offset, length = _local_span(cache.shape[1], dm, cache.placements, 1)
    if not (n_rows and length):
        return
    local = cache.to_local()
    slot = (slot.full_tensor() if is_dtensor(slot) else slot).to(local.device)[row0:row0 + n_rows] - offset
    inside = ((slot >= 0) & (slot < length)).reshape(-1, *(1,) * (vals.ndim - 1))
    rows, slot = torch.arange(n_rows, device=local.device), slot.clamp(0, length - 1)
    local[rows, slot] = torch.where(inside, vals, local[rows, slot])


def _local_span(size: int, dm, placements, dim: int) -> tuple[int, int]:
    """(offset, length) of this rank's piece of a tensor dim of `size`
    under `placements`: each mesh dim that shards it cuts the piece left by
    the ones before into `torch.chunk`'s pieces (DTensor's `Shard`), at
    this rank's mesh coordinate — Python ints only.  (DTensor's own
    `compute_local_shape_and_global_offset` reads a tensor for the
    coordinate on some releases, which fake tensors refuse.)"""
    from torch.distributed.tensor import Shard

    coord = dm.get_coordinate()
    offset, length = 0, size
    for i, p in enumerate(placements):
        if isinstance(p, Shard) and p.dim == dim:
            chunk = -(-length // dm.size(i))
            lo = min(coord[i] * chunk, length)
            offset, length = offset + lo, min(chunk, length - lo)
    return offset, length


def attn_decode(x: Tensor, p: Params, cfg: ModelConfig, *, local: bool, cache: dict[str, Tensor], pos: Pos,
                rules: Optional[ShardingRules], qat: LayerQAT) -> tuple[Tensor, dict[str, Tensor]]:
    """One-token decode against a KV cache, written in place.

    x: (B, 1, d); cache: {"k","v"}: (B, T, Hk, hd); pos: an int, the
    current index of every row, or a (B,) int tensor of per-row indices —
    the continuous-batching case (serve/lm), where every cache lane decodes
    at its own position.

    Local layers use a RING cache of length `window`: slot j holds position
    p_j = pos − ((pos − j) mod w), which is always inside the window, so the
    whole buffer is attended with an "is-filled" mask — O(w) storage and
    reads instead of O(S) for sliding-window layers.
    """
    q, k_new, v_new = _qkv(x, p, cfg, qat)
    b = x.shape[0]
    dev = x.device
    per_row = isinstance(pos, Tensor) and pos.ndim == 1
    if isinstance(pos, Tensor) and not per_row:
        pos = int(pos)
    positions = pos[:, None] if per_row else torch.full((b, 1), pos, dtype=torch.int64, device=dev)
    q = rope(q, positions, cfg.rope_theta)
    k_new = rope(k_new, positions, cfg.rope_theta)

    k_cache, v_cache = cache["k"], cache["v"]
    t = k_cache.shape[1]
    ring = local and t <= cfg.window
    if per_row:
        # per-row scatter: lane b writes its own slot
        slot = torch.remainder(pos, t) if ring else pos
        _cache_write_rows(k_cache, slot, k_new)
        _cache_write_rows(v_cache, slot, v_new)
    else:
        slot = pos % t if ring else pos  # Python's % is a floor-mod
        if not 0 <= slot < t:
            raise ValueError(f"decode position {pos} is outside the KV cache of length {t}")
        _cache_write(k_cache, slot, k_new)
        _cache_write(v_cache, slot, v_new)
    k_cache = constrain(k_cache, rules, "batch", "kv_seq", "kv_heads", "head_dim")
    v_cache = constrain(v_cache, rules, "batch", "kv_seq", "kv_heads", "head_dim")

    j = torch.arange(t, device=dev)
    kpos = pos[:, None] if per_row else pos  # (B, 1) against j's (T,)
    if ring:
        slot_pos = kpos - torch.remainder(kpos - j, t)  # position stored in slot j
        valid = slot_pos >= 0  # slot filled yet?
    else:
        valid = j <= kpos
        if local:
            valid = valid & (j > kpos - cfg.window)
    # (B, Sq=1, Sk) when per-row, (1, Sq=1, Sk) broadcast otherwise
    mask = valid[:, None, :] if per_row else valid[None, None, :]

    out = _sdpa(q, k_cache, v_cache, mask, cfg, rules)
    out = qat.site("attn_o_in", out.reshape(b, 1, -1))
    y = _out_proj(out, p, cfg)
    return y, {"k": k_cache, "v": v_cache}


# ---------------------------------------------------------------------------
# Latent attention (MLA, `config.DeepSeekV3Config`)
# ---------------------------------------------------------------------------



def mla_init(gen: torch.Generator, cfg: ModelConfig, lead: tuple = ()) -> Params:
    d, h, r = cfg.d_model, cfg.n_heads, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    return {"wq": _uniform(gen, lead + (d, h, dn + dr), d),
            "wkv_a": _uniform(gen, lead + (d, r + dr), d),
            "kv_norm": torch.ones(lead + (r,), dtype=torch.float32, device=gen.device),
            "wkv_b": _uniform(gen, lead + (r, h, dn + dv), r),
            "wo": _uniform(gen, lead + (h, dv, d), h * dv)}


def mla_specs(cfg: ModelConfig) -> Params:
    return {"wq": Logical("embed", "q_heads", "head_dim"), "wkv_a": Logical("embed", None),
            "kv_norm": Logical(None), "wkv_b": Logical(None, "q_heads", "head_dim"),
            "wo": Logical("q_heads", "head_dim", "embed")}


def causal_attention(q: Tensor, k: Tensor, v: Tensor, scale: float) -> Tensor:
    """Causal attention, fused: (B, S, H, dqk) q and k, (B, S, H, dv) v ->
    (B, S, H, dv).  On the card only cuDNN's backend is allowed: it takes qk
    192 and v 128 as they are and writes no (S, S) scores to memory (on an
    H100 at B 2, S 8,192, 16 heads, bf16: 5.2 ms forward and backward, where
    the flash backend, which wants v padded to 192, took 11.5 ms and the
    memory-efficient one 53 ms), and a shape it does not take raises rather
    than falls back to the math backend.  On the CPU PyTorch picks."""
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if q.device.type != "cuda":
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, scale=scale)
    else:
        from torch.nn.attention import SDPBackend, sdpa_kernel

        with sdpa_kernel([SDPBackend.CUDNN_ATTENTION]):
            out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, scale=scale)
    return out.transpose(1, 2)


def mla_forward(x: Tensor, p: Params, cfg: ModelConfig, *, positions: Tensor, qat: LayerQAT) -> Tensor:
    """Latent attention over the whole sequence, causal. x: (B, S, d).

    q = x·W_q, split into its nope and rope parts; c, k_pe = x·W_kv_a;
    c through RMSNorm (ε `cfg.norm_eps`) and expanded by W_kv_b into each
    head's k_nope and v; k_pe is one roped key part that every head
    shares.  Scores are scaled by 1/√(nope + rope).  QAT sites on the input,
    the normalised latent and the attention output."""
    dt = cfg.compute_dtype
    b, s, d = x.shape
    h, r = cfg.n_heads, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    x = qat.site("attn_in", x)
    q = _heads(x, p["wq"], dt)  # (B, S, H, dn + dr)
    kv_a = x @ p["wkv_a"].to(dt)  # (B, S, r + dr)
    c = qat.site("attn_kv_in", apply_norm(kv_a[..., :r], {"scale": p["kv_norm"]}, cfg))
    kv = _heads(c, p["wkv_b"], dt)  # (B, S, H, dn + dv)
    q_pe = rope(q[..., dn:], positions, cfg.rope_theta)
    k_pe = rope(kv_a[..., None, r:], positions, cfg.rope_theta)  # (B, S, 1, dr)
    q = torch.cat([q[..., :dn], q_pe], -1)
    k = torch.cat([kv[..., :dn], k_pe.expand(b, s, h, dr)], -1)
    scale = 1.0 / math.sqrt(dn + dr)
    out = spanned("lm.mla.attend", lambda q, k, v: causal_attention(q, k, v, scale), q, k, kv[..., dn:])
    out = qat.site("attn_o_in", out.reshape(b, s, h * dv))
    return out @ p["wo"].to(dt).reshape(h * dv, d)


# ---------------------------------------------------------------------------
# MLP (dense; the MoE FFN is `models.moe`)
# ---------------------------------------------------------------------------


def mlp_init(gen: torch.Generator, cfg: ModelConfig, lead: tuple = (), width: Optional[int] = None) -> Params:
    """The MLP's weights, of hidden width `width` (default `cfg.d_ff`)."""
    d, f = cfg.d_model, width or cfg.d_ff
    if cfg.mlp_type == "glu":
        return {"wg": _uniform(gen, lead + (d, f), d),
                "wu": _uniform(gen, lead + (d, f), d),
                "wd": _uniform(gen, lead + (f, d), f)}
    return {"wu": _uniform(gen, lead + (d, f), d),
            "wd": _uniform(gen, lead + (f, d), f),
            "bu": _zeros(gen, lead + (f,)),
            "bd": _zeros(gen, lead + (d,))}


def mlp_specs(cfg: ModelConfig) -> Params:
    if cfg.mlp_type == "glu":
        return {"wg": Logical("embed", "mlp"), "wu": Logical("embed", "mlp"),
                "wd": Logical("mlp", "embed")}
    return {"wu": Logical("embed", "mlp"), "wd": Logical("mlp", "embed"),
            "bu": Logical("mlp"), "bd": Logical("embed")}


def _act(x: Tensor, kind: str) -> Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.silu(x) if kind == "silu" else F.gelu(x, approximate="tanh")


def mlp_forward(x: Tensor, p: Params, cfg: ModelConfig, rules: Optional[ShardingRules], qat: LayerQAT,
                site_prefix: str = "mlp") -> Tensor:
    dt = cfg.compute_dtype
    x = qat.site(f"{site_prefix}_in", x)
    if cfg.mlp_type == "glu":
        h = _act(x @ p["wg"].to(dt), cfg.act) * (x @ p["wu"].to(dt))
    else:
        h = _act(x @ p["wu"].to(dt) + p["bu"].to(dt), cfg.act)
    h = constrain(h, rules, "batch", "seq", "mlp")
    h = qat.site(f"{site_prefix}_down_in", h)
    y = h @ p["wd"].to(dt)
    if cfg.mlp_type != "glu":
        y = y + p["bd"].to(dt)
    return constrain(y, rules, "batch", "seq", "embed")


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------


def embed_init(gen: torch.Generator, cfg: ModelConfig) -> Params:
    table = torch.randn((cfg.vocab_size, cfg.d_model), dtype=torch.float32, device=gen.device, generator=gen)
    p = {"embedding": table * cfg.d_model ** -0.5}
    if not cfg.tie_embeddings:
        p["head"] = _uniform(gen, (cfg.d_model, cfg.vocab_size), cfg.d_model)
    return p


def embed_specs(cfg: ModelConfig) -> Params:
    p = {"embedding": Logical("vocab", "embed")}
    if not cfg.tie_embeddings:
        p["head"] = Logical("embed", "vocab")
    return p


def _gather_rows(table: Tensor, idx: Tensor) -> Tensor:
    """`table[idx]`.  For DTensor operands an explicit site (DTensor's rule
    for the gather's backward, an accumulating `index_put_`, fails on some
    releases): every rank gathers its own index shard from the whole table
    and the table's gradient is summed over the ranks that hold different
    indices; the rows come out laid out as the indices."""
    if not (is_dtensor(table) or is_dtensor(idx)):
        return table[idx]
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    dm = (table if is_dtensor(table) else idx).device_mesh
    idx, table = replicated(idx, dm), replicated(table, dm)
    place = tuple(p if isinstance(p, Shard) else Replicate() for p in idx.placements)
    idx = idx.redistribute(dm, place)
    whole = table.redistribute(dm, [Replicate()] * dm.ndim).to_local(
        grad_placements=[Partial() if isinstance(p, Shard) else Replicate() for p in place])
    return DTensor.from_local(whole[idx.to_local()], dm, place, run_check=False)


def embed_tokens(tokens: Tensor, p: Params, cfg: ModelConfig, rules: Optional[ShardingRules]) -> Tensor:
    dt = cfg.compute_dtype
    # a gather then a cast: the reference's cast-then-gather, elementwise
    x = _gather_rows(p["embedding"], tokens.long()).to(dt)
    x = x * _const(math.sqrt(cfg.d_model), dt, x.device)  # √d rounded to dt first
    return constrain(x, rules, "batch", "seq", "embed")


def lm_head(x: Tensor, p: Params, cfg: ModelConfig, rules: Optional[ShardingRules], qat: LayerQAT) -> Tensor:
    x = qat.site("head_in", x)
    w = p["embedding"].T if cfg.tie_embeddings else p["head"]
    logits = x @ w.to(cfg.compute_dtype)
    return constrain(logits, rules, "batch", "seq", "vocab")
