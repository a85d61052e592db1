"""Plain PyTorch reference of one Moonlight-16B-A3B training step (HF
`model_type` deepseek_v3), in float32, for the check that decides
`correct` and for the CPU tests.

What it computes, from a parameter tree in this file's layout (`layers`: a
list of one dict a layer, below), QAT ranges, and a batch of tokens:

* the forward: embedding, then per layer RMSNorm, latent attention (q =
  x·W_q; c, k_pe = x·W_kv_a; c through RMSNorm and W_kv_b into each
  head's k_nope and v; k_pe roped and shared by the heads; causal softmax
  attention scaled by 1/√(nope + rope)), RMSNorm and either the dense
  SwiGLU or the MoE (sigmoid scores over every routed expert, the top k
  chosen by score + bias, gates the chosen scores over their sum times
  the routed scaling; the experts held here, token by token; the shared
  experts as one SwiGLU); the final RMSNorm and the untied head;
* the loss: the mean next-token cross-entropy plus α times the layers'
  sequence-wise balance losses (DeepSeek-V3, arXiv:2412.19437 eqs.
  17–20), and every gradient by autograd of these plain operations;
* the QAT sites: in the monitor phase each product's input projected onto
  the Q15.16 lattice, in the quant phase onto the 16-bit affine grid of
  the site's frozen range, both with a straight-through gradient; and the
  frozen ranges themselves, folded from the monitor phase's forwards
  (`monitor_ranges`);
* the routing of another run followed where a near-tie excuses it
  (`route`), so that a choice rounding may break either way does not
  stand for a fault in what follows it, and the choices no margin
  excuses counted;
* Adam on the Q15.16 lattice (the gradients projected, Adam, the
  parameters projected) and the aux-loss-free bias rule b += γ·sign(mean
  load − load);
* the synthetic token stream (Zipf unigrams with every 8th token a
  repeat) from (seed, step), drawn on the CPU.

It computes layer by layer: the forward keeps each layer's input, and the
backward recomputes one layer at a time, its attention in blocks of heads,
so that it fits on the card beside the program's snapshots.

`lower=True` computes every matrix product from operands rounded to
float8 e4m3 (each scaled by its own maximum over 448), the control one
precision step below the program's bfloat16 products.

Departures from the published model, none of which the check can see:
random weights from a seed; the embedding is scaled by √d_model (the
port's convention for its LMs; HF's DeepseekV3 does not scale — with
random weights this only sets the residual stream's scale); RoPE rotates
halves (HF permutes the rope dims to an interleaved layout first, which
random weights make immaterial); the optimizer is FIXAR's Adam on the
Q15.16 lattice, where Moonlight was trained with Muon; the vocabulary is a
slice (ids 0 .. vocab_size − 1) and the experts those held here, as the
configuration states; there are no kernels, no cache and no batching
beyond the step's own batch.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

Tensor = torch.Tensor
FXP_SCALE = 2.0 ** 16  # Q15.16
FAULTS = ("unchanged", "bias_frozen", "expert_in_unfolded")


def settings(config: dict) -> dict:
    """The sizes and constants of the configuration file's keys."""
    c = config
    held0 = c.get("first_expert_held", 0)
    return {"d": c["hidden_size"], "heads": c["num_attention_heads"], "rank": c["kv_lora_rank"],
            "nope": c["qk_nope_head_dim"], "rope": c["qk_rope_head_dim"], "dv": c["v_head_dim"],
            "dense_ff": c["intermediate_size"], "ff": c["moe_intermediate_size"], "experts": c["n_routed_experts"],
            "k": c["num_experts_per_tok"], "shared": c["n_shared_experts"], "scaling": c["routed_scaling_factor"],
            "theta": float(c["rope_theta"]), "eps": c["rms_norm_eps"], "vocab": c["vocab_size"],
            "held": range(held0, held0 + c["n_experts_held"]), "layers": c["num_hidden_layers"],
            "dense_layers": c["first_k_dense_replace"], "gamma": c["bias_update_rate"], "alpha": c["seq_aux_alpha"],
            "qat_bits": c["qat_bits"], "lr": c["adam_lr"], "b1": c["adam_b1"], "b2": c["adam_b2"],
            "adam_eps": c["adam_eps"]}


# ------------------------------------------------------------------ the data
def stream(seed: int, step: int, batch: int, seq: int, vocab: int, zipf_a: float = 1.2, period: int = 8):
    """(tokens, labels), int32 (batch, seq): u^a·V Zipf-like ids with every
    `period`-th position repeating the one before, from a CPU generator
    seeded by numpy's SeedSequence of (seed, step)."""
    s = int(np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0] >> np.uint64(1))
    u = torch.rand((batch, seq + 1), generator=torch.Generator().manual_seed(s))
    toks = (vocab * u ** zipf_a).to(torch.int32) % vocab
    struct = torch.arange(seq + 1) % period == 0
    toks = torch.where(struct[None, :], torch.roll(toks, 1, dims=1), toks)
    return toks[:, :seq].contiguous(), toks[:, 1:seq + 1].contiguous()


# ------------------------------------------------------------------ numerics
def _fp8(t: Tensor) -> Tensor:
    scale = t.detach().abs().amax().clamp_min(1e-30) / 448.0
    return t + ((t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale - t).detach()


def mm(a: Tensor, b: Tensor, lower: bool) -> Tensor:
    """a @ b in float32, from float8-rounded operands when `lower`."""
    return (_fp8(a) @ _fp8(b)) if lower else a @ b


def _ste(x: Tensor, q: Tensor) -> Tensor:
    return x + (q - x).detach()


class Folds(dict):
    """One layer's site ranges as a monitor-phase forward folds them:
    {site: [min, max]} over every value each site saw."""

    def add(self, name: str, x: Tensor) -> None:
        if x.numel():
            lo, hi = float(x.detach().min()), float(x.detach().max())
            was = self.get(name, [math.inf, -math.inf])
            self[name] = [min(was[0], lo), max(was[1], hi)]


def site(x: Tensor, ranges: dict, name: str, phase: str, bits: int) -> Tensor:
    """A QAT site: nothing ("off"), the Q15.16 lattice ("monitor"; its
    input folded into `ranges` when that is a `Folds`), or the frozen
    range's affine grid ("quant", `ranges[name]` its (min, max)), with a
    straight-through gradient (zero outside the grid's range)."""
    if phase == "off":
        return x
    if phase == "monitor":
        if isinstance(ranges, Folds):
            ranges.add(name, x)
        return _ste(x, torch.round(torch.clamp(x * FXP_SCALE, -2.0 ** 31, 2.0 ** 31 - 1)) / FXP_SCALE)
    lo, hi = (torch.as_tensor(v, dtype=torch.float32, device=x.device) for v in ranges[name])
    lo, hi = torch.clamp(lo, max=0.0), torch.clamp(hi, min=0.0)
    levels = 2.0 ** bits - 1.0
    span = lo.abs() + hi.abs()
    delta = torch.where(span > 0, span / levels, torch.ones_like(span))
    z = torch.round(-lo / delta)
    xc = torch.clamp(x, -z * delta, (levels - z) * delta)
    return _ste(xc, torch.round(xc / delta) * delta)


def rmsnorm(x: Tensor, scale: Tensor, eps: float) -> Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def rope(x: Tensor, theta: float) -> Tensor:
    """x (B, S, H, r) rotated by position, halves paired."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = torch.arange(x.shape[1], dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def _attend(q: Tensor, k: Tensor, v: Tensor, scale: float, lower: bool) -> Tensor:
    """Causal softmax attention of (B, H, S, ·) blocks."""
    s = q.shape[2]
    scores = mm(q, k.transpose(-1, -2), lower) * scale
    causal = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), -1)
    return mm(probs, v, lower)


def attention(q: Tensor, k: Tensor, v: Tensor, scale: float, lower: bool, heads_a_block: int = 2) -> Tensor:
    """(B, S, H, ·) -> (B, S, H, dv), a few heads of one sequence at a time,
    each block recomputed in the backward (its scores never all kept)."""
    from torch.utils.checkpoint import checkpoint

    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    rows = []
    for b in range(q.shape[0]):
        blocks = []
        for h in range(0, q.shape[2], heads_a_block):
            blk = [t[b:b + 1, h:h + heads_a_block] for t in (qt, kt, vt)]
            blocks.append(checkpoint(_attend, *blk, scale, lower, use_reentrant=False) if torch.is_grad_enabled()
                          else _attend(*blk, scale, lower))
        rows.append(torch.cat(blocks, 1))
    return torch.cat(rows, 0).transpose(1, 2)


# ------------------------------------------------------------------ the layers
def _swiglu(x: Tensor, p: dict, ranges: dict, prefix: str, phase: str, st: dict, lower: bool) -> Tensor:
    x = site(x, ranges, f"{prefix}_in", phase, st["qat_bits"])
    h = F.silu(mm(x, p["wg"], lower)) * mm(x, p["wu"], lower)
    return mm(site(h, ranges, f"{prefix}_down_in", phase, st["qat_bits"]), p["wd"], lower)


def route(f: Tensor, router: Tensor, bias: Tensor, st: dict, lower: bool, follow=None, margin: float = 0.0):
    """(scores (T, E), chosen experts (T, k), gates (T, k), what the
    choice read).  The choice is the top k of score + bias; or, given
    `follow` (T, k), another choice's: each token takes it where it is
    admissible, k distinct experts none of whose biased scores lies more
    than `margin` below the k-th largest (a near-tie that rounding may
    break either way), and its own top k where not.  What it read:
    "inadmissible" (T, k) the pairs of `follow` that no margin excuses,
    "followed" (T,) the tokens that took a choice other than their own top
    k."""
    scores = torch.sigmoid(mm(f, router, lower))
    biased = scores.detach() + bias
    ranked, idx = torch.sort(biased, dim=-1, descending=True, stable=True)
    k = st["k"]
    idx = idx[:, :k]
    read = {}
    if follow is not None:
        follow = follow.to(idx.device, torch.int64)
        picked = follow.sort(-1).values
        twice = torch.zeros_like(follow, dtype=torch.bool)
        twice[:, 1:] = picked[:, 1:] == picked[:, :-1]
        bad = (biased.gather(1, follow) < ranked[:, k - 1:k] - margin) | twice
        ok = ~bad.any(-1)
        same = (picked == idx.sort(-1).values).all(-1)
        read = {"inadmissible": bad, "followed": ok & ~same}
        idx = torch.where(ok[:, None], follow, idx)
    g = scores.gather(1, idx)
    return scores, idx, g / (g.sum(-1, keepdim=True) + 1e-20) * st["scaling"], read


def balance_loss(scores: Tensor, idx: Tensor, batch: int, st: dict) -> Tensor:
    e, k = scores.shape[1], st["k"]
    s = scores.shape[0] // batch
    f = F.one_hot(idx.reshape(batch, s * k), e).to(torch.float32).sum(1) * (e / (k * s))
    p = (scores / scores.sum(-1, keepdim=True)).reshape(batch, s, e).mean(1)
    return (f * p).sum(-1).mean()


def layer(x: Tensor, p: dict, ranges: dict, bias, phase: str, st: dict, lower: bool = False, follow=None,
          margin: float = 0.0):
    """One layer: (x_out, balance loss (0 for a dense layer), (chosen
    experts, what the choice read: `route`, with `follow` and `margin`)
    or None)."""
    b, s, d = x.shape
    hh, r, nope, rp, dv = st["heads"], st["rank"], st["nope"], st["rope"], st["dv"]
    bits = st["qat_bits"]
    h = site(rmsnorm(x, p["ln1"], st["eps"]), ranges, "attn_in", phase, bits)
    q = mm(h, p["wq"].reshape(d, -1), lower).reshape(b, s, hh, nope + rp)
    kv_a = mm(h, p["wkv_a"], lower)
    c = site(rmsnorm(kv_a[..., :r], p["kv_norm"], st["eps"]), ranges, "attn_kv_in", phase, bits)
    kv = mm(c, p["wkv_b"].reshape(r, -1), lower).reshape(b, s, hh, nope + dv)
    q = torch.cat([q[..., :nope], rope(q[..., nope:], st["theta"])], -1)
    k_pe = rope(kv_a[..., None, r:], st["theta"]).expand(b, s, hh, rp)
    k = torch.cat([kv[..., :nope], k_pe], -1)
    o = attention(q, k, kv[..., nope:], 1.0 / math.sqrt(nope + rp), lower)
    o = site(o.reshape(b, s, hh * dv), ranges, "attn_o_in", phase, bits)
    x = x + mm(o, p["wo"].reshape(hh * dv, d), lower)
    h = rmsnorm(x, p["ln2"], st["eps"])
    if "router" not in p:
        return x + _swiglu(h, p["mlp"], ranges, "mlp", phase, st, lower), x.new_zeros(()), None
    f = site(h.reshape(b * s, d), ranges, "router_in", phase, bits)
    scores, idx, gates, read = route(f, p["router"], bias, st, lower, follow, margin)
    y = torch.zeros_like(f)
    for i, e in enumerate(st["held"]):
        tok, slot = (idx == e).nonzero(as_tuple=True)
        rows = site(f[tok], ranges, "expert_in", phase, bits)
        hid = F.silu(mm(rows, p["wg"][i], lower)) * mm(rows, p["wu"][i], lower)
        out = mm(site(hid, ranges, "expert_down_in", phase, bits), p["wd"][i], lower)
        y = y.index_add(0, tok, out * gates[tok, slot][:, None])
    y = y + _swiglu(f, p["shared"], ranges, "shared", phase, st, lower)
    return x + y.reshape(b, s, d), balance_loss(scores, idx, b, st), (idx, read)


def embed(params: dict, tokens: Tensor) -> Tensor:
    return params["embed"][tokens.long()] * math.sqrt(params["embed"].shape[1])


def head(params: dict, x: Tensor, ranges: dict, phase: str, st: dict, lower: bool) -> Tensor:
    x = site(rmsnorm(x, params["final_norm"], st["eps"]), ranges["head"], "head_in", phase, st["qat_bits"])
    return mm(x, params["head"], lower)


def monitor_ranges(passes: list, st: dict, lower: bool = False, margin: float = 0.0) -> dict:
    """The ranges a training run freezes at the end of its monitor phase,
    folded here: `passes` the monitor-phase steps' (params, bias, tokens,
    another run's choices there or None), each a forward in the monitor
    phase whose sites fold their min and max, its MoE layers following
    the choices where `margin` admits them (`route`); then, per site, a
    range narrower than 1e-6 widened by 0.5 each way.  In `step_grads`'
    layout: {"layers": [{site: (min, max)}, ...], "head": {...}}."""
    layers, hd = None, Folds()
    with torch.no_grad():
        for params, bias, tokens, follow in passes:
            folds = [Folds() for _ in params["layers"]]
            moe_of = [i for i, lp in enumerate(params["layers"]) if "router" in lp]
            bias_of = {li: bias[j] for j, li in enumerate(moe_of)}
            follow_of = {li: follow[j] for j, li in enumerate(moe_of)} if follow is not None else {}
            x = embed(params, tokens)
            for i, lp in enumerate(params["layers"]):
                x, _, _ = layer(x, lp, folds[i], bias_of.get(i), "monitor", st, lower, follow_of.get(i), margin)
            head(params, x, {"head": hd}, "monitor", st, lower)
            if layers is None:
                layers = [Folds() for _ in folds]
            for mine, got in zip(layers, folds):
                for name, (lo, hi) in got.items():
                    was = mine.get(name, [math.inf, -math.inf])
                    mine[name] = [min(was[0], lo), max(was[1], hi)]

    def frozen(lo, hi):
        return (lo, hi) if hi - lo > 1e-6 else (lo - 0.5, hi + 0.5)

    if not passes:
        return {"layers": [], "head": {}}
    return {"layers": [{k: frozen(*v) for k, v in f.items()} for f in layers],
            "head": {k: frozen(*v) for k, v in hd.items()}}


# ------------------------------------------------------------------ the step
def step_grads(params: dict, ranges: dict, bias: Tensor, tokens: Tensor, labels: Tensor, phase: str, st: dict,
               lower: bool = False, logits_rows: int = 0, follow=None, margin: float = 0.0) -> dict:
    """Loss, gradients (in `params`' layout), each MoE layer's chosen
    experts and loads, and the logits of the first `logits_rows` sequences.
    `follow` (MoE layers, T, k): another run's choices, each MoE layer's
    taken where admissible by `margin` (`route`), with "inadmissible" and
    "followed" stacked over the layers.  Layer by layer: the forward
    without autograd, keeping each layer's input; the head's backward;
    then each layer recomputed with autograd and differentiated against
    the gradient of its output."""
    moe_of = [i for i, lp in enumerate(params["layers"]) if "router" in lp]
    if ranges is None:  # the monitor phase, or QAT off: no frozen range is read
        ranges = {"layers": [{} for _ in params["layers"]], "head": {}}
    bias_of = {li: bias[j] for j, li in enumerate(moe_of)}
    follow_of = {li: follow[j] for j, li in enumerate(moe_of)} if follow is not None else {}
    inputs, chosen = [], {}
    with torch.no_grad():
        x = embed(params, tokens)
        for i, lp in enumerate(params["layers"]):
            inputs.append(x)
            x, _, idx = layer(x, lp, ranges["layers"][i], bias_of.get(i), phase, st, lower, follow_of.get(i), margin)
            if idx is not None:
                chosen[i] = idx
    grads: dict = {}
    xl = x.detach().requires_grad_()
    head_p = {k: params[k].detach().requires_grad_() for k in ("final_norm", "head")}
    logits = head(head_p, xl, ranges, phase, st, lower)
    v = labels.numel()
    ce = F.cross_entropy(logits.reshape(v, -1), labels.reshape(-1).long())
    ce.backward()
    out_logits = logits[:logits_rows].detach() if logits_rows else None
    del logits
    grads.update({k: t.grad for k, t in head_p.items()})
    g = xl.grad
    aux_total = torch.zeros((), device=x.device)
    layer_grads = [None] * len(params["layers"])
    for i in reversed(range(len(params["layers"]))):
        lp = _live(params["layers"][i])
        xi = inputs[i].detach().requires_grad_()
        xo, aux, _ = layer(xi, lp, ranges["layers"][i], bias_of.get(i), phase, st, lower, follow_of.get(i), margin)
        outs = [xo, st["alpha"] * aux] if aux.requires_grad else [xo]
        torch.autograd.backward(outs, [g, None][:len(outs)])
        aux_total = aux_total + aux.detach()
        g = xi.grad
        layer_grads[i] = _grads_of(lp)
        inputs[i] = None
    emb = params["embed"].detach().requires_grad_()
    embed({"embed": emb}, tokens).backward(g)
    grads["embed"] = emb.grad
    grads["layers"] = layer_grads
    loads = torch.stack([torch.bincount(chosen[i][0].reshape(-1), minlength=st["experts"]) for i in moe_of])
    out = {"loss": ce.detach() + st["alpha"] * aux_total, "grads": grads, "logits": out_logits,
           "chosen": torch.stack([chosen[i][0] for i in moe_of]), "load": loads}
    if follow is not None:
        out.update({key: torch.stack([chosen[i][1][key] for i in moe_of]) for key in ("inadmissible", "followed")})
    return out


def _live(tree):
    if isinstance(tree, dict):
        return {k: _live(v) for k, v in tree.items()}
    return tree.detach().requires_grad_()


def _grads_of(tree):
    if isinstance(tree, dict):
        return {k: _grads_of(v) for k, v in tree.items()}
    return tree.grad if tree.grad is not None else torch.zeros_like(tree)


def project(x: Tensor) -> Tensor:
    """Onto the Q15.16 lattice (round half to even, saturating)."""
    return torch.round(torch.clamp(x * FXP_SCALE, -2.0 ** 31, 2.0 ** 31 - 1)) / FXP_SCALE


def adam_leaf(p: Tensor, g: Tensor, m: Tensor, v: Tensor, step: int, st: dict):
    """One leaf of FIXAR's Adam at post-increment `step`: the gradient
    projected, Adam, the parameter projected.  (p, m, v) after."""
    g = project(g)
    m = st["b1"] * m + (1 - st["b1"]) * g
    v = st["b2"] * v + (1 - st["b2"]) * g * g
    mhat = m / (1 - st["b1"] ** step)
    vhat = v / (1 - st["b2"] ** step)
    return project(p - st["lr"] * mhat / (torch.sqrt(vhat) + st["adam_eps"])), m, v


def bias_rule(bias: Tensor, load: Tensor, gamma: float) -> Tensor:
    """b += γ·sign(mean load − load), per layer over every expert."""
    load = load.to(torch.float32)
    return bias + gamma * torch.sign(load.mean(-1, keepdim=True) - load)


__all__ = ["FAULTS", "Folds", "settings", "stream", "site", "layer", "route", "balance_loss", "monitor_ranges",
           "step_grads", "adam_leaf", "bias_rule", "project", "mm"]
