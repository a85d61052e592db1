"""A float64 replay of what kernels 4 and 5 hand to their pass 2, for the
checks that hold the kernels against their plain twins.

Pass 2 of each step kernel reduces, per layer of the trained net, the
product inputs q_l (B, K_l) and the cotangents G_l (B, N_l) after the
activation backward into dW = qᵀG and db = Σ G.  The kernel and its twin
(`ref.ref_ddpg_critic_step` / `ref_ddpg_actor_step`) sum in other orders,
so a decision whose exact operand lies within float32 rounding of its edge
can go either way on either side: a ReLU at a pre-activation near 0, a
straight-through mask at a clip bound, a site's rounding onto the Q15.16
lattice or a 16-bit code and its bf16 hi limb.  Such a decision moves a
gradient by a whole row's cotangent or a whole rounding step, which the
one-quantum contract of the moments does not cover.

So the check replays the kernel's own operands, layer by layer, in float64
(`check_step_operands`):

* forward: each q_l must be the kernel's projection (and, in the quant
  phase, bf16 hi limb) of a value its float32 layer can have computed from
  its own q_{l−1}: within the rounding bound below of the exact float64
  value.  A projection is non-decreasing, so the admitted q_l are the
  projections of the bound's two ends: the exact one, or its neighbour
  where the bound reaches across a rounding edge.
* backward: each G_l must be the exact float64 backward of the kernel's own
  G_{l+1} (or of the top cotangent) within the same bound, its ReLU and
  straight-through decisions taken as the exact values decide them, or
  either way where the bound reaches across the edge.  The top cotangent
  needs the values the kernel does not keep: kernel 4's TD target (the
  target nets' forward) and kernel 5's action cotangent (the critic's
  forward and backward).  Those are replayed as intervals, and each
  ambiguous decision of the critic's backward is enumerated per row
  (at most MAX_AMBIGUOUS a row).

The rounding bound of a float32 sum of products is the probabilistic one
of a sequential chain (Higham and Mary, SIAM J. Sci. Comput. 41(5), 2019):
with the exact prefix sums s_k in index order, |error| ≤ λ·u·√(Σ s_k²),
u = 2⁻²⁴, with probability at least 1 − 2·exp(−λ²/2) for rounding errors
that are independent and of mean zero; LAMBDA = 10 makes that 4e-22 per
sum.  The kernel's chains run in k order (a narrow layer's K slices and
the backward's N slices are added in rank order; their partial sums are no
larger than the whole chain's).  On kernel 5's standing case the
pre-activation whose ReLU decision the two sides took apart was −5.3e-7
with Σ|terms| = 4.54: about 2u·Σ|terms|, inside this bound.

With the operands held so, how far the kernel's gradient can lie from the
twin's is what their operands differ by (`pass2_slack`), and the moments
are widened by no more (`step_atol`).  Masked rows (w = 0) must carry an
exactly zero cotangent.
"""

from __future__ import annotations

import itertools
from typing import Optional, Sequence

import torch

from repro_torch.kernels.fxp_matmul.ref import limb_split
from repro_torch.kernels.fxp_mlp.ref import H_GAMMA, H_INVW, H_OMB1, H_OMB2, ref_mlp_forward, site_project

Tensor = torch.Tensor

U = 2.0**-24  # float32's unit roundoff
LAMBDA = 10.0  # the probabilistic bound's width (module docstring)
TANH_ULP = 2  # tanhf's largest error in ulp (CUDA C++ Programming Guide, mathematical functions)
MAX_AMBIGUOUS = 12  # ambiguous decisions of one row the critic's backward replay enumerates
CHUNK = 1 << 24  # float64 elements of one prefix-sum block


# --------------------------------------------------------------------------
# intervals: (centre, radius), float64
# --------------------------------------------------------------------------


def _chain_err(xc: Tensor, xr: Optional[Tensor], w: Tensor) -> Tensor:
    """Rounding bound (M, N) of the float32 chains Σ_k x_k·w_kn for x
    (M, K) in xc ± xr and w (K, N), from the prefix sums in k order."""
    m, k = xc.shape
    n = w.shape[1]
    out = torch.empty((m, n), dtype=torch.float64, device=xc.device)
    step = max(1, CHUNK // max(1, k * n))
    for r0 in range(0, m, step):
        s = (xc[r0:r0 + step, :, None] * w[None]).cumsum(1).abs()
        if xr is not None:
            s += (xr[r0:r0 + step, :, None] * w.abs()[None]).cumsum(1)
        out[r0:r0 + step] = s.square().sum(1).sqrt()
    return LAMBDA * U * out


def _limbs(pc: Tensor, pr: Tensor, quant: bool) -> list:
    """The limbs a layer's products consume of a product input in pc ± pr:
    the bf16 hi limb (the input itself in the quant phase) and, before the
    quant phase, the residual lo limb; each as (centre, radius)."""
    if quant:
        return [(pc, pr)]
    lo, hi = pc - pr, pc + pr
    h_lo = limb_split(_f32(lo, -1), with_lo=False)[0].double()
    h_hi = limb_split(_f32(hi, 1), with_lo=False)[0].double()
    l_lo, l_hi = lo - h_hi, hi - h_lo
    return [((h_lo + h_hi) / 2, (h_hi - h_lo) / 2), ((l_lo + l_hi) / 2, (l_hi - l_lo) / 2)]


def _f32(x: Tensor, direction: int) -> Tensor:
    """x rounded to float32 towards −∞ (direction −1) or +∞ (+1)."""
    y = x.float()
    bad = y.double() > x if direction < 0 else y.double() < x
    toward = torch.full_like(y, -torch.inf if direction < 0 else torch.inf)
    return torch.where(bad, torch.nextafter(y, toward), y)


def _layer(pc: Tensor, pr: Tensor, w: Tensor, b: Tensor, act: str, quant: bool) -> dict:
    """One forward layer on product inputs in pc ± pr: the pre-activation's
    interval (exact products, plus the chains' rounding bound, the limbs'
    add and the bias add) and the activation's."""
    W, B = w.double(), b.double()
    pre_c = pc @ W + B
    lin = pr @ W.abs()
    err = sum(_chain_err(lc, lr, W) for lc, lr in _limbs(pc, pr, quant))
    # then the limbs' add and the bias add, each one rounding
    pre_r = lin + err + U * ((pre_c - B).abs() + pre_c.abs() + 2 * (lin + err))
    lo, hi = pre_c - pre_r, pre_c + pre_r
    if act == "relu":
        h_lo, h_hi = lo.clamp_min(0.0), hi.clamp_min(0.0)
    elif act == "tanh":
        h_lo, h_hi = torch.tanh(lo), torch.tanh(hi)
        slack = TANH_ULP * 2 * U * torch.maximum(h_lo.abs(), h_hi.abs()) + 2.0**-149
        h_lo, h_hi = h_lo - slack, h_hi + slack
    else:
        h_lo, h_hi = lo, hi
    return {"pre_c": pre_c, "pre_r": pre_r, "h_lo": h_lo, "h_hi": h_hi}


class _Sites:
    """The site operands of one net and the phase: its projection and its
    straight-through mask, as the kernel computes them (float32)."""

    def __init__(self, deltas, zs, quant: bool, kw: dict):
        self.deltas, self.zs, self.quant = deltas, zs, quant
        self.qat, self.n_bits, self.phase1 = kw["qat"], kw["n_bits"], kw["fxp32_phase1"]

    def product_input(self, x: Tensor, l: int) -> Tensor:
        """What layer l's products consume of its float32 input x."""
        if self.qat:
            x = site_project(x, self.quant, self.deltas[l], self.zs[l], n_bits=self.n_bits,
                             fxp32_phase1=self.phase1)
        return limb_split(x, with_lo=False)[0] if self.quant else x

    def project(self, lo: Tensor, hi: Tensor, l: int) -> tuple:
        """The product inputs of layer l an input in [lo, hi] can give
        (the projection is non-decreasing), float64."""
        return (self.product_input(_f32(lo, -1), l).double(), self.product_input(_f32(hi, 1), l).double())

    def ste(self, lo: Tensor, hi: Tensor, l: int) -> tuple:
        """Where site l's straight-through mask surely passes, and where
        it may go either way, for an input in [lo, hi]."""
        if not self.qat or not (self.quant or self.phase1):
            return torch.ones_like(lo, dtype=torch.bool), torch.zeros_like(lo, dtype=torch.bool)
        if self.quant:
            d, z = self.deltas[l], self.zs[l]
            b_lo, b_hi = float(-z * d), float((float((1 << self.n_bits) - 1) - z) * d)
        else:
            b_lo, b_hi = -32768.0, 32768.0  # the Q15.16 raw range, as float32 compares it
        sure = (lo >= b_lo) & (hi <= b_hi)
        never = (hi < b_lo) | (lo > b_hi)
        return sure, ~sure & ~never


def _forward(x_lo: Tensor, x_hi: Tensor, ws, bs, acts, sites: _Sites) -> list:
    """Interval forward of a net whose values the kernel keeps to itself;
    per layer its input's and pre-activation's intervals."""
    out = []
    for l, (w, b, act) in enumerate(zip(ws, bs, acts)):
        p_lo, p_hi = sites.project(x_lo, x_hi, l)
        lay = _layer((p_lo + p_hi) / 2, (p_hi - p_lo) / 2, w, b, act, sites.quant)
        out.append({"x_lo": x_lo, "x_hi": x_hi, **lay})
        x_lo, x_hi = lay["h_lo"], lay["h_hi"]
    return out


def _act_bwd(gc: Tensor, gr: Tensor, lay: dict, act: str, on: Optional[Tensor] = None) -> tuple:
    """Activation backward on a cotangent in gc ± gr: ReLU by the mask
    `on` (default: where the pre-activation is surely positive), tanh by
    1 − h² with its float32 roundings.  Returns (centre, radius)."""
    if act == "relu":
        keep = (lay["pre_c"] - lay["pre_r"] > 0.0) if on is None else on
        return gc * keep, gr * keep
    if act == "tanh":
        hc, hr = (lay["h_lo"] + lay["h_hi"]) / 2, (lay["h_hi"] - lay["h_lo"]) / 2
        h2c, h2r = hc * hc, 2 * hc.abs() * hr + hr * hr
        sc = 1.0 - h2c
        sr = h2r + U * (h2c + h2r) + U * (sc.abs() + h2r)
        c = gc * sc
        r = gc.abs() * sr + gr * (sc.abs() + sr)
        return c, r + U * (c.abs() + r)
    return gc, gr


def _relu_ambiguous(lay: dict) -> Tensor:
    return (lay["pre_c"] - lay["pre_r"] <= 0.0) & (lay["pre_c"] + lay["pre_r"] > 0.0)


def _fits(k: Tensor, c: Tensor, r: Tensor, zero_ok: Tensor) -> Tensor:
    return ((k - c).abs() <= r) | (zero_ok & (k == 0.0))


# --------------------------------------------------------------------------
# the twin's side
# --------------------------------------------------------------------------


def _halves(c: dict) -> tuple:
    n = len(c["kw"]["actor_acts"])
    if not c["kw"]["qat"]:
        return (None, None), (None, None)
    return (c["deltas"][:n], c["zs"][:n]), (c["deltas"][n:], c["zs"][n:])


def _twin_backward(g: Tensor, x0: Tensor, ws, qs, hs, acts, sites: _Sites, keep: bool) -> tuple:
    """`ref.ref_mlp_backward` keeping each layer's G_l (after the
    activation backward).  Returns (dx of x0, [G_l])."""
    from repro_torch.kernels.fxp_mlp.ref import ste_pass_mask

    gs = [None] * len(ws)
    for li in reversed(range(len(ws))):
        if acts[li] == "relu":
            g = torch.where(hs[li] > 0.0, g, torch.zeros_like(g))
        elif acts[li] == "tanh":
            g = g * (1.0 - hs[li] * hs[li])
        if keep:
            gs[li] = g
        g = g @ ws[li].t()
        if sites.qat:
            x_in = x0 if li == 0 else hs[li - 1]
            mask = ste_pass_mask(x_in, sites.quant, sites.deltas[li], sites.zs[li], n_bits=sites.n_bits,
                                 fxp32_phase1=sites.phase1)
            if mask is not None:
                g = torch.where(mask, g, torch.zeros_like(g))
    return g, gs


def step_twin(c: dict, name: str, quant: bool, critic=None) -> dict:
    """The twin's pass-2 operands of kernel 4 (name "critic") or 5
    ("actor", through `critic`): qs, gs of the trained net, and its per-row
    q (the critic's output) and y (kernel 4's TD target, else None)."""
    kw = c["kw"]
    fkw = dict(quant=quant, n_bits=kw["n_bits"], qat=kw["qat"], fxp32_phase1=kw["fxp32_phase1"])
    (da, za), (dc, zc) = _halves(c)
    s_a, s_c = _Sites(da, za, quant, kw), _Sites(dc, zc, quant, kw)
    hyper, w = c["hyper"], c["w"]
    if name == "critic":
        next_a, _, _ = ref_mlp_forward(c["next_obs"], *c["actor_t"], da, za, activations=kw["actor_acts"], **fkw)
        q_next, _, _ = ref_mlp_forward(torch.cat([c["next_obs"], next_a], dim=-1), *c["critic_t"], dc, zc,
                                       activations=kw["critic_acts"], **fkw)
        y = c["reward"] + (hyper[H_GAMMA] * (1.0 - c["done"])) * q_next[:, 0]
        xc = torch.cat([c["obs"], c["action"]], dim=-1)
        q, _, _, qs, hs = ref_mlp_forward(xc, *c["critic"], dc, zc, activations=kw["critic_acts"],
                                          save_residuals=True, **fkw)
        g = torch.zeros_like(q)
        g[:, 0] = (hyper[H_INVW] * w) * (2.0 * (q[:, 0] - y))
        _, gs = _twin_backward(g, xc, c["critic"][0], qs, hs, kw["critic_acts"], s_c, True)
        return {"qs": qs, "gs": gs, "q": q[:, 0], "y": y}
    a, _, _, qs, hs = ref_mlp_forward(c["obs"], *c["actor"], da, za, activations=kw["actor_acts"],
                                      save_residuals=True, **fkw)
    xa = torch.cat([c["obs"], a], dim=-1)
    q, _, _, c_qs, c_hs = ref_mlp_forward(xa, *critic, dc, zc, activations=kw["critic_acts"], save_residuals=True,
                                          **fkw)
    g = torch.zeros_like(q)
    g[:, 0] = (-hyper[H_INVW]) * w
    dxa, _ = _twin_backward(g, xa, critic[0], c_qs, c_hs, kw["critic_acts"], s_c, False)
    _, gs = _twin_backward(dxa[:, c["obs"].shape[1]:].contiguous(), c["obs"], c["actor"][0], qs, hs,
                           kw["actor_acts"], s_a, True)
    return {"qs": qs, "gs": gs, "q": q[:, 0], "y": None}


# --------------------------------------------------------------------------
# the kernel's side
# --------------------------------------------------------------------------


def _target_y(c: dict, s_a: _Sites, s_c: _Sites) -> tuple:
    """Kernel 4's TD target y = r + (γ·(1 − done))·q_next as an interval,
    from the target nets' interval forward."""
    kw = c["kw"]
    nxt = c["next_obs"].double()
    ta = _forward(nxt, nxt, *c["actor_t"], kw["actor_acts"], s_a)
    a_lo, a_hi = ta[-1]["h_lo"], ta[-1]["h_hi"]
    tc = _forward(torch.cat([nxt, a_lo], -1), torch.cat([nxt, a_hi], -1), *c["critic_t"], kw["critic_acts"], s_c)
    q_lo, q_hi = tc[-1]["h_lo"][:, 0], tc[-1]["h_hi"][:, 0]
    gn = (c["hyper"][H_GAMMA] * (1.0 - c["done"])).double()  # the kernel's float32 products, exactly
    t_c, t_r = gn * (q_lo + q_hi) / 2, gn.abs() * (q_hi - q_lo) / 2
    t_r = t_r + U * (t_c.abs() + t_r)
    y_c = c["reward"].double() + t_c
    return y_c, t_r + U * (y_c.abs() + t_r)


def _critic_da(c: dict, crit: list, critic, s_c: _Sites, g0: Tensor, o: int, fails: list) -> tuple:
    """Kernel 5's action cotangent: the critic's backward from g0 (M,) at
    its output's column 0, over the critic forward `crit` (intervals).  Each
    row's ambiguous decisions (ReLU, straight-through; the action columns'
    mask at site 0) are enumerated.  Returns (row of each candidate,
    centre, radius of its da (n, A), ambiguous decisions)."""
    ws, acts = critic[0], c["kw"]["critic_acts"]
    m, n_l = g0.shape[0], len(ws)
    relu = [(lay["pre_c"] - lay["pre_r"] > 0.0, _relu_ambiguous(lay) if a == "relu" else
             torch.zeros_like(lay["pre_c"], dtype=torch.bool)) for lay, a in zip(crit, acts)]
    ste = [s_c.ste(lay["x_lo"], lay["x_hi"], l) for l, lay in enumerate(crit)]
    ste[0] = (ste[0][0][:, o:], ste[0][1][:, o:])
    decisions = [("relu", l, relu[l][1]) for l in range(n_l)] + [("ste", l, ste[l][1]) for l in range(n_l)]
    counts = sum(d.sum(1) for _, _, d in decisions)
    rows = [torch.arange(m, device=g0.device)]
    sets = [[] for _ in range(m)]
    over = int((counts > MAX_AMBIGUOUS).sum())
    if over:
        fails.append(f"{over} rows of the critic's backward with more than {MAX_AMBIGUOUS} ambiguous decisions")
    for r in torch.nonzero((counts > 0) & (counts <= MAX_AMBIGUOUS)).flatten().tolist():
        sites = [(kind, l, j) for kind, l, d in decisions for j in torch.nonzero(d[r]).flatten().tolist()]
        for bits in itertools.product((False, True), repeat=len(sites)):
            sets[r].append(dict(zip(sites, bits)))
    extra = [(r, choice) for r in range(m) for choice in sets[r]]
    cand = torch.cat(rows + [torch.tensor([r for r, _ in extra], dtype=torch.long, device=g0.device)])

    chosen = {}  # (kind, layer) → the enumerated candidates' (rows, columns, choices)
    for i, (_, choice) in enumerate(extra):
        for (kind, l, j), on in choice.items():
            rows_, cols, ons = chosen.setdefault((kind, l), ([], [], []))
            rows_.append(m + i)
            cols.append(j)
            ons.append(on)

    def masks(kind: str, l: int, sure: Tensor, amb: Tensor) -> Tensor:
        mk = sure[cand].clone()
        if (kind, l) in chosen:
            rows_, cols, ons = (torch.tensor(v, device=mk.device) for v in chosen[(kind, l)])
            mk[rows_, cols] = ons
        return mk

    gc = torch.zeros((cand.shape[0], ws[-1].shape[1]), dtype=torch.float64, device=g0.device)
    gc[:, 0] = g0.double()[cand]
    gr = torch.zeros_like(gc)
    for l in reversed(range(n_l)):
        lay = {k: v[cand] for k, v in crit[l].items()}
        gc, gr = _act_bwd(gc, gr, lay, acts[l], masks("relu", l, *relu[l]) if acts[l] == "relu" else None)
        W = ws[l].double()
        if l == 0:
            W = W[o:]
        dc = gc @ W.t()
        dr = gr @ W.abs().t() + _chain_err(gc, gr, W.t())
        keep = masks("ste", l, *ste[l])
        gc, gr = dc * keep, dr * keep
    return cand, gc, gr, int(counts.sum())


def check_step_operands(c: dict, name: str, quant: bool, kqs: Sequence[Tensor], kgs: Sequence[Tensor],
                        critic=None) -> dict:
    """Hold kernel 4's (name "critic") or 5's ("actor", through `critic`)
    pass-2 operands kqs, kgs to the float64 replay (module docstring).
    Returns {"failures": [...], "ambiguous": decisions within their
    rounding bound, "rounded_apart" / "relu_apart": where the kernel's
    operands took a decision apart from the twin's, per layer,
    "relu_apart_first": the first few such ReLU decisions with their exact
    pre-activation, bound and Σ|terms|, "twin": the twin's operands
    (`step_twin`)}."""
    kw = c["kw"]
    (da, za), (dc, zc) = _halves(c)
    s_a, s_c = _Sites(da, za, quant, kw), _Sites(dc, zc, quant, kw)
    sites, ws, bs, acts = ((s_c, *c["critic"], kw["critic_acts"]) if name == "critic"
                           else (s_a, *c["actor"], kw["actor_acts"]))
    x0 = torch.cat([c["obs"], c["action"]], -1) if name == "critic" else c["obs"]
    fails, ambiguous = [], 0
    w = c["w"]
    # ---- forward of the trained net from the kernel's own product inputs
    layers, x_lo, x_hi = [], x0.double(), x0.double()
    for l, (wl, bl, act) in enumerate(zip(ws, bs, acts)):
        p_lo, p_hi = sites.project(x_lo, x_hi, l)
        kq = kqs[l].double()
        out = (kq < p_lo) | (kq > p_hi)
        if bool(out.any()):
            fails.append(f"layer {l}: {int(out.sum())} product inputs outside the rounding of their replayed input "
                         f"(worst by {float(torch.maximum(p_lo - kq, kq - p_hi).max()):.3e})")
        ambiguous += int((p_lo != p_hi).sum())
        lay = _layer(kq, torch.zeros_like(kq), wl, bl, act, quant)
        layers.append({"x_lo": x_lo, "x_hi": x_hi, **lay})
        x_lo, x_hi = lay["h_lo"], lay["h_hi"]
    # ---- the cotangent at the top, then each layer from the kernel's own G
    m, n_l = x0.shape[0], len(ws)
    iw = (c["hyper"][H_INVW] * w).double()  # the kernel's float32 product, exactly
    top = layers[-1]
    zero_ok = torch.zeros_like(top["pre_c"], dtype=torch.bool)
    if name == "critic":
        y_c, y_r = _target_y(c, s_a, s_c)
        q_c, q_r = (top["h_lo"][:, 0] + top["h_hi"][:, 0]) / 2, (top["h_hi"][:, 0] - top["h_lo"][:, 0]) / 2
        d_c, d_r = q_c - y_c, q_r + y_r
        d_r = d_r + U * (d_c.abs() + d_r)
        gc, gr = torch.zeros_like(top["pre_c"]), torch.zeros_like(top["pre_c"])
        gc[:, 0], gr[:, 0] = iw * 2 * d_c, iw.abs() * 2 * d_r
        gr[:, 0] += U * (gc[:, 0].abs() + gr[:, 0])
        if acts[-1] == "relu":
            ambiguous += int(_relu_ambiguous(top).sum())
            zero_ok = _relu_ambiguous(top)
        ec, er = _act_bwd(gc, gr, top, acts[-1])
        rows_ok = _fits(kgs[-1].double(), ec, er, zero_ok).all(1)
    else:
        a_lo, a_hi = top["h_lo"], top["h_hi"]
        o = c["obs"].shape[1]
        xa = c["obs"].double()
        crit = _forward(torch.cat([xa, a_lo], -1), torch.cat([xa, a_hi], -1), *critic, kw["critic_acts"], s_c)
        g0 = (-c["hyper"][H_INVW]) * w  # the kernel's float32 product
        cand, dc_, dr_, n_amb = _critic_da(c, crit, critic, s_c, g0, o, fails)
        ambiguous += n_amb
        lay = {k: v[cand] for k, v in top.items()}
        amb = _relu_ambiguous(lay) if acts[-1] == "relu" else torch.zeros_like(dc_, dtype=torch.bool)
        ec, er = _act_bwd(dc_, dr_, lay, acts[-1])
        ok = _fits(kgs[-1].double()[cand], ec, er, amb).all(1)
        rows_ok = torch.zeros(m, dtype=torch.long, device=ok.device).index_add_(0, cand, ok.long()) > 0
    if not bool(rows_ok.all()):
        fails.append(f"layer {n_l - 1}: cotangents of {int((~rows_ok).sum())} rows off the replay of the top")
    for l in reversed(range(n_l - 1)):
        g = kgs[l + 1].double()
        W = ws[l + 1].double()
        dxc = g @ W.t()
        dxr = _chain_err(g, None, W.t())
        sure, amb_ste = sites.ste(layers[l + 1]["x_lo"], layers[l + 1]["x_hi"], l + 1)
        keep = sure | amb_ste
        amb_relu = _relu_ambiguous(layers[l]) if acts[l] == "relu" else torch.zeros_like(sure)
        ambiguous += int(amb_ste.sum() + amb_relu.sum())
        ec, er = _act_bwd(dxc * keep, dxr * keep, layers[l], acts[l], (layers[l]["pre_c"] - layers[l]["pre_r"] > 0.0)
                          | amb_relu)
        bad = ~_fits(kgs[l].double(), ec, er, amb_ste | amb_relu)
        if bool(bad.any()):
            fails.append(f"layer {l}: {int(bad.sum())} cotangents off the replay of layer {l + 1}'s")
    live = w != 0.0
    for l in range(n_l):
        if bool((kgs[l][~live] != 0.0).any()):
            fails.append(f"layer {l}: a masked row carries a cotangent")
    twin = step_twin(c, name, quant, critic)
    rounded = [int((k != t).sum()) for k, t in zip(kqs, twin["qs"])]
    relu_apart, decisions = [], []
    for l, (kg, tg, a) in enumerate(zip(kgs, twin["gs"], acts)):
        apart = ((kg != 0.0) != (tg != 0.0)) & live[:, None] if a == "relu" else torch.zeros_like(kg, dtype=torch.bool)
        relu_apart.append(int(apart.sum()))
        for r, j in torch.nonzero(apart)[:8].tolist():  # the first few, with what decided them
            decisions.append({"layer": l, "row": r, "unit": j, "pre_activation": float(layers[l]["pre_c"][r, j]),
                              "bound": float(layers[l]["pre_r"][r, j]),
                              "sum_abs_terms": float(kqs[l][r].double().abs() @ ws[l][:, j].double().abs()
                                                     + bs[l][j].double().abs()),
                              "kernel_G": float(kg[r, j]), "twin_G": float(tg[r, j])})
    return {"failures": fails, "ambiguous": ambiguous, "rounded_apart": rounded, "relu_apart": relu_apart,
            "relu_apart_first": decisions, "twin": twin}


# --------------------------------------------------------------------------
# pass 2: from operands to the moments' tolerance
# --------------------------------------------------------------------------


def pass2_slack(twin: dict, kqs: Sequence[Tensor], kgs: Sequence[Tensor]) -> tuple:
    """How far the kernel's dW_l = qᵀG and db_l = ΣG can lie from the
    twin's by their operands alone: |q_k|ᵀ|ΔG| + |Δq|ᵀ|G_t| and Σ|ΔG|; and
    the twin's own.  Returns ([slack of w0, w1, ..., b0, b1, ...], [the
    twin's gradient of each]), float64."""
    sw, sb, gw, gb = [], [], [], []
    for kq, kg, tq, tg in zip(kqs, kgs, twin["qs"], twin["gs"]):
        kq, kg, tq, tg = kq.double(), kg.double(), tq.double(), tg.double()
        dg = (kg - tg).abs()
        sw.append(kq.abs().t() @ dg + (kq - tq).abs().t() @ tg.abs())
        sb.append(dg.sum(0))
        gw.append(tq.t() @ tg)
        gb.append(tg.sum(0))
    return sw + sb, gw + gb


def step_atol(hyper: Tensor, slack: Sequence[Tensor], grads: Sequence[Tensor], tree: str, atol: float) -> list:
    """Per-leaf absolute tolerance of one tree: `atol`, the moments widened
    by what the gradient's slack S moves them: m by (1 − b1)·S, v by
    (1 − b2)·|Δ(g²)| ≤ (1 − b2)·S·(2|g| + S + 2⁻¹⁶) (the projected
    gradient is one quantum from the exact one)."""
    if tree == "mu":
        return [atol + float(hyper[H_OMB1]) * s for s in slack]
    if tree == "nu":
        return [atol + float(hyper[H_OMB2]) * s * (2.0 * g.abs() + s + 2.0**-16) for s, g in zip(slack, grads)]
    return [atol] * len(slack)


def unchanged_fails(x: Tensor, want: Tensor, atol, rtol: float) -> bool:
    """Whether a leaf left as it was (x) fails the comparison against the
    twin's new leaf `want` at atol + rtol·|want|: the step moved it past
    its tolerance somewhere."""
    err = (x.double() - want.double()).abs()
    return bool((err > atol + rtol * want.double().abs()).any())


def one_row(c: dict, twin: dict, eps: float) -> Tensor:
    """What one row whose outputs moved within a forward contract `eps` (a
    flipped decision) can move each loss partial by: w·ε(1+|q|) for Σ w·q;
    for kernel 4, w(2|q−y|·Δd + Δd²), Δd = ε(2 + |q| + |y|), for Σ w(q−y)²
    and w·ε(1+|y|) for Σ w·y — the largest row's."""
    w, q = c["w"].double().abs(), twin["q"].double()
    if twin["y"] is None:
        return (w * eps * (1.0 + q.abs())).max().reshape(1)
    y = twin["y"].double()
    dd = eps * (2.0 + q.abs() + y.abs())
    return torch.stack([(w * (2.0 * (q - y).abs() * dd + dd * dd)).max(), (w * eps * (1.0 + y.abs())).max()])


# --------------------------------------------------------------------------
# the whole check of one step kernel's result
# --------------------------------------------------------------------------

# (atol, rtol) of the four trees in both phases: the monitor-phase contract
# of tests/test_torch_ddpg_step.py (its docstring); mu and nu widened leaf
# by leaf by the operands' slack (`step_atol`)
STEP_TOL = {"params": (2.0**-16, 0.0), "mu": (2e-6, 1e-4), "nu": (1e-7, 1e-4), "targets": (1e-6, 0.0)}
# loss partials over Σw, the update's metrics, (rtol, atol): the reference's
# metric contracts per phase (tests/kernels/test_fxp_mlp_step.py:95, :110;
# a sum of rows of both signs can cancel, so its own relative error says
# little).  The reference holds them at no fewer live rows than PART_ROWS
# (batches of 8 in the monitor phase, 32 in the quant phase); below that a
# plan-edge case adds one row's flipped decision (`one_row`) at kernel B's
# forward contract FORWARD_TOL.
PART_TOL = {"monitor": (1e-5, 1e-6), "quant": (1e-3, 1e-5)}
PART_ROWS = {"monitor": 8, "quant": 32}
FORWARD_TOL = {"monitor": 2e-5, "quant": 1e-3}
EXTREMA_TOL = 2e-5  # site extrema past layer 0 (kernel B's forward contract); layer 0's are exact


def _leaves(tree) -> list:
    return [*tree[0], *tree[1]]


def check_step(got, want, c: dict, name: str, quant: bool, kqs, kgs, critic=None, edge: bool = False) -> dict:
    """Kernel 4's (name "critic") or 5's ("actor", through `critic`) result
    `got` against its twin's `want`, with the kernel's pass-2 operands kqs,
    kgs: the operands against the replay (`check_step_operands`); the four
    trees at STEP_TOL, mu and nu each leaf widened by the operands' slack,
    and every leaf of params, mu and targets moved by the twin past its
    tolerance (so a tree left as it was fails; params as a tree, since
    Adam's step of one leaf can stay within a Q15.16 quantum); the site
    extrema; the loss
    partials at PART_TOL, plus one row's flipped decision for a plan-edge
    case (`edge`) with fewer live rows than PART_ROWS.  Returns
    {"failures", "max_abs" per tree, "moved" (the twin's least move of
    params, mu and targets), "worst" (per tree of params and mu, the
    element farthest from the twin's: its leaf, index, error, the gradient
    there on each side from the operands and its slack in quanta, and v
    before the step), "replay"}."""
    phase = "quant" if quant else "monitor"
    rep = check_step_operands(c, name, quant, kqs, kgs, critic)
    fails = list(rep["failures"])
    slack, grads = pass2_slack(rep["twin"], kqs, kgs)
    inputs = [c[name], c[f"{name}_m"], c[f"{name}_v"], c[f"{name}_t"]]
    errs, moved, stale, worst = {}, {}, {}, {}
    for k, (tree, (atol, rtol)) in enumerate(STEP_TOL.items()):
        for leaf, (g, w, x, a) in enumerate(zip(_leaves(got[k]), _leaves(want[k]), _leaves(inputs[k]),
                                                step_atol(c["hyper"], slack, grads, tree, atol))):
            err = (g.double() - w.double()).abs()
            over = err - (a + rtol * w.double().abs())
            errs[tree] = max(errs.get(tree, 0.0), float(err.max()))
            if not bool(torch.isfinite(g).all()) or bool((over > 0).any()):
                fails.append(f"{tree} leaf {leaf}: error {float(err.max()):.4e} past its tolerance by "
                             f"{float(over.max()):.4e}")
            if tree in ("params", "mu") and float(err.max()) > worst.get(tree, {}).get("error", -1.0):
                i = int(err.argmax())
                kq, kg = kqs[leaf % len(kqs)].double(), kgs[leaf % len(kgs)].double()
                kgrad = (kq.t() @ kg).flatten() if leaf < len(kqs) else kg.sum(0)
                worst[tree] = {"leaf": leaf, "index": i, "error": float(err.flatten()[i]),
                               "kernel_grad_quanta": float(kgrad[i]) * 2.0**16,
                               "twin_grad_quanta": float(grads[leaf].flatten()[i]) * 2.0**16,
                               "slack_quanta": float(slack[leaf].flatten()[i]) * 2.0**16,
                               "v": float(_leaves(inputs[2])[leaf].flatten()[i])}
            if tree != "nu":
                moved[tree] = min(moved.get(tree, torch.inf), float((w - x).abs().max()))
                leaf_stale = not unchanged_fails(x, w, a, rtol)
                stale[tree] = stale.get(tree, True) and leaf_stale
                if tree != "params" and leaf_stale:
                    fails.append(f"{tree} leaf {leaf}: the twin moves it within its tolerance")
    if stale["params"]:
        fails.append("params: the twin moves no leaf past its tolerance")
    mins, maxs = got[4].amin(0), got[5].amax(0)
    if float(mins[0]) != float(want[4][0, 0]) or float(maxs[0]) != float(want[5][0, 0]):
        fails.append("layer-0 extrema differ")
    for g, w in ((mins, want[4][0]), (maxs, want[5][0])):
        err = (g.double() - w.double()).abs()
        errs["extrema"] = max(errs.get("extrema", 0.0), float(err.max()))
        if bool((err > EXTREMA_TOL + EXTREMA_TOL * w.double().abs()).any()):
            fails.append(f"extrema: error {float(err.max()):.4e}")
    rtol, atol = PART_TOL[phase]
    sum_w = torch.clamp(c["w"].sum(), min=1.0).double()
    if edge and float(sum_w) < PART_ROWS[phase]:
        atol = atol + one_row(c, rep["twin"], FORWARD_TOL[phase]) / sum_w
    gp, wp = got[6].sum(0).double() / sum_w, want[6][0].double() / sum_w
    err = (gp - wp).abs()
    errs["partials"] = float(err.max())
    if not bool(torch.isfinite(gp).all()) or bool((err > atol + rtol * wp.abs()).any()):
        fails.append(f"loss partials / Σw: error {err.tolist()}")
    stats = {k: rep[k] for k in ("ambiguous", "rounded_apart", "relu_apart", "relu_apart_first")}
    stats["max_slack_quanta"] = max(float(t.max()) for t in slack) * 2.0**16 if slack else 0.0
    return {"failures": fails, "max_abs": errs, "moved": moved, "worst": worst, "replay": stats}


__all__ = ["check_step", "check_step_operands", "one_row", "pass2_slack", "step_atol", "step_twin",
           "unchanged_fails", "STEP_TOL", "PART_TOL", "PART_ROWS", "FORWARD_TOL"]
