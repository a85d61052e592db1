"""Plain PyTorch versions of the fused MLP kernels (port of
`repro.kernels.fxp_mlp.ref`, plus the fused kernels' own plain twins).

The forward has two functions, because the reference has two site
projections that look alike but are not the same arithmetic:

* `ref_mlp_forward` — the plain version of kernel B (`csrc/fxp_mlp_fwd.cu`,
  `_mlp_kernel` in the reference): per layer the range monitor, then the
  fused site projection `_site_project` on the affine operands delta/z,
  quant phase `(clip(round(x/δ)+z, 0, 2ⁿ−1) − z)·δ`, monitor phase the
  Q15.16 lattice; then the hi-limb dot, the lo-limb dot in the monitor
  phase, bias and activation.  `ops.fxp_mlp_forward` runs it for CPU
  tensors; `chip_smoke.py` holds the kernel against it on the card.
* `ref_fxp_mlp` — the reference's per-layer oracle: the QAT site as
  `fake_quant_affine` on the captured ranges a_min/a_max (or `fake_quant`
  onto Q15.16), followed by `ref_fxp_dense`.

`ref_mlp_forward(save_residuals=True)` also returns what the backward
needs, and `ref_mlp_backward` is the plain version of kernel 3
(`csrc/fxp_mlp_bwd.cu`, `_mlp_bwd_kernel` in the reference): the
dx/dW/db chain written out layer by layer, not autograd, because autograd
through the plain forward's `round`/`clamp` gives no straight-through
gradient.

`ref_ddpg_critic_step` and `ref_ddpg_actor_step` are the plain twins of
kernels 4 and 5 (`csrc/fxp_ddpg_step.cu`, `_ddpg_critic_step_kernel` and
`_ddpg_actor_step_kernel` in the reference), built from those two and the
optimizer's own `leaf_update`: each returns what its kernel wrapper
returns, with one "block" of monitor rows and partials.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.core import fixedpoint as fxp
from repro_torch.kernels.fxp_matmul.ref import _ACTIVATIONS, limb_split, ref_fxp_dense
from repro_torch.optim import adam, fxp_adam

Tensor = torch.Tensor

# The fused step's hyper vector (the reference's layout, kernel.py:42-54):
# the loss and soft-update scalars, then Adam's `StepConstants`.
H_INVW = 0  # 1 / max(sum(w), 1)
H_GAMMA = 1  # discount (critic step only)
H_TAU = 2  # soft-update rate
H_OMTAU = 3  # 1 - tau, folded in double, then float32
H_LR = 4
H_B1 = 5
H_OMB1 = 6
H_B2 = 7
H_OMB2 = 8
H_EPS = 9
H_BC1 = 10  # 1 - b1**t
H_BC2 = 11  # 1 - b2**t
HYPER_LEN = 12


def site_project(
    x: Tensor, quant: bool, delta: Tensor, z: Tensor, *, n_bits: int, fxp32_phase1: bool
) -> Tensor:
    """The fused kernel's phase-selected site projection (`_site_project`)."""
    if quant:
        q = torch.clamp(torch.round(x / delta) + z, 0.0, float((1 << n_bits) - 1))
        return (q - z) * delta
    if fxp32_phase1:
        s32 = float(2.0**fxp.FXP32.frac_bits)
        return torch.round(torch.clamp(x * s32, float(fxp.FXP32.raw_min), float(fxp.FXP32.raw_max))) / s32
    return x


def ref_mlp_forward(
    x: Tensor,
    weights: Sequence[Tensor],
    biases: Sequence[Tensor],
    deltas: Tensor,
    zs: Tensor,
    *,
    activations: Sequence[str],
    quant: bool,
    n_bits: int = 16,
    qat: bool = True,
    fxp32_phase1: bool = True,
    save_residuals: bool = False,
):
    """Plain version of kernel B on unpadded x (M, K0): returns
    (y (M, N_L), site_mins (L,), site_maxs (L,)).

    With `save_residuals`, also (qs, hs): qs[l] (M, K_l) is the input the
    layer's products consumed (the hi limb in the quant phase, the
    projected input before it) and hs[l] (M, N_l) the layer's output after
    its activation, hs[L-1] = y."""
    mins, maxs, qs, hs = [], [], [], []
    for i, (w, b) in enumerate(zip(weights, biases)):
        mins.append(x.min())
        maxs.append(x.max())
        if qat:
            x = site_project(x, quant, deltas[i], zs[i], n_bits=n_bits, fxp32_phase1=fxp32_phase1)
        hi, lo = limb_split(x, with_lo=not quant)
        if save_residuals:
            qs.append(hi if quant else x)
        acc = hi @ w
        if not quant:
            acc = acc + lo @ w
        x = _ACTIVATIONS[activations[i]](acc + b)
        hs.append(x)
    if save_residuals:
        return x, torch.stack(mins), torch.stack(maxs), qs, hs
    return x, torch.stack(mins), torch.stack(maxs)


def ste_pass_mask(
    x_in: Tensor, quant: bool, delta: Tensor, z: Tensor, *, n_bits: int, fxp32_phase1: bool
) -> Optional[Tensor]:
    """Where a site's straight-through gradient passes: inside the affine
    clip range [−zδ, (2ⁿ−1−z)δ] in the quant phase, inside the Q15.16 raw
    range before it (None: everywhere)."""
    if quant:
        lo = -z * delta
        hi = (float((1 << n_bits) - 1) - z) * delta
        return (x_in >= lo) & (x_in <= hi)
    if fxp32_phase1:
        xs = x_in * float(2.0**fxp.FXP32.frac_bits)
        return (xs >= float(fxp.FXP32.raw_min)) & (xs <= float(fxp.FXP32.raw_max))
    return None


def ref_mlp_backward(
    g: Tensor,
    x0: Tensor,
    weights: Sequence[Tensor],
    qs: Sequence[Tensor],
    hs: Sequence[Tensor],
    deltas: Optional[Tensor],
    zs: Optional[Tensor],
    *,
    activations: Sequence[str],
    quant: bool,
    n_bits: int = 16,
    qat: bool = True,
    fxp32_phase1: bool = True,
) -> tuple[Tensor, list, list]:
    """Plain version of kernel 3: the cotangent g (M, N_L) of y walked from
    the last layer to the first.  Per layer: activation backward from the
    saved output (ReLU `h > 0`, tanh `1 − h²`), db = Σ_rows g,
    dW = qᵀg, g ← g Wᵀ, then the site's STE mask on its input (x0 for
    layer 0, hs[l−1] after).  Returns (dx (M, K0), [dW_l], [db_l])."""
    n_layers = len(weights)
    dws, dbs = [None] * n_layers, [None] * n_layers
    for li in reversed(range(n_layers)):
        h = hs[li]
        if activations[li] == "relu":
            g = torch.where(h > 0.0, g, torch.zeros_like(g))
        elif activations[li] == "tanh":
            g = g * (1.0 - h * h)
        dbs[li] = g.sum(dim=0)
        dws[li] = qs[li].t() @ g
        g = g @ weights[li].t()
        if qat:
            x_in = x0 if li == 0 else hs[li - 1]
            mask = ste_pass_mask(x_in, quant, deltas[li], zs[li], n_bits=n_bits, fxp32_phase1=fxp32_phase1)
            if mask is not None:
                g = torch.where(mask, g, torch.zeros_like(g))
    return g, dws, dbs


def ref_fxp_mlp(
    x: Tensor,
    weights: Sequence[Tensor],
    biases: Sequence[Tensor],
    *,
    activations: Sequence[str],
    quant_phase,
    a_mins: Optional[Tensor] = None,
    a_maxs: Optional[Tensor] = None,
    n_bits: int = 16,
    qat: bool = True,
    fxp32_phase1: bool = True,
) -> tuple[Tensor, Tensor, Tensor]:
    """The reference oracle: returns (y, site_mins, site_maxs) like
    `fxp_mlp_forward`.  a_mins/a_maxs: (L,) finalized captured ranges per
    site (only read in the quantized phase)."""
    quant = bool(quant_phase)
    x = torch.as_tensor(x, dtype=torch.float32)
    orig_shape = x.shape
    x = x.reshape(-1, orig_shape[-1])
    mins, maxs = [], []
    for i in range(len(weights)):
        mins.append(x.min())
        maxs.append(x.max())
        if qat:
            if quant:
                x = fxp.fake_quant_affine(x, a_mins[i], a_maxs[i], n_bits)
            elif fxp32_phase1:
                x = fxp.fake_quant(x, fxp.FXP32)
        x = ref_fxp_dense(x, weights[i], biases[i], full_precision=not quant, activation=activations[i])
    y = x.reshape(*orig_shape[:-1], weights[-1].shape[-1])
    return y, torch.stack(mins), torch.stack(maxs)


def ref_mlp_flops(m: int, dims: Sequence[int], full_precision: bool) -> int:
    """MAC-pass FLOP model over the whole network."""
    passes = 2 if full_precision else 1
    return sum(2 * m * dims[i] * dims[i + 1] * passes for i in range(len(dims) - 1))


def _adam_soft(p: Tensor, g: Tensor, m: Tensor, v: Tensor, t: Tensor, hyper: Tensor, fxp_weights: bool):
    """One leaf of the fused step's epilogue: the optimizer's own
    `leaf_update` on the hyper vector's constants, then the target's soft
    update (1 − τ)·t + τ·p from the new parameter."""
    c = adam.StepConstants(
        lr=hyper[H_LR], b1=hyper[H_B1], one_minus_b1=hyper[H_OMB1], b2=hyper[H_B2],
        one_minus_b2=hyper[H_OMB2], eps=hyper[H_EPS], bc1=hyper[H_BC1], bc2=hyper[H_BC2],
    )
    if fxp_weights:
        p2, m2, v2 = fxp_adam.leaf_update(p, g, m, v, c, ste=False)
    else:
        p2, m2, v2 = adam.leaf_update(p, g, m, v, c)
    return p2, m2, v2, hyper[H_OMTAU] * t + hyper[H_TAU] * p2


def _update_trees(p, m, v, t, dws, dbs, hyper, fxp_weights: bool):
    """Adam + soft update over (ws, bs) trees; returns the new p, m, v, t."""
    outs = [[], [], [], []], [[], [], [], []]
    for j, grads in enumerate((dws, dbs)):
        for leaf in zip(p[j], grads, m[j], v[j], t[j]):
            for k, new in enumerate(_adam_soft(*leaf, hyper, fxp_weights)):
                outs[j][k].append(new)
    return tuple((outs[0][k], outs[1][k]) for k in range(4))


def _halves(deltas, zs, n_layers: int, qat: bool):
    """The actor sites' and the critic sites' operands (None when qat off)."""
    if not qat:
        return (None, None), (None, None)
    return (deltas[:n_layers], zs[:n_layers]), (deltas[n_layers:], zs[n_layers:])


def ref_ddpg_critic_step(
    obs, action, reward, done, next_obs, w, actor_t, critic, critic_t, critic_m, critic_v,
    deltas, zs, hyper, quant: bool, *, actor_acts, critic_acts, n_bits: int, qat: bool,
    fxp32_phase1: bool, fxp_weights: bool,
):
    """Plain twin of kernel 4: same arguments as
    `kernel.ddpg_critic_step_cuda` (the phase as a host bool), same return
    value with one block (mins/maxs (1, L), partials (1, 2))."""
    n = len(critic_acts)
    (da, za), (dc, zc) = _halves(deltas, zs, n, qat)
    kw = dict(quant=quant, n_bits=n_bits, qat=qat, fxp32_phase1=fxp32_phase1)
    next_a, _, _ = ref_mlp_forward(next_obs, *actor_t, da, za, activations=actor_acts, **kw)
    q_next, _, _ = ref_mlp_forward(torch.cat([next_obs, next_a], dim=-1), *critic_t, dc, zc,
                                   activations=critic_acts, **kw)
    y = reward + (hyper[H_GAMMA] * (1.0 - done)) * q_next[:, 0]
    xc = torch.cat([obs, action], dim=-1)
    q, mins, maxs, qs, hs = ref_mlp_forward(xc, *critic, dc, zc, activations=critic_acts, save_residuals=True, **kw)
    diff = q[:, 0] - y
    part = torch.stack([torch.sum(w * (diff * diff)), torch.sum(w * y)])
    g = torch.zeros_like(q)
    g[:, 0] = (hyper[H_INVW] * w) * (2.0 * diff)
    _, dws, dbs = ref_mlp_backward(g, xc, critic[0], qs, hs, dc, zc, activations=critic_acts, **kw)
    new = _update_trees(critic, critic_m, critic_v, critic_t, dws, dbs, hyper, fxp_weights)
    return (*new, mins[None], maxs[None], part[None])


def ref_ddpg_actor_step(
    obs, w, actor, actor_m, actor_v, actor_t, critic, deltas, zs, hyper, quant: bool, *,
    actor_acts, critic_acts, n_bits: int, qat: bool, fxp32_phase1: bool, fxp_weights: bool,
):
    """Plain twin of kernel 5: same arguments as
    `kernel.ddpg_actor_step_cuda` (the phase as a host bool), same return
    value with one block (mins/maxs (1, 2L), partials (1, 1))."""
    n = len(actor_acts)
    (da, za), (dc, zc) = _halves(deltas, zs, n, qat)
    kw = dict(quant=quant, n_bits=n_bits, qat=qat, fxp32_phase1=fxp32_phase1)
    a, a_mins, a_maxs, a_qs, a_hs = ref_mlp_forward(obs, *actor, da, za, activations=actor_acts,
                                                    save_residuals=True, **kw)
    xa = torch.cat([obs, a], dim=-1)
    q, c_mins, c_maxs, c_qs, c_hs = ref_mlp_forward(xa, *critic, dc, zc, activations=critic_acts,
                                                    save_residuals=True, **kw)
    part = torch.sum(w * q[:, 0]).reshape(1)
    g = torch.zeros_like(q)
    g[:, 0] = (-hyper[H_INVW]) * w
    # dx only through the critic (its dW/db are dropped); the action columns
    # of the concat carry the policy gradient, masked at the critic's l0 site
    dxa, _, _ = ref_mlp_backward(g, xa, critic[0], c_qs, c_hs, dc, zc, activations=critic_acts, **kw)
    _, dws, dbs = ref_mlp_backward(dxa[:, obs.shape[1]:].contiguous(), obs, actor[0], a_qs, a_hs, da, za,
                                   activations=actor_acts, **kw)
    new = _update_trees(actor, actor_m, actor_v, actor_t, dws, dbs, hyper, fxp_weights)
    mins, maxs = torch.cat([a_mins, c_mins]), torch.cat([a_maxs, c_maxs])
    return (*new, mins[None], maxs[None], part[None])


__all__ = [
    "HYPER_LEN",
    "ref_ddpg_critic_step",
    "ref_ddpg_actor_step",
    "site_project",
    "ste_pass_mask",
    "ref_mlp_forward",
    "ref_mlp_backward",
    "ref_fxp_mlp",
    "ref_mlp_flops",
]
