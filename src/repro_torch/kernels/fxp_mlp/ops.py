"""Public wrappers for the fused MLP kernels (port of
`repro.kernels.fxp_mlp.ops`).

`fxp_mlp_forward` runs the whole L-layer forward, QAT sites included, and
returns (y, site_mins, site_maxs) like the reference.  CPU tensors take the
plain version (`ref.ref_mlp_forward`); CUDA tensors take kernel B
(`kernel.fxp_mlp_fwd_cuda`, one launch), whose per-block monitor rows are
reduced here, as the reference wrapper reduces its (n_blocks, L) outputs.
No padding: the kernel masks ragged rows and columns itself, so padded
values never reach the range monitors.

`fxp_mlp_train` is the differentiable face of the same kernel, a
`torch.autograd.Function`: when an input needs a gradient, its forward runs
kernel B with the residuals saved (one launch) and its backward is kernel 3
(`kernel.fxp_mlp_bwd_cuda`), the whole dx/dW/db chain with the QAT sites'
straight-through masks; otherwise it is the plain fused forward.  For CPU
tensors both halves are the plain versions (`ref.ref_mlp_forward`,
`ref.ref_mlp_backward`), never autograd through the plain forward, whose
`round`/`clamp` carry no straight-through gradient.

`fxp_mlp_train_step` is one whole DDPG update — critic BP/WU, then actor
BP/WU through the updated critic — in two fused steps: kernel 4
(`kernel.ddpg_critic_step_cuda`) and kernel 5 (`kernel.ddpg_actor_step_cuda`)
for CUDA tensors, their plain twins (`ref.ref_ddpg_critic_step`,
`ref.ref_ddpg_actor_step`) for CPU tensors.  Its step scalars and the QAT
phase stay on the device, so a CUDA graph can capture it.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from repro_torch.device import check_same_device
from repro_torch.kernels._compat import mlp_flops
from repro_torch.kernels.fxp_mlp.kernel import (
    ddpg_actor_step_cuda,
    ddpg_critic_step_cuda,
    fxp_mlp_bwd_cuda,
    fxp_mlp_fwd_cuda,
)
from repro_torch.kernels.fxp_mlp.ref import (
    ref_ddpg_actor_step,
    ref_ddpg_critic_step,
    ref_mlp_backward,
    ref_mlp_forward,
)

Tensor = torch.Tensor


def _norm_quant_params(deltas, zs, n_layers: int, qat: bool, device):
    """(L,) float32 deltas/zs on `device`; (None, None) when qat is off,
    since neither version reads them then."""
    if not qat:
        return None, None
    if deltas is None or zs is None:
        raise ValueError(
            "qat=True requires both deltas and zs (the per-site affine "
            "operands of a FrozenQuant); pass qat=False for the site-free pipeline"
        )
    return (
        torch.as_tensor(deltas, dtype=torch.float32, device=device).reshape(n_layers),
        torch.as_tensor(zs, dtype=torch.float32, device=device).reshape(n_layers),
    )


def _operands(x, weights, biases, deltas, zs, activations, qat: bool):
    """Both faces' argument checks: x flattened to (M, K0), everything
    float32 on one device, and contiguous on the card (what the kernels
    take).  Returns (x2, ws, bs, deltas, zs)."""
    n_layers = len(weights)
    if not n_layers == len(biases) == len(activations):
        raise ValueError(f"{n_layers} weights vs {len(biases)} biases vs {len(activations)} activations")
    if weights[0].shape[0] != x.shape[-1]:
        raise ValueError(f"layer-0 input dim {weights[0].shape[0]} != x feature dim {x.shape[-1]}")
    x2 = x.reshape(-1, x.shape[-1]).to(torch.float32)
    ws = [w.to(torch.float32) for w in weights]
    bs = [b.to(torch.float32) for b in biases]
    dev = check_same_device(x2, *ws, *bs)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"the fused MLP runs on 'cpu' or 'cuda' tensors, got {dev}")
    deltas, zs = _norm_quant_params(deltas, zs, n_layers, qat, dev)
    if dev.type == "cuda":
        x2, ws, bs = x2.contiguous(), [w.contiguous() for w in ws], [b.contiguous() for b in bs]
        deltas = None if deltas is None else deltas.contiguous()
        zs = None if zs is None else zs.contiguous()
    return x2, ws, bs, deltas, zs


def fxp_mlp_forward(
    x: Tensor,
    weights: Sequence[Tensor],
    biases: Sequence[Tensor],
    deltas: Optional[Tensor] = None,
    zs: Optional[Tensor] = None,
    *,
    activations: Sequence[str],
    quant_phase,
    n_bits: int = 16,
    qat: bool = True,
    fxp32_phase1: bool = True,
) -> tuple[Tensor, Tensor, Tensor]:
    """Fused L-layer MLP forward with inline QAT sites.

    x: (..., K0) f32.  weights[i]: (K_i, N_i), biases[i]: (N_i,).
    activations[i] in {"relu", "tanh", "none"}.  quant_phase: the
    Algorithm-1 phase flag (False = monitor/full precision, True =
    quantized/half precision), a bool or a 0-d tensor (read on the host).
    deltas/zs: (L,) per-site affine operands; ignored when qat=False.
    A phase tensor on the card stays there: kernel B reads it in-kernel,
    so the call needs no host read (and a CUDA graph can capture it).

    Returns (y, site_mins, site_maxs): y is (..., N_L); site_mins/maxs are
    the (L,) exact extrema of each layer's pre-quantization input.
    """
    x2, ws, bs, deltas, zs = _operands(x, weights, biases, deltas, zs, activations, qat)
    on_card = x2.device.type == "cuda"
    dev_phase = on_card and isinstance(quant_phase, torch.Tensor) and quant_phase.device == x2.device
    quant = False if dev_phase else bool(quant_phase)
    kw = dict(activations=activations, quant=quant, n_bits=n_bits, qat=qat, fxp32_phase1=fxp32_phase1)
    if not on_card:
        y, mins, maxs = ref_mlp_forward(x2, ws, bs, deltas, zs, **kw)
    else:
        phase = quant_phase.reshape(1).to(torch.int32) if dev_phase else None
        y, block_mins, block_maxs = fxp_mlp_fwd_cuda(x2, ws, bs, deltas, zs, phase=phase, **kw)
        mins, maxs = block_mins.amin(dim=0), block_maxs.amax(dim=0)
    return y.reshape(*x.shape[:-1], ws[-1].shape[-1]), mins, maxs


class _MlpTrain(torch.autograd.Function):
    """Kernel B with residuals forward, kernel 3 backward (plain versions
    for CPU tensors).  Inputs: (spec, x (M, K0), deltas, zs, *weights,
    *biases); spec = (activations, quant, n_bits, qat, fxp32_phase1)."""

    @staticmethod
    def forward(ctx, spec, x, deltas, zs, *wb):
        activations, quant, n_bits, qat, fxp32_phase1 = spec
        n = len(activations)
        ws, bs = list(wb[:n]), list(wb[n:])
        kw = dict(activations=activations, quant=quant, n_bits=n_bits, qat=qat, fxp32_phase1=fxp32_phase1)
        if x.device.type == "cpu":
            y, mins, maxs, qs, hs = ref_mlp_forward(x, ws, bs, deltas, zs, save_residuals=True, **kw)
        else:
            y, bmins, bmaxs, qs, hs = fxp_mlp_fwd_cuda(x, ws, bs, deltas, zs, save_residuals=True, **kw)
            mins, maxs = bmins.amin(dim=0), bmaxs.amax(dim=0)
        ctx.spec = spec
        ctx.n_qs = len(qs)
        ctx.save_for_backward(x, deltas, zs, *ws, *qs, *hs)
        ctx.mark_non_differentiable(mins, maxs)
        return y, mins, maxs

    @staticmethod
    def backward(ctx, gy, _gmins, _gmaxs):
        activations, quant, n_bits, qat, fxp32_phase1 = ctx.spec
        n = len(activations)
        x, deltas, zs, *rest = ctx.saved_tensors
        ws, qs, hs = rest[:n], rest[n : 2 * n], rest[2 * n :]
        kw = dict(activations=activations, quant=quant, n_bits=n_bits, qat=qat, fxp32_phase1=fxp32_phase1)
        gy = gy.to(torch.float32).contiguous()
        if x.device.type == "cpu":
            dx, dws, dbs = ref_mlp_backward(gy, x, ws, qs, hs, deltas, zs, **kw)
        else:
            dx, dws, dbs = fxp_mlp_bwd_cuda(gy, x, ws, qs, hs, deltas, zs, **kw)
        return (None, dx, None, None, *dws, *dbs)


def fxp_mlp_train(
    x: Tensor,
    weights: Sequence[Tensor],
    biases: Sequence[Tensor],
    deltas: Optional[Tensor] = None,
    zs: Optional[Tensor] = None,
    *,
    activations: Sequence[str],
    quant_phase,
    n_bits: int = 16,
    qat: bool = True,
    fxp32_phase1: bool = True,
) -> tuple[Tensor, Tensor, Tensor]:
    """Differentiable fused forward: `fxp_mlp_forward` with kernel 3 as its
    backward.  Same arguments and return value as `fxp_mlp_forward`.

    Gradients flow to x, weights and biases.  `quant_phase` (read once on
    the host), `deltas` and `zs` get none, and the returned site mins/maxs
    are detached: they are range-monitor observations, not a
    differentiable head."""
    needs_grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, *weights, *biases)
    )
    if not needs_grad:
        y, mins, maxs = fxp_mlp_forward(
            x, weights, biases, deltas, zs, activations=activations, quant_phase=quant_phase,
            n_bits=n_bits, qat=qat, fxp32_phase1=fxp32_phase1,
        )
        return y, mins.detach(), maxs.detach()
    x2, ws, bs, deltas, zs = _operands(x, weights, biases, deltas, zs, activations, qat)
    spec = (tuple(activations), bool(quant_phase), int(n_bits), bool(qat), bool(fxp32_phase1))
    y, mins, maxs = _MlpTrain.apply(spec, x2, deltas, zs, *ws, *bs)
    return y.reshape(*x.shape[:-1], ws[-1].shape[-1]), mins, maxs


def fxp_mlp_infer(
    x: Tensor,
    weights: Sequence[Tensor],
    biases: Sequence[Tensor],
    deltas: Optional[Tensor] = None,
    zs: Optional[Tensor] = None,
    *,
    activations: Sequence[str],
    quant_phase,
    n_bits: int = 16,
    fxp32_phase1: bool = True,
) -> Tensor:
    """Serving entry point: the fused forward with the range monitors
    dropped, so nothing downstream can fold them into a live QAT state.
    Pass deltas/zs=None for the QAT-free pipeline."""
    qat = deltas is not None and zs is not None
    y, _, _ = fxp_mlp_forward(
        x, weights, biases, deltas, zs, activations=activations, quant_phase=quant_phase,
        n_bits=n_bits, qat=qat, fxp32_phase1=fxp32_phase1,
    )
    return y.detach()


class TrainStepOut(NamedTuple):
    """What `fxp_mlp_train_step` returns (the reference's fields): trees as
    (ws, bs), the loss sums, and the site extrema of both passes."""

    actor: tuple
    critic: tuple
    actor_t: tuple
    critic_t: tuple
    actor_m: tuple
    actor_v: tuple
    critic_m: tuple
    critic_v: tuple
    closs_sum: Tensor  # Σ w·(q − y)²
    y_sum: Tensor  # Σ w·y
    q_sum: Tensor  # Σ w·q(obs, actor(obs))
    c_mins: Tensor  # (L,) critic sites, critic-loss pass
    c_maxs: Tensor
    a_mins: Tensor  # (2L,) actor sites then critic sites, actor pass
    a_maxs: Tensor


def _hyper(inv_w: Tensor, gamma: float, tau: float, c) -> Tensor:
    """The (12,) step scalars on inv_w's device (`ref.HYPER_LEN` layout):
    (1 − τ) folded in Python double, then float32, as the host soft update
    folds it."""
    full = lambda v: torch.full((), v, dtype=torch.float32, device=inv_w.device)  # noqa: E731
    return torch.stack([inv_w, full(gamma), full(tau), full(1 - tau), c.lr, c.b1, c.one_minus_b1, c.b2,
                        c.one_minus_b2, c.eps, c.bc1, c.bc2]).to(torch.float32)


def fxp_mlp_train_step(
    obs: Tensor,
    action: Tensor,
    reward: Tensor,
    done: Tensor,
    next_obs: Tensor,
    w: Tensor,
    actor_wb,
    critic_wb,
    actor_t_wb,
    critic_t_wb,
    actor_m,
    actor_v,
    critic_m,
    critic_v,
    deltas: Optional[Tensor],
    zs: Optional[Tensor],
    consts_c,
    consts_a,
    quant_phase,
    *,
    actor_acts: Sequence[str],
    critic_acts: Sequence[str],
    obs_dim: int,
    act_dim: int,
    gamma: float,
    tau: float,
    n_bits: int = 16,
    qat: bool = True,
    fxp32_phase1: bool = True,
    fxp_weights: bool = True,
) -> TrainStepOut:
    """One whole DDPG update in two fused steps (module docstring).

    obs/next_obs (B, obs_dim), action (B, act_dim); reward, done, w (B,),
    w the row weights (ones when the batch has no mask).  Every tree is
    (ws, bs) of unpadded leaves: the nets, their targets, and their Adam
    moments.  deltas/zs: (2L,) site operands (actor sites, then critic
    sites), None when qat is off.  consts_c / consts_a: `adam.StepConstants`
    of the post-increment critic / actor step.  quant_phase: the QAT phase,
    a bool or a 0-d tensor (on the card it is read in-kernel).
    """
    dev = check_same_device(obs, action, reward, done, next_obs, w)
    f32 = lambda t: t.to(torch.float32).contiguous()  # noqa: E731
    tree = lambda t: ([f32(x) for x in t[0]], [f32(x) for x in t[1]])  # noqa: E731
    obs, action, reward, done, next_obs, w = (f32(t) for t in (obs, action, reward, done, next_obs, w))
    reward, done, w = reward.reshape(-1), done.reshape(-1), w.reshape(-1)
    if obs.shape[-1] != obs_dim or action.shape[-1] != act_dim:
        raise ValueError(f"obs {tuple(obs.shape)}, action {tuple(action.shape)} for dims {obs_dim}/{act_dim}")
    n = len(actor_acts)
    deltas, zs = _norm_quant_params(deltas, zs, 2 * n, qat, dev)
    inv_w = 1.0 / torch.clamp(torch.sum(w), min=1.0)
    hyper_c, hyper_a = _hyper(inv_w, gamma, tau, consts_c), _hyper(inv_w, gamma, tau, consts_a)
    kw = dict(actor_acts=tuple(actor_acts), critic_acts=tuple(critic_acts), n_bits=n_bits, qat=qat,
              fxp32_phase1=fxp32_phase1, fxp_weights=fxp_weights)
    actor, critic, actor_t, critic_t = (tree(t) for t in (actor_wb, critic_wb, actor_t_wb, critic_t_wb))
    am, av, cm, cv = (tree(t) for t in (actor_m, actor_v, critic_m, critic_v))
    if dev.type == "cpu":
        quant = bool(quant_phase)
        c_out = ref_ddpg_critic_step(obs, action, reward, done, next_obs, w, actor_t, critic, critic_t, cm, cv,
                                     deltas, zs, hyper_c, quant, **kw)
        a_out = ref_ddpg_actor_step(obs, w, actor, am, av, actor_t, c_out[0], deltas, zs, hyper_a, quant, **kw)
    else:
        phase = torch.as_tensor(quant_phase, device=dev).reshape(1).to(torch.int32)
        c_out = ddpg_critic_step_cuda(obs, action, reward, done, next_obs, w, actor_t, critic, critic_t, cm, cv,
                                      deltas, zs, hyper_c, phase, **kw)
        a_out = ddpg_actor_step_cuda(obs, w, actor, am, av, actor_t, c_out[0], deltas, zs, hyper_a, phase, **kw)
    new_c, new_cm, new_cv, new_ct, mins1, maxs1, part1 = c_out
    new_a, new_am, new_av, new_at, mins2, maxs2, part2 = a_out
    return TrainStepOut(
        actor=new_a, critic=new_c, actor_t=new_at, critic_t=new_ct,
        actor_m=new_am, actor_v=new_av, critic_m=new_cm, critic_v=new_cv,
        closs_sum=part1[:, 0].sum(), y_sum=part1[:, 1].sum(), q_sum=part2[:, 0].sum(),
        c_mins=mins1.amin(dim=0), c_maxs=maxs1.amax(dim=0), a_mins=mins2.amin(dim=0), a_maxs=maxs2.amax(dim=0),
    )


def fused_cost_hint(dims: Sequence[int], phase: str = "act") -> dict:
    """Dispatcher hook: launch/FLOP shape of the fused path — the whole
    network in ONE launch, batch as the only grid axis.  phase="train" is a
    forward+backward step: 2 launches and ~3x the MACs."""
    if phase == "train":
        return {"launches": 2, "flops_per_item": 3 * mlp_flops(dims), "parallelism": "intra_batch"}
    if phase != "act":
        raise ValueError(f"unknown cost phase {phase!r}; 'act' | 'train'")
    return {"launches": 1, "flops_per_item": mlp_flops(dims), "parallelism": "intra_batch"}


__all__ = ["fxp_mlp_forward", "fxp_mlp_train", "fxp_mlp_infer", "fxp_mlp_train_step", "TrainStepOut",
           "fused_cost_hint"]
