"""DDPG (Lillicrap et al. '15) with FIXAR fixed-point QAT — port of
`repro.rl.ddpg`.

Actor : state → 400 → 300 → act_dim, ReLU hidden, tanh output   (§VI-B)
Critic: [state; action] → 400 → 300 → 1, ReLU hidden
Both trained with Adam, lr 1e-4 (paper), weights and gradients projected
onto the Q15.16 lattice every step (fixed-point weight and gradient
memories, §III), activations through QAT sites (Algorithm 1).  Parameters
are plain dicts ``{"l0": {"w": (K, N), "b": (N,)}, ...}`` as in the
reference.

Training backends (`DDPGConfig.backend`, the reference's strings, so a
config carries across unchanged):

  * "jnp"    — plain PyTorch: matmuls on fake-quantized values, autograd
    through the STE quantizers (the reference's pure-XLA backend);
  * "pallas" — the hand-written CUDA kernels: kernel B
    (`csrc/fxp_mlp_fwd.cu`) runs the whole actor or critic forward in one
    launch, QAT sites fused, and under autograd saves its residuals;
    kernel 3 (`csrc/fxp_mlp_bwd.cu`) runs the whole backward
    (`kernels.fxp_mlp.ops.fxp_mlp_train`).  For CPU tensors their plain
    versions run instead;
  * "pallas_fused_step" — the whole update in two fused steps: kernel 4
    (critic forwards, TD target, backward, Adam and the target's soft
    update) and kernel 5 (the same for the actor, through the updated
    critic), `csrc/fxp_ddpg_step.cu` via
    `kernels.fxp_mlp.ops.fxp_mlp_train_step`; their plain twins for CPU
    tensors.  Acting is kernel B, as for "pallas";
  * "pallas_layer" — the per-layer chain has no backward: forward only,
    `update` raises, as in the reference.

`act_batch` is the batched greedy policy the serving engine drains
micro-batches through, in three modes: "fused" (kernel B, one launch),
"layer" (kernel A per layer) and "jnp" (plain PyTorch; the name stays
because it is a `stats()` key).

The QAT phase: "jnp" and "pallas" updates read it on the host once per
`update` and hand the bool to each `QATContext`, since it decides which
quantizer and which kernel mode every site and launch uses.
"pallas_fused_step" and acting through kernel B never read it on the host:
the kernels take the device-side flag.  Range updates stay on the device
either way.  So `act` and the fused `update` run without a device sync,
which lets `rl/loop.train_device` capture a whole timestep as a CUDA graph.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.core import fixedpoint as fxp
from repro_torch.core.qat import FrozenQuant, QATContext, QATState, freeze_quant, quantize_grads
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.fxp_matmul.ops import fxp_dense_chain
from repro_torch.kernels.fxp_mlp.ops import fxp_mlp_infer, fxp_mlp_train, fxp_mlp_train_step
from repro_torch.optim import adam, fxp_adam
from repro_torch.rl.envs.base import EnvSpec

Tensor = torch.Tensor
Params = dict[str, Any]

ACTOR_SITES = ["actor/l0", "actor/l1", "actor/l2"]
CRITIC_SITES = ["critic/l0", "critic/l1", "critic/l2"]
ACTOR_ACTS = ("relu", "relu", "tanh")
CRITIC_ACTS = ("relu", "relu", "none")
HIDDEN = (400, 300)  # paper §VI-B
BACKENDS = ("jnp", "pallas", "pallas_fused_step", "pallas_layer")


@dataclasses.dataclass(frozen=True)
class DDPGConfig:
    gamma: float = 0.99
    tau: float = 0.005
    actor_lr: float = 1e-4  # paper: Adam lr 1e-4
    critic_lr: float = 1e-4
    batch_size: int = 128
    qat_delay: int = 0  # optimizer steps before the 16-bit switch
    qat_bits: int = 16
    qat_enabled: bool = True
    fxp_weights: bool = True  # project weights/grads to Q15.16
    backend: str = "jnp"  # one of BACKENDS (module docstring)
    exploration_sigma: float = 0.1


@dataclasses.dataclass
class DDPGState:
    actor: Params
    critic: Params
    actor_target: Params
    critic_target: Params
    actor_opt: adam.AdamState
    critic_opt: adam.AdamState
    qat: QATState
    step: Tensor  # i32 scalar

    def to(self, device) -> "DDPGState":
        """The same state with every tensor on `device`."""
        move = lambda t: t.to(device)  # noqa: E731
        return DDPGState(
            actor=adam.tree_map(move, self.actor),
            critic=adam.tree_map(move, self.critic),
            actor_target=adam.tree_map(move, self.actor_target),
            critic_target=adam.tree_map(move, self.critic_target),
            actor_opt=self.actor_opt.to(device),
            critic_opt=self.critic_opt.to(device),
            qat=self.qat.to(device),
            step=self.step.to(device),
        )


def _init_linear(gen: torch.Generator, fan_in: int, fan_out: int, final: bool = False) -> dict:
    """DDPG init: uniform(±1/sqrt(fan_in)); final layer uniform(±3e-3)."""
    bound = 3e-3 if final else float(fan_in) ** -0.5
    w = torch.empty((fan_in, fan_out), dtype=torch.float32).uniform_(-bound, bound, generator=gen)
    b = torch.empty((fan_out,), dtype=torch.float32).uniform_(-bound, bound, generator=gen)
    return {"w": w, "b": b}


def _init_mlp(gen: torch.Generator, sizes: list[int], fxp_weights: bool, dev: torch.device) -> Params:
    """Random params with the reference's distributions, drawn from `gen`
    (a CPU generator, so the draw does not depend on the device) and
    projected onto Q15.16 when `fxp_weights` (weight memory is Q15.16 from
    step 0)."""
    params = {}
    for i in range(len(sizes) - 1):
        layer = _init_linear(gen, sizes[i], sizes[i + 1], final=i == len(sizes) - 2)
        if fxp_weights:
            layer = {k: fxp.project(v, fxp.FXP32) for k, v in layer.items()}
        params[f"l{i}"] = {k: v.to(dev) for k, v in layer.items()}
    return params


def init_actor(
    obs_dim: int,
    act_dim: int,
    *,
    generator: torch.Generator,
    fxp_weights: bool = True,
    device: DeviceLike = None,
) -> Params:
    """Random actor params (see `_init_mlp`)."""
    return _init_mlp(generator, [obs_dim, *HIDDEN, act_dim], fxp_weights, resolve_device(device))


def init(spec: EnvSpec, cfg: DDPGConfig, *, generator: torch.Generator, device: DeviceLike = None) -> DDPGState:
    """Fresh DDPG state on `device` (the card unless "cpu" is given):
    random actor and critic from `generator`, targets equal to them, Adam
    at step 0, QAT monitors empty."""
    dev = resolve_device(device)
    actor = _init_mlp(generator, [spec.obs_dim, *HIDDEN, spec.act_dim], cfg.fxp_weights, dev)
    critic = _init_mlp(generator, [spec.obs_dim + spec.act_dim, *HIDDEN, 1], cfg.fxp_weights, dev)
    qat = QATState.init(
        delay=cfg.qat_delay, sites=ACTOR_SITES + CRITIC_SITES, n_bits=cfg.qat_bits,
        enabled=cfg.qat_enabled, device=dev,
    )
    return DDPGState(
        actor=actor,
        critic=critic,
        actor_target=adam.tree_map(torch.clone, actor),
        critic_target=adam.tree_map(torch.clone, critic),
        actor_opt=adam.init(actor),
        critic_opt=adam.init(critic),
        qat=qat,
        step=torch.zeros((), dtype=torch.int32, device=dev),
    )


def _params_to_wb(params: Params, n: int) -> tuple[list, list]:
    return [params[f"l{i}"]["w"] for i in range(n)], [params[f"l{i}"]["b"] for i in range(n)]


def _wb_to_params(wb) -> Params:
    ws, bs = wb
    return {f"l{i}": {"w": w, "b": b} for i, (w, b) in enumerate(zip(ws, bs))}


def _dense(x: Tensor, layer: dict, activation: str) -> Tensor:
    y = x @ layer["w"] + layer["b"]
    if activation == "relu":
        y = torch.relu(y)
    elif activation == "tanh":
        y = torch.tanh(y)
    return y


def act_batch(actor: Params, obs: Tensor, frozen: Optional[FrozenQuant] = None, *, mode: str = "fused") -> Tensor:
    """Pure batched greedy policy (see module docstring for the modes).
    Takes only the actor params and a `FrozenQuant` snapshot, so the serve
    path cannot touch live QAT range monitors."""
    ws, bs = _params_to_wb(actor, len(ACTOR_ACTS))
    if mode == "fused":
        if frozen is None:
            y = fxp_mlp_infer(obs, ws, bs, activations=ACTOR_ACTS, quant_phase=False)
        else:
            y = fxp_mlp_infer(
                obs, ws, bs, frozen.deltas, frozen.zs, activations=ACTOR_ACTS,
                quant_phase=frozen.quantized, n_bits=frozen.n_bits,
                fxp32_phase1=frozen.fxp32_phase1,
            )
    elif mode == "layer":
        y = fxp_dense_chain(
            obs, ws, bs, activations=ACTOR_ACTS,
            full_precision=not (frozen is not None and frozen.quantized),
            site_fn=frozen.site if frozen is not None else None,
        )
    elif mode == "jnp":
        x = obs
        for i, act_name in enumerate(ACTOR_ACTS):
            if frozen is not None:
                x = frozen.site(i, x)
            x = _dense(x, {"w": ws[i], "b": bs[i]}, act_name)
        y = x
    else:
        raise ValueError(f"unknown serve mode {mode!r}; expected 'fused' | 'layer' | 'jnp'")
    return torch.clamp(y, -1.0, 1.0)


def actor_site_telemetry(
    actor: Params, obs: Tensor, frozen: Optional[FrozenQuant] = None, mask: Optional[Tensor] = None
) -> tuple[Tensor, Tensor, Tensor]:
    """Per-site activation extrema + quantizer saturation rates (obs hook).

    Runs the plain forward and captures, at each QAT site, the
    pre-quantization input extrema and the fraction of elements at or beyond
    the site's clip boundaries [a_min, a_max] (0 outside the quantized
    phase).  `mask` is an optional (B,) row-validity vector: masked-out rows
    are excluded from extrema and saturation.

    Returns (mins, maxs, saturations), each (n_sites,) f32.
    """
    valid = None if mask is None else (mask > 0)[:, None]
    inf = torch.full((), float("inf"), dtype=torch.float32, device=obs.device)
    x = obs
    mns, mxs, sats = [], [], []
    for i, act_name in enumerate(ACTOR_ACTS):
        x_lo = x if valid is None else torch.where(valid, x, inf)
        x_hi = x if valid is None else torch.where(valid, x, -inf)
        mns.append(x_lo.min())
        mxs.append(x_hi.max())
        if frozen is not None and frozen.quantized:
            out = ((x <= frozen.a_mins[i]) | (x >= frozen.a_maxs[i])).to(torch.float32)
            if valid is None:
                sats.append(out.mean())
            else:
                w = valid.to(torch.float32)
                sats.append((out * w).sum() / torch.clamp((w.sum() * x.shape[-1]), min=1.0))
        else:
            sats.append(torch.zeros((), dtype=torch.float32, device=obs.device))
        if frozen is not None:
            x = frozen.site(i, x)
        x = _dense(x, actor[f"l{i}"], act_name)
    return torch.stack(mns), torch.stack(mxs), torch.stack(sats)


def _fused_mlp(params: Params, x: Tensor, ctx: Optional[QATContext], *, sites: list[str],
               activations: tuple[str, ...]) -> Tensor:
    """Whole-network forward through kernel B (`fxp_mlp_train`: kernel 3
    is its backward when autograd needs one).  Range observations flow
    back into `ctx` via `observe`, so QAT state evolves as on the
    per-layer path."""
    ws, bs = _params_to_wb(params, len(activations))
    if ctx is None or not ctx.state.config.enabled:
        y, _, _ = fxp_mlp_train(x, ws, bs, activations=activations, quant_phase=False, qat=False)
        return y
    cfg = ctx.state.config
    deltas, zs = ctx.site_quant_params(sites)
    y, mns, mxs = fxp_mlp_train(
        x, ws, bs, deltas, zs, activations=activations, quant_phase=ctx.quant_operand, n_bits=cfg.n_bits,
        fxp32_phase1=cfg.fxp32_phase1,
    )
    for j, site in enumerate(sites):
        ctx.observe(site, mns[j], mxs[j])
    return y


def _mlp_forward(params: Params, x: Tensor, ctx: Optional[QATContext], *, sites: list[str],
                 activations: tuple[str, ...], backend: str) -> Tensor:
    if backend in ("pallas", "pallas_fused_step"):
        # the fused-step backend only changes how update() runs; any plain
        # forward (acting, evaluation) is kernel B either way
        return _fused_mlp(params, x, ctx, sites=sites, activations=activations)
    if backend == "pallas_layer":
        # half-precision dense is tied to activation quantization: with QAT
        # off there is no quantized phase
        quant = ctx is not None and ctx.state.config.enabled and ctx.quant
        n = len(activations)
        return fxp_dense_chain(
            x, [params[f"l{i}"]["w"] for i in range(n)], [params[f"l{i}"]["b"] for i in range(n)],
            activations=activations, full_precision=not quant,
            site_fn=None if ctx is None else (lambda i, v: ctx.site(sites[i], v)),
        )
    if backend != "jnp":
        raise ValueError(f"unknown backend {backend!r}; expected one of {BACKENDS}")
    for i, act in enumerate(activations):
        if ctx is not None:
            x = ctx.site(sites[i], x)
        x = _dense(x, params[f"l{i}"], act)
    return x


def actor_forward(params: Params, obs: Tensor, ctx: Optional[QATContext], *, backend: str = "jnp") -> Tensor:
    return _mlp_forward(params, obs, ctx, sites=ACTOR_SITES, activations=ACTOR_ACTS, backend=backend)


def critic_forward(params: Params, obs: Tensor, action: Tensor, ctx: Optional[QATContext], *,
                   backend: str = "jnp") -> Tensor:
    x = torch.cat([obs, action], dim=-1)
    x = _mlp_forward(params, x, ctx, sites=CRITIC_SITES, activations=CRITIC_ACTS, backend=backend)
    return x.squeeze(-1)


def act(state: DDPGState, obs: Tensor, *, cfg: DDPGConfig, generator: Optional[torch.Generator] = None,
        noise: Optional[Tensor] = None) -> Tensor:
    """Actor inference plus the exploration-noise unit of Fig. 2.

    `generator` draws Gaussian noise at `cfg.exploration_sigma`; `noise`
    adds a caller-supplied perturbation (the hook `rl/loop` uses for
    `rl/noise.NoiseProcess` samples).  Either way it lands before the clip
    to [-1, 1].  Runs without autograd."""
    with torch.no_grad():
        ctx = QATContext(state.qat) if state.qat.config.enabled else None
        a = actor_forward(state.actor, obs, ctx, backend=cfg.backend)
        if generator is not None:
            a = a + cfg.exploration_sigma * torch.randn(a.shape, generator=generator, device=a.device)
        elif noise is not None:
            a = a + noise
        return torch.clamp(a, -1.0, 1.0)


def freeze_actor_quant(state: DDPGState) -> Optional[FrozenQuant]:
    """Snapshot the actor's site quant params for serving (None if QAT off)."""
    return freeze_quant(state.qat, ACTOR_SITES)


def _wmean(x: Tensor, w: Optional[Tensor]) -> Tensor:
    """Mean over valid rows: the plain mean when `w` is None, else
    sum(w·x)/sum(w); rows with w = 0 add exactly zero to the loss and its
    gradients."""
    if w is None:
        return x.mean()
    w = w.to(torch.float32)
    return torch.sum(x * w) / torch.clamp(torch.sum(w), min=1.0)


def _trainable(params: Params) -> tuple[Params, list[Tensor]]:
    """A copy of `params` whose leaves require grad, and the leaves."""
    leaves = {k: {n: t.detach().requires_grad_(True) for n, t in layer.items()} for k, layer in params.items()}
    return leaves, [leaves[k][n] for k in leaves for n in leaves[k]]


def _grads_tree(params: Params, grads: list[Tensor]) -> Params:
    it = iter(grads)
    return {k: {n: next(it) for n in layer} for k, layer in params.items()}


def _update_fused_step(state: DDPGState, batch: dict[str, Tensor], cfg: DDPGConfig
                       ) -> tuple[DDPGState, dict[str, Tensor]]:
    """The whole update through `fxp_mlp_train_step` (kernels 4 and 5):
    critic fwd+bwd+Adam+soft update, then the actor's through the updated
    critic.  Losses, QAT range evolution and the optimizer trajectory track
    backend "pallas" (the reference's `_update_fused_step`).  Nothing here
    reads the device on the host."""
    obs, action = batch["obs"], batch["action"]
    reward, next_obs = batch["reward"], batch["next_obs"]
    done = batch["done"].to(torch.float32)
    mask = batch.get("mask")
    w = torch.ones((obs.shape[0],), dtype=torch.float32, device=obs.device) if mask is None else mask.to(torch.float32)

    qat_on = state.qat.config.enabled
    deltas = zs = None
    if qat_on:
        deltas, zs = QATContext(state.qat).site_quant_params(ACTOR_SITES + CRITIC_SITES)
    opt_c = fxp_adam.FxpAdamConfig(lr=cfg.critic_lr) if cfg.fxp_weights else adam.AdamConfig(lr=cfg.critic_lr)
    opt_a = fxp_adam.FxpAdamConfig(lr=cfg.actor_lr) if cfg.fxp_weights else adam.AdamConfig(lr=cfg.actor_lr)
    consts_c = adam.step_constants(opt_c, state.critic_opt.step + 1)
    consts_a = adam.step_constants(opt_a, state.actor_opt.step + 1)

    n = len(ACTOR_ACTS)
    wb = lambda p: _params_to_wb(p, n)  # noqa: E731
    with torch.no_grad():
        # the phase goes in even with QAT off, as the reference's does: past
        # the delay the fused step runs the hi-limb datapath either way
        out = fxp_mlp_train_step(
            obs, action, reward, done, next_obs, w,
            wb(state.actor), wb(state.critic), wb(state.actor_target), wb(state.critic_target),
            wb(state.actor_opt.mu), wb(state.actor_opt.nu), wb(state.critic_opt.mu), wb(state.critic_opt.nu),
            deltas, zs, consts_c, consts_a, state.qat.quantized_phase,
            actor_acts=ACTOR_ACTS, critic_acts=CRITIC_ACTS, obs_dim=int(obs.shape[-1]),
            act_dim=int(action.shape[-1]), gamma=cfg.gamma, tau=cfg.tau, n_bits=state.qat.config.n_bits,
            qat=qat_on, fxp32_phase1=state.qat.config.fxp32_phase1, fxp_weights=cfg.fxp_weights,
        )
        # range evolution mirrors update()'s two contexts: the critic-loss
        # pass observes the critic sites, the actor pass the actor sites and
        # the critic sites again on top
        if qat_on:
            ctx1 = QATContext(state.qat)
            for j, site in enumerate(CRITIC_SITES):
                ctx1.observe(site, out.c_mins[j], out.c_maxs[j])
            ctx2 = QATContext(ctx1.finalize())
            for j, site in enumerate(ACTOR_SITES + CRITIC_SITES):
                ctx2.observe(site, out.a_mins[j], out.a_maxs[j])
            qat_final = ctx2.finalize().tick()
        else:
            qat_final = state.qat.tick()

        sum_w = torch.clamp(torch.sum(w), min=1.0)
        new_state = DDPGState(
            actor=_wb_to_params(out.actor),
            critic=_wb_to_params(out.critic),
            actor_target=_wb_to_params(out.actor_t),
            critic_target=_wb_to_params(out.critic_t),
            actor_opt=adam.AdamState(step=state.actor_opt.step + 1, mu=_wb_to_params(out.actor_m),
                                     nu=_wb_to_params(out.actor_v)),
            critic_opt=adam.AdamState(step=state.critic_opt.step + 1, mu=_wb_to_params(out.critic_m),
                                      nu=_wb_to_params(out.critic_v)),
            qat=qat_final,
            step=state.step + 1,
        )
        metrics = {"critic_loss": out.closs_sum / sum_w, "actor_loss": -(out.q_sum / sum_w),
                   "q_mean": out.y_sum / sum_w}
    return new_state, metrics


def update(state: DDPGState, batch: dict[str, Tensor], cfg: DDPGConfig) -> tuple[DDPGState, dict[str, Tensor]]:
    """One FIXAR timestep's training work: critic BP/WU, then actor BP/WU
    through the *updated* critic (the operation sequence of Fig. 3), then
    the targets' soft update and one QAT tick.

    `batch` holds (B, ·) tensors `obs`, `action`, `reward`, `next_obs`,
    `done`, and optionally `mask`, (B,) row weights: rows with weight 0 add
    exactly zero gradient.  Trains with backend "jnp", "pallas" or
    "pallas_fused_step" (module docstring); "pallas_layer" raises."""
    if cfg.backend == "pallas_fused_step":
        return _update_fused_step(state, batch, cfg)
    if cfg.backend not in ("jnp", "pallas"):
        raise ValueError(
            f"backend={cfg.backend!r} is forward/inference-only (the per-layer kernel chain has no "
            "backward); train with backend='jnp', backend='pallas', or backend='pallas_fused_step'"
        )
    obs, action = batch["obs"], batch["action"]
    reward, next_obs = batch["reward"], batch["next_obs"]
    done = batch["done"].to(torch.float32)
    mask = batch.get("mask")
    # the one host read of the phase in this update (module docstring)
    quant = bool(state.qat.quantized_phase) if state.qat.config.enabled else False
    opt_c = fxp_adam.FxpAdamConfig(lr=cfg.critic_lr) if cfg.fxp_weights else adam.AdamConfig(lr=cfg.critic_lr)
    opt_a = fxp_adam.FxpAdamConfig(lr=cfg.actor_lr) if cfg.fxp_weights else adam.AdamConfig(lr=cfg.actor_lr)
    upd_fn = fxp_adam.update if cfg.fxp_weights else adam.update

    # ---- targets (inference on the target nets, no range updates) ---------
    with torch.no_grad():
        tctx = QATContext(state.qat, quant)
        next_a = actor_forward(state.actor_target, next_obs, tctx, backend=cfg.backend)
        q_next = critic_forward(state.critic_target, next_obs, next_a, tctx, backend=cfg.backend)
        y = reward + cfg.gamma * (1.0 - done) * q_next

    # ---- critic BP + WU ----------------------------------------------------
    cp, c_leaves = _trainable(state.critic)
    ctx = QATContext(state.qat, quant)
    q = critic_forward(cp, obs, action, ctx, backend=cfg.backend)
    closs = _wmean(torch.square(q - y), mask)
    cgrads = _grads_tree(cp, torch.autograd.grad(closs, c_leaves))
    qat1 = ctx.finalize()
    if cfg.fxp_weights:
        cgrads = quantize_grads(cgrads)  # gradient memory is fxp32
    critic, critic_opt, _ = upd_fn(opt_c, cgrads, state.critic_opt, state.critic)

    # ---- actor BP + WU (through the *updated* critic, Fig. 3) -------------
    ap, a_leaves = _trainable(state.actor)
    ctx = QATContext(qat1, quant)
    a = actor_forward(ap, obs, ctx, backend=cfg.backend)
    qa = critic_forward(critic, obs, a, ctx, backend=cfg.backend)
    aloss = -_wmean(qa, mask)
    agrads = _grads_tree(ap, torch.autograd.grad(aloss, a_leaves))
    qat2 = ctx.finalize()
    if cfg.fxp_weights:
        agrads = quantize_grads(agrads)
    actor, actor_opt, _ = upd_fn(opt_a, agrads, state.actor_opt, state.actor)

    # ---- soft target update ------------------------------------------------
    with torch.no_grad():
        soft = lambda t, o: adam.tree_map(lambda x, z: (1 - cfg.tau) * x + cfg.tau * z, t, o)  # noqa: E731
        new_state = DDPGState(
            actor=actor,
            critic=critic,
            actor_target=soft(state.actor_target, actor),
            critic_target=soft(state.critic_target, critic),
            actor_opt=actor_opt,
            critic_opt=critic_opt,
            qat=qat2.tick(),
            step=state.step + 1,
        )
        metrics = {"critic_loss": closs.detach(), "actor_loss": aloss.detach(), "q_mean": _wmean(y, mask)}
    return new_state, metrics


__all__ = [
    "ACTOR_SITES",
    "CRITIC_SITES",
    "ACTOR_ACTS",
    "CRITIC_ACTS",
    "HIDDEN",
    "BACKENDS",
    "DDPGConfig",
    "DDPGState",
    "init",
    "init_actor",
    "actor_forward",
    "critic_forward",
    "act",
    "act_batch",
    "actor_site_telemetry",
    "freeze_actor_quant",
    "update",
]
