"""DDPG actor serving — the serving subset of `repro.rl.ddpg`.

Actor: state → 400 → 300 → act_dim, ReLU hidden, tanh output (paper §VI-B),
weights on the Q15.16 lattice.  Parameters are a plain dict
``{"l0": {"w": (K, N), "b": (N,)}, ...}`` as in the reference.

`act_batch` is the batched greedy policy the serving engine drains
micro-batches through, in three modes:

  * "fused" — kernel B, the whole network in ONE launch (intra-batch);
  * "layer" — kernel A per layer, one launch per layer (intra-layer);
  * "jnp"   — plain PyTorch matmuls (the reference's pure-XLA mode; the
    name stays because it is a `stats()` key).

`DDPGState`, `update` and the training backends belong to the training
slice.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.core import fixedpoint as fxp
from repro_torch.core.qat import FrozenQuant
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.fxp_matmul.ops import fxp_dense_chain
from repro_torch.kernels.fxp_mlp.ops import fxp_mlp_infer

Tensor = torch.Tensor
Params = dict[str, Any]

ACTOR_SITES = ["actor/l0", "actor/l1", "actor/l2"]
ACTOR_ACTS = ("relu", "relu", "tanh")
HIDDEN = (400, 300)  # paper §VI-B


def _init_linear(gen: torch.Generator, fan_in: int, fan_out: int, final: bool = False) -> dict:
    """DDPG init: uniform(±1/sqrt(fan_in)); final layer uniform(±3e-3)."""
    bound = 3e-3 if final else float(fan_in) ** -0.5
    w = torch.empty((fan_in, fan_out), dtype=torch.float32).uniform_(-bound, bound, generator=gen)
    b = torch.empty((fan_out,), dtype=torch.float32).uniform_(-bound, bound, generator=gen)
    return {"w": w, "b": b}


def init_actor(
    obs_dim: int,
    act_dim: int,
    *,
    generator: torch.Generator,
    fxp_weights: bool = True,
    device: DeviceLike = None,
) -> Params:
    """Random actor params with the reference's distributions, drawn from
    `generator` (a CPU generator, so the draw does not depend on the
    device) and projected onto Q15.16 when `fxp_weights`."""
    dev = resolve_device(device)
    sizes = [obs_dim, *HIDDEN, act_dim]
    params = {}
    for i in range(len(sizes) - 1):
        layer = _init_linear(generator, sizes[i], sizes[i + 1], final=i == len(sizes) - 2)
        if fxp_weights:
            layer = {k: fxp.project(v, fxp.FXP32) for k, v in layer.items()}
        params[f"l{i}"] = {k: v.to(dev) for k, v in layer.items()}
    return params


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
    n = len(ACTOR_ACTS)
    ws = [actor[f"l{i}"]["w"] for i in range(n)]
    bs = [actor[f"l{i}"]["b"] for i in range(n)]
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
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=obs.device)
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


__all__ = ["ACTOR_SITES", "ACTOR_ACTS", "HIDDEN", "init_actor", "act_batch", "actor_site_telemetry"]
