"""RecurrentGemma / Griffin recurrent block (arXiv:2402.19427), port of
`repro.models.rglru`.

Block: x -> [gate branch: gelu(x@Wg)] ⊙ [rnn branch: conv1d(x@Wx) -> RG-LRU]
        -> @Wo

RG-LRU (real-gated linear recurrent unit), diagonal per-channel:
    r_t = σ(x_t @ Wa + ba)            recurrence gate
    i_t = σ(x_t @ Wi + bi)            input gate
    a_t = exp(-c · softplus(Λ) ⊙ r_t)           (c = 8)
    h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t²) ⊙ (i_t ⊙ x_t)

The diagonal recurrence runs over the sequence as a log-depth doubling
scan (⌈log₂ S⌉ rounds of the pair op on shifted views: the reference's
`lax.associative_scan` in another association order, so float32 agrees to
rounding, not bitwise), seeded with the carried h.  Decode is the O(1)
step.  Conv1d is the Griffin width-4 causal temporal conv.

Numerics kept from the reference: the gates run in float32 (`wa`, `ba`,
`wi`, `bi`, `lam` are never cast; `wx`, `wg`, `wo`, `conv_w`, `conv_b`
take the compute dtype); softplus is `logaddexp(x, 0)`; the square root is
`numerics.sqrt_rn` (PyTorch's CPU float32 sqrt is not correctly rounded);
gelu is the tanh form; the forward's carried h is the compute-dtype h of
the last position, decode's stays float32.  The state (h, the conv
history) is float32 and written in place into the given tensors; the
forward also takes `state=None`, a training forward's fresh zero state, and
then returns its new state as a new dict, writing nothing
(`layers.carry_state`), so autograd can differentiate it.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.core.parallelism import Logical, ShardingRules, constrain
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import LayerQAT, _act, _uniform, carry_state
from repro_torch.numerics import sqrt_rn

Tensor = torch.Tensor
Params = dict[str, Any]

_C = 8.0  # Griffin's recurrence sharpness constant


def _rnn_dim(cfg: ModelConfig) -> int:
    return cfg.rnn_state_dim or cfg.d_model


def rglru_init(gen: torch.Generator, cfg: ModelConfig, lead: tuple = ()) -> Params:
    d, r = cfg.d_model, _rnn_dim(cfg)
    w = cfg.conv1d_width
    zeros = lambda *shape: torch.zeros(lead + shape, dtype=torch.float32, device=gen.device)  # noqa: E731
    # Λ init so that a ∈ [0.9, 0.999] at r=0.5 (Griffin appendix)
    lam = torch.empty(lead + (r,), dtype=torch.float32, device=gen.device).uniform_(0.9, 0.999, generator=gen)
    return {
        "wx": _uniform(gen, lead + (d, r), d),  # rnn input proj
        "wg": _uniform(gen, lead + (d, r), d),  # gate branch
        "wo": _uniform(gen, lead + (r, d), r),
        "conv_w": _uniform(gen, lead + (w, r), w) * 0.1,
        "conv_b": zeros(r),
        "wa": _uniform(gen, lead + (r, r), r),  # recurrence gate
        "ba": zeros(r),
        "wi": _uniform(gen, lead + (r, r), r),  # input gate
        "bi": zeros(r),
        "lam": torch.log(torch.expm1(-torch.log(lam) / (_C * 0.5))),
    }


def rglru_specs(cfg: ModelConfig) -> Params:
    return {
        "wx": Logical("embed", "state"),
        "wg": Logical("embed", "state"),
        "wo": Logical("state", "embed"),
        "conv_w": Logical(None, "state"),
        "conv_b": Logical("state"),
        "wa": Logical("state", None),
        "ba": Logical("state"),
        "wi": Logical("state", None),
        "bi": Logical("state"),
        "lam": Logical("state"),
    }


def init_state(cfg: ModelConfig, batch: int, device: torch.device, lead: tuple = ()) -> dict[str, Tensor]:
    r, w = _rnn_dim(cfg), cfg.conv1d_width
    return {"h": torch.zeros(lead + (batch, r), dtype=torch.float32, device=device),
            "conv": torch.zeros(lead + (batch, w - 1, r), dtype=torch.float32, device=device)}


def state_specs(cfg: ModelConfig) -> dict[str, Logical]:
    return {"h": Logical("batch", "state"),
            "conv": Logical("batch", None, "state")}


def _causal_conv(x: Tensor, p: Params, hist: Tensor) -> tuple[Tensor, Tensor]:
    """Width-w causal depthwise conv. x: (B,S,r); hist: (B,w-1,r)."""
    w = p["conv_w"].shape[0]
    xc = torch.cat([hist.to(x.dtype), x], dim=1)
    y = sum(xc[:, i:i + x.shape[1], :] * p["conv_w"][i].to(x.dtype) for i in range(w))
    new_hist = xc[:, -(w - 1):, :].to(torch.float32) if w > 1 else hist
    return y + p["conv_b"].to(x.dtype), new_hist


def _softplus(x: Tensor) -> Tensor:
    """`jax.nn.softplus`: logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _gates(xc: Tensor, p: Params, rules: Optional[ShardingRules] = None) -> tuple[Tensor, Tensor]:
    """a (decay) and gated input from the conv output, in float32.  The
    gate products contract the sharded state dim: each partial sum is laid
    out on "state" (a reduce-scatter) before its bias, which is sharded
    there (torch 2.11's DTensor has no Shard → Partial for the bias)."""
    xf = xc.to(torch.float32)
    rgate = torch.sigmoid(constrain(xf @ p["wa"], rules, "batch", "seq", "state") + p["ba"])
    igate = torch.sigmoid(constrain(xf @ p["wi"], rules, "batch", "seq", "state") + p["bi"])
    log_a = -_C * _softplus(p["lam"]) * rgate  # log a_t ≤ 0
    a = torch.exp(log_a)
    gated_in = sqrt_rn(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12)) * (igate * xf)
    return a, gated_in


def linear_scan(a: Tensor, b: Tensor) -> Tensor:
    """h_t = a_t·h_{t-1} + b_t along axis 1 from h_{-1} = 0: a log-depth
    doubling scan, ⌈log₂ S⌉ rounds of the pair op (a₁·a₂, a₂·b₁ + b₂)."""
    s, d = a.shape[1], 1
    while d < s:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        if 2 * d < s:  # the last round's products of a are never read
            a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


def rglru_forward(x: Tensor, p: Params, cfg: ModelConfig, state: Optional[dict[str, Tensor]],
                  rules: Optional[ShardingRules], qat: LayerQAT) -> tuple[Tensor, dict[str, Tensor]]:
    """Full-sequence recurrent block. x: (B, S, d).  Writes the new "h" and
    "conv" into `state`, or returns them as a new dict when `state` is None
    (a fresh zero state)."""
    dt = cfg.compute_dtype
    src = state if state is not None else init_state(cfg, x.shape[0], x.device)
    x = qat.site("rnn_in", x)
    gate = _act(x @ p["wg"].to(dt), "gelu")
    xr = constrain(x @ p["wx"].to(dt), rules, "batch", "seq", "state")
    xc, new_hist = _causal_conv(xr, p, src["conv"])

    a, gin = _gates(xc, p, rules)
    # seed the scan with the carried state: h_t = a·h + gin, over S steps
    gin = torch.cat([gin[:, :1] + a[:, :1] * src["h"][:, None], gin[:, 1:]], dim=1)
    h = constrain(linear_scan(a, gin).to(dt), rules, "batch", "seq", "state")

    y = (gate * h) @ p["wo"].to(dt)
    new = carry_state(state, {"h": h[:, -1, :], "conv": new_hist})
    return constrain(y, rules, "batch", "seq", "embed"), new


def decode_step(x: Tensor, p: Params, cfg: ModelConfig, state: dict[str, Tensor],
                rules: Optional[ShardingRules], qat: LayerQAT) -> tuple[Tensor, dict[str, Tensor]]:
    """O(1) one-token step. x: (B, 1, d)."""
    dt = cfg.compute_dtype
    x = qat.site("rnn_in", x)
    gate = _act(x @ p["wg"].to(dt), "gelu")
    xr = x @ p["wx"].to(dt)
    xc, new_hist = _causal_conv(xr, p, state["conv"])
    a, gin = _gates(xc, p, rules)
    h = a[:, 0] * state["h"] + gin[:, 0]
    y = (gate * h[:, None, :].to(dt)) @ p["wo"].to(dt)
    state["h"].copy_(h)
    state["conv"].copy_(new_hist)
    return constrain(y, rules, "batch", "seq", "embed"), state  # as `rglru_forward`'s


__all__ = ["rglru_init", "rglru_specs", "init_state", "state_specs", "rglru_forward", "decode_step",
           "linear_scan"]
