"""Fixed-point Adam — FIXAR's on-chip Adam module (§III), port of
`repro.optim.fxp_adam`.

Weights and gradients are fxp32 (Q15.16) the whole run: the incoming
gradient is projected onto the lattice, the float Adam step runs against
precomputed `StepConstants`, and the stored parameter is projected again.
The moments stay in the optimizer's wide accumulators (float32); projecting
them is the `quantize_moments` ablation.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import fixedpoint as fxp
from repro_torch.optim import adam as fadam


@dataclasses.dataclass(frozen=True)
class FxpAdamConfig(fadam.AdamConfig):
    fmt: fxp.QFormat = fxp.FXP32
    quantize_moments: bool = False


def init(params) -> fadam.AdamState:
    return fadam.init(params)


def leaf_update(p, g, m, v, c: fadam.StepConstants, *, fmt: fxp.QFormat = fxp.FXP32,
                weight_decay: float = 0.0, ste: bool = True):
    """One leaf of the fixed-point Adam step: project the gradient onto the
    Qm.f lattice, run the float Adam step, project the stored parameter.
    `ste=False` uses `project` in place of the value-identical `fake_quant`.
    Returns (new_p, new_m, new_v)."""
    proj = fxp.fake_quant if ste else fxp.project
    g = proj(g.to(torch.float32), fmt)
    new_p, new_m, new_v = fadam.leaf_update(p, g, m, v, c, weight_decay=weight_decay)
    return proj(new_p, fmt), new_m, new_v


def update(cfg: FxpAdamConfig, grads, state: fadam.AdamState, params) -> tuple[dict, fadam.AdamState, dict]:
    """Returns (new_params, new_state, metrics)."""
    with torch.no_grad():
        # gradient memory is fxp32 (§III): project incoming grads first
        grads = fadam.tree_map(lambda g: fxp.fake_quant(g, cfg.fmt), grads)
        new_p, new_s, metrics = fadam._apply(
            cfg, grads, state, params,
            lambda p, g, m, v, c: leaf_update(p, g, m, v, c, fmt=cfg.fmt, weight_decay=cfg.weight_decay),
        )
        if cfg.quantize_moments:
            q = lambda t: fxp.fake_quant(t, cfg.fmt)  # noqa: E731
            new_s = fadam.AdamState(step=new_s.step, mu=fadam.tree_map(q, new_s.mu), nu=fadam.tree_map(q, new_s.nu))
    return new_p, new_s, metrics


__all__ = ["FxpAdamConfig", "init", "update", "leaf_update"]
