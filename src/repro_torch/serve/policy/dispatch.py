"""Adaptive dispatch — the paper's configurable PE array as a cost model
(port of `repro.serve.policy.dispatch`, same API and same values).

FIXAR's AAP core runs ONE array under two dataflows and flips per workload
shape: intra-layer parallelism when a single vector must finish fast
(inference), intra-batch parallelism when many independent MVMs amortize the
array (training).  The serving engine faces the same choice per micro-batch,
plus a plain-PyTorch fallback:

  mode     kernel                                 parallelism    launches
  ------   ------------------------------------   ------------   --------
  fused    kernel B, kernels/fxp_mlp              intra-batch    1
  layer    kernel A per layer, kernels/fxp_matmul intra-layer    L
  jnp      plain PyTorch matmuls                  none (ref)     -

The dispatcher scores each mode with a two-term affine cost

    t(mode, B) = launches(mode) * per_launch_us[mode]
               + B * kflops_per_item * us_per_kflop[mode]

and picks the argmin.  Launch counts and FLOP shapes come from the kernels'
own cost hints (`fused_cost_hint` / `chain_cost_hint`, each with an
"act"/"train" phase axis).  `DEFAULT_COSTS` are the reference's hand-set
coefficients, kept so dispatch decisions match the reference: they are
uncalibrated defaults, not measurements of any chip.  `CostModel.from_bench`
refits them from a bench JSON in the reference's `BENCH_fused_mlp.json`
layout (two batch sizes separate slope from intercept); nothing in the port
points it at a file yet — the repo's BENCH files are CPU interpret-mode
numbers.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Optional, Sequence

from repro_torch.kernels._compat import mlp_flops as flops_per_item
from repro_torch.kernels.fxp_matmul.ops import chain_cost_hint
from repro_torch.kernels.fxp_mlp.ops import fused_cost_hint

MODES = ("fused", "layer", "jnp")
# the modes a train-phase dispatch may pick: the per-layer chain is
# forward-only (no autodiff rule), so it never enters a train argmin;
# fused_step is the 2-launch whole-update kernel (fwd+bwd+Adam+soft-update
# resident per loss) and is train-only — it has no acting face
TRAIN_MODES = ("fused_step", "fused", "jnp")

# maps a DDPG backend name (BENCH_fused_mlp.json's actor_ips keys) to a mode
BACKEND_TO_MODE = {"pallas": "fused", "pallas_layer": "layer", "jnp": "jnp",
                   "pallas_fused_step": "fused_step"}


def cost_hint(mode: str, dims: Sequence[int], phase: str = "act") -> dict:
    """The per-mode launch/FLOP shape: the two kernel modes describe
    themselves (`fused_cost_hint` / `chain_cost_hint`); the jnp fallback is
    costed as one dispatch over the same MLP, as in the reference.

    phase="act" is the forward/acting path (serving); phase="train" models
    one fwd+bwd step (2 launches and ~3x the MACs), as the reference does.
    """
    if phase not in ("act", "train"):
        raise ValueError(f"unknown cost phase {phase!r}; 'act' | 'train'")
    if mode == "fused_step":
        if phase != "train":
            raise ValueError(
                "mode 'fused_step' is train-only (the whole-update kernel "
                "has no acting face); use 'fused' for the act phase")
        # one whole ddpg.update: 2 launches (critic step, actor step).  The
        # FLOP axis stays per-loss-normalized (~3x a forward, same axis as
        # 'fused') so the two modes' fitted rates are directly comparable;
        # the second loss's MACs and the batch-independent Adam/soft-update
        # epilogues fold into the fitted coefficients
        return {"launches": 2, "flops_per_item": 3 * flops_per_item(dims),
                "parallelism": "intra_batch"}
    if mode == "fused":
        return fused_cost_hint(dims, phase)
    if mode == "layer":
        return chain_cost_hint(dims, phase)
    if mode == "jnp":
        mult = 3 if phase == "train" else 1
        return {"launches": 1, "flops_per_item": mult * flops_per_item(dims),
                "parallelism": "none"}
    raise ValueError(f"unknown serve mode {mode!r}; expected one of {MODES}")


@dataclasses.dataclass(frozen=True)
class ModeCost:
    per_launch_us: float   # fixed cost per kernel launch
    us_per_kflop: float    # marginal cost per item-kFLOP


# The reference's hand-set defaults (see module docstring): uncalibrated
# coefficients, not H100 measurements.  With the paper actor
# (17-400-300-6, ~257 kFLOP/item) these cross over at B ~ 100:
#   B=1   -> layer (3 cheap launches beat one big fused setup)
#   B=512 -> fused (per-item rate dominates, batch rides the grid axis)
DEFAULT_COSTS = {
    "fused": ModeCost(per_launch_us=120.0, us_per_kflop=0.0010),
    "layer": ModeCost(per_launch_us=10.0, us_per_kflop=0.0045),
    "jnp": ModeCost(per_launch_us=45.0, us_per_kflop=0.0120),
    # train-only whole-update kernel: fused's launch overhead minus the
    # per-launch residual traffic it no longer pays, slightly better
    # per-kflop rate (no HBM residual round-trip between fwd and bwd)
    "fused_step": ModeCost(per_launch_us=110.0, us_per_kflop=0.0009),
}


@dataclasses.dataclass
class CostModel:
    """Per-(phase, mode) affine latency model + argmin chooser.

    `costs` holds the act-phase coefficients; `train_costs` holds per-mode
    train-phase overrides.  A mode missing from `train_costs` falls back to
    its act coefficients — the phase-dependent launch/FLOP *hints* already
    model the custom-VJP shape (2 launches, ~3x MACs), so the fallback is a
    structural estimate rather than a phase-blind one.
    """

    costs: dict[str, ModeCost]
    train_costs: dict[str, ModeCost] = dataclasses.field(default_factory=dict)
    source: str = "default"

    @staticmethod
    def default() -> "CostModel":
        return CostModel(dict(DEFAULT_COSTS))

    @staticmethod
    def launches(mode: str, dims: Sequence[int], phase: str = "act") -> int:
        return cost_hint(mode, dims, phase)["launches"]

    def coeffs(self, mode: str, phase: str = "act") -> ModeCost:
        """The fitted coefficients serving a (mode, phase) estimate."""
        if phase == "train" and mode in self.train_costs:
            return self.train_costs[mode]
        return self.costs[mode]

    def estimate_us(self, mode: str, batch: int, dims: Sequence[int],
                    phase: str = "act") -> float:
        c = self.coeffs(mode, phase)
        hint = cost_hint(mode, dims, phase)
        kflops = batch * hint["flops_per_item"] / 1e3
        return c.per_launch_us * hint["launches"] + c.us_per_kflop * kflops

    def choose(self, batch: int, dims: Sequence[int],
               modes: Optional[Sequence[str]] = None,
               phase: str = "act") -> str:
        if modes is None:
            modes = TRAIN_MODES if phase == "train" else MODES
        return min(modes,
                   key=lambda m: self.estimate_us(m, batch, dims, phase))

    @staticmethod
    def _fit_mode(mode: str, net: Sequence[int], phase: str,
                  by_batch: dict, single_us: Optional[float],
                  single_batch: int, base: ModeCost) -> Optional[ModeCost]:
        """One (mode, phase) affine fit from measured throughput.

        Preferred input: `by_batch` — {batch: items-per-second} at TWO (or
        more) batch sizes.  Two measurements separate the slope from the
        intercept of `t(B) = launches*per_launch + B*kflops*rate`: the
        extreme-batch pair gives `slope = (t2-t1)/(B2-B1)` (the per-item
        rate) and `intercept = t1 - slope*B1` (the launch overhead), so
        BOTH coefficients are fitted instead of only the marginal rate.

        Fallback: a single measured wall time `single_us` for a batch of
        `single_batch` items — keep `base`'s launch overhead and back out
        the marginal rate.  Returns None when nothing usable was measured.
        """
        hint = cost_hint(mode, net, phase)
        kflops = hint["flops_per_item"] / 1e3

        # ---- two-point fit: slope AND intercept ---------------------------
        points = sorted((int(b), int(b) / float(v) * 1e6)
                        for b, v in dict(by_batch).items() if float(v) > 0)
        if len(points) >= 2 and points[0][0] != points[-1][0]:
            (b1, t1), (b2, t2) = points[0], points[-1]
            slope = (t2 - t1) / (b2 - b1)
            intercept = t1 - slope * b1
            if slope > 0 and intercept > 0:
                return ModeCost(per_launch_us=intercept / hint["launches"],
                                us_per_kflop=slope / kflops)
            # degenerate fit (noise gave a negative coefficient): fall
            # through to single-point

        # ---- legacy single-point: rate only, `base` overheads -------------
        if single_us is None or single_us <= 0:
            return None
        overhead = base.per_launch_us * hint["launches"]
        marginal_us = max(single_us - overhead, 0.1 * single_us)
        return ModeCost(base.per_launch_us,
                        marginal_us / (single_batch * kflops))

    @staticmethod
    def from_bench(path, fallback_to_default: bool = True) -> "CostModel":
        """Recalibrate the affine cost model from `BENCH_fused_mlp.json`.

        Act phase: fits from `actor_ips_by_batch` (two-point, both
        coefficients) or the legacy single-batch `actor_ips` (rate only,
        default overheads) — see `_fit_mode`.

        Train phase: fits per-mode `train_costs` from the bench's `train`
        section — two-point from `train.ips_by_batch` (trained-samples/sec
        per batch size) when present, else single-point from
        `train.updates_per_s` at `train.batch` (one update's wall time
        against the train-phase launch/FLOP hint).

        Missing file / missing modes / degenerate fits keep their defaults
        (the model must stay total — the dispatcher cannot refuse to
        answer; an unfitted train mode estimates through its act
        coefficients and the train-phase hint).
        """
        path = pathlib.Path(path)
        costs = dict(DEFAULT_COSTS)
        train_costs: dict[str, ModeCost] = {}
        if not path.exists():
            if not fallback_to_default:
                raise FileNotFoundError(path)
            return CostModel(costs, source="default (no bench file)")
        try:
            data = json.loads(path.read_text())
            b0 = int(data.get("config", {}).get("batch", 256))
            net = list(data.get("config", {}).get("net", [17, 400, 300, 6]))
            by_batch = data.get("actor_ips_by_batch", {})
            single = data.get("actor_ips", {})
            for backend in sorted({*single, *by_batch}):
                mode = BACKEND_TO_MODE.get(backend)
                if mode is None:
                    continue
                try:
                    ips = float(single.get(backend, 0.0))
                    fit = CostModel._fit_mode(
                        mode, net, "act", by_batch.get(backend, {}),
                        b0 / ips * 1e6 if ips > 0 else None, b0,
                        costs[mode])
                    if fit is not None:
                        costs[mode] = fit
                except (ValueError, TypeError, KeyError, AttributeError):
                    # one malformed backend entry must not discard the
                    # other modes' fits — THIS mode keeps its default
                    if not fallback_to_default:
                        raise
                    continue
            train = data.get("train", {}) or {}
            tb = int(train.get("batch", b0))
            t_by_batch = train.get("ips_by_batch", {})
            t_single = train.get("updates_per_s", {})
            for backend in sorted({*t_single, *t_by_batch}):
                mode = BACKEND_TO_MODE.get(backend)
                if mode is None:
                    continue
                try:
                    ups = float(t_single.get(backend, 0.0))
                    fit = CostModel._fit_mode(
                        mode, net, "train", t_by_batch.get(backend, {}),
                        1e6 / ups if ups > 0 else None, tb, costs[mode])
                    if fit is not None:
                        train_costs[mode] = fit
                except (ValueError, TypeError, KeyError, AttributeError):
                    if not fallback_to_default:
                        raise
                    continue
        except (ValueError, TypeError, KeyError, AttributeError,
                OSError) as err:
            # truncated/malformed bench file (e.g. kernel_bench killed
            # mid-write) must not break serving — keep defaults
            if not fallback_to_default:
                raise
            return CostModel(dict(DEFAULT_COSTS),
                             source=f"default (unreadable bench: {err})")
        return CostModel(costs, train_costs, source=str(path))


__all__ = ["MODES", "TRAIN_MODES", "ModeCost", "CostModel", "DEFAULT_COSTS",
           "cost_hint", "flops_per_item"]
