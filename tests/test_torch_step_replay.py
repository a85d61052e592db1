"""The check that holds kernels 4 and 5 against their twins
(`kernels.fxp_mlp.replay`), on the CPU with the twins standing in for the
kernels (no card needed).

The check replays a step kernel's pass-2 operands (each layer's product
inputs q_l and cotangents G_l) in float64 from their own previous layer,
admitting a decision either way only where float32 rounding can reach
across its edge, then widens the moments by how far those operands lie
from the twin's.  These tests show that it accepts a right computation
(the twin's own operands, summed in torch's order) and refuses faults
planted in it, in both QAT phases, for kernel 4 (the critic step) and
kernel 5 (the actor step):

* in the operands: one live row's cotangent dropped at a layer, one row of
  a site's product inputs moved one step (a Q15.16 quantum; in the quant
  phase to the next bf16 hi limb), a layer's cotangents scaled by
  1 + 2⁻¹⁰;
* in what pass 2 makes of right operands: a gradient that drops one row,
  and a tree left as it was.

Nets: 5 observations, 2 actions, hidden 24 and 16, inputs from numpy seeds.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import fixedpoint as fxp
from repro_torch.kernels.fxp_mlp import replay
from repro_torch.kernels.fxp_mlp.ops import _hyper
from repro_torch.kernels.fxp_mlp.ref import (_update_trees, ref_ddpg_actor_step, ref_ddpg_critic_step, ref_mlp_forward,
                                             ste_pass_mask)
from repro_torch.optim import adam

OBS, ACT, HID = 5, 2, (24, 16)
KW = dict(actor_acts=("relu", "relu", "tanh"), critic_acts=("relu", "relu", "none"), n_bits=16, qat=True,
          fxp32_phase1=True, fxp_weights=True)
PHASES = ("monitor", "quant")
NAMES = ("critic", "actor")


def _case(seed: int, batch: int, masked: int) -> dict:
    """A fused-step case: a batch with `masked` rows of weight 0, nets on
    the Q15.16 lattice, Adam moments as a run leaves them, site operands
    from fixed ranges, the hyper vector of Adam step 5."""
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0):
        return torch.from_numpy((rng.uniform(-1.0, 1.0, shape) * scale).astype(np.float32))

    def tree(dims, scale=None):
        ws = [t(k, n, scale=scale or k**-0.5) for k, n in zip(dims[:-1], dims[1:])]
        bs = [t(n, scale=scale or k**-0.5) for k, n in zip(dims[:-1], dims[1:])]
        if scale is None:
            ws, bs = [fxp.project(w, fxp.FXP32) for w in ws], [fxp.project(b, fxp.FXP32) for b in bs]
        return ws, bs

    a_dims, c_dims = (OBS, *HID, ACT), (OBS + ACT, *HID, 1)
    am, cm = tree(a_dims, 1e-3), tree(c_dims, 1e-3)
    second = lambda m: ([x * x * 2 + 1e-10 for x in m[0]], [x * x * 2 + 1e-10 for x in m[1]])  # noqa: E731
    c = {"obs": t(batch, OBS, scale=2.0), "action": t(batch, ACT), "reward": t(batch),
         "done": torch.from_numpy((rng.uniform(size=batch) < 0.1).astype(np.float32)),
         "next_obs": t(batch, OBS, scale=2.0),
         "w": (torch.arange(batch) < batch - masked).to(torch.float32),
         "actor": tree(a_dims), "actor_t": tree(a_dims), "actor_m": am, "actor_v": second(am),
         "critic": tree(c_dims), "critic_t": tree(c_dims), "critic_m": cm, "critic_v": second(cm), "kw": KW}
    lo = torch.from_numpy(-rng.uniform(1.0, 4.0, 6).astype(np.float32))
    d, z = fxp.affine_params(lo, torch.from_numpy(rng.uniform(1.0, 4.0, 6).astype(np.float32)), 16)
    c["deltas"], c["zs"] = d, z.to(torch.float32)
    consts = adam.step_constants(adam.AdamConfig(), torch.full((), 5, dtype=torch.int32))
    c["hyper"] = _hyper(1.0 / torch.clamp(c["w"].sum(), min=1.0), 0.99, 0.005, consts)
    return c


def _step(c: dict, name: str, quant: bool):
    """The twin's result of kernel 4 or 5 (kernel 5 through the twin's
    updated critic), its pass-2 operands, and that critic."""
    args = (c["obs"], c["action"], c["reward"], c["done"], c["next_obs"], c["w"], c["actor_t"], c["critic"],
            c["critic_t"], c["critic_m"], c["critic_v"], c["deltas"], c["zs"], c["hyper"])
    want_c = ref_ddpg_critic_step(*args, quant, **KW)
    critic = want_c[0] if name == "actor" else None
    if name == "critic":
        want = want_c
    else:
        want = ref_ddpg_actor_step(c["obs"], c["w"], c["actor"], c["actor_m"], c["actor_v"], c["actor_t"], critic,
                                   c["deltas"], c["zs"], c["hyper"], quant, **KW)
    twin = replay.step_twin(c, name, quant, critic)
    return want, [q.clone() for q in twin["qs"]], [g.clone() for g in twin["gs"]], critic


@pytest.mark.parametrize("batch,masked", [(9, 2), (40, 0)])
@pytest.mark.parametrize("phase", PHASES)
@pytest.mark.parametrize("name", NAMES)
def test_check_accepts_the_twins_own_result(name, phase, batch, masked):
    c = _case(batch, batch, masked)
    want, qs, gs, critic = _step(c, name, phase == "quant")
    res = replay.check_step(want, want, c, name, phase == "quant", qs, gs, critic)
    assert res["failures"] == []
    assert res["replay"]["rounded_apart"] == [0, 0, 0] and res["replay"]["relu_apart"] == [0, 0, 0]


def _next_product_input(q: torch.Tensor, quant: bool) -> torch.Tensor:
    """One step up of a product input: a Q15.16 quantum, or in the quant
    phase the next bf16 value (its hi limb's next code)."""
    if not quant:
        return q + 2.0**-16
    ulp = torch.where(q == 0, torch.full_like(q, 2.0**-20), 2.0 ** (torch.floor(torch.log2(q.abs())) - 7))
    return q + ulp


@pytest.mark.parametrize("layer", [0, 1, 2])
@pytest.mark.parametrize("fault", ["drop_row", "shift_code", "scale_G"])
@pytest.mark.parametrize("phase", PHASES)
@pytest.mark.parametrize("name", NAMES)
def test_check_refuses_a_fault_in_the_operands(name, phase, fault, layer):
    quant = phase == "quant"
    c = _case(11, 40, 6)
    want, qs, gs, critic = _step(c, name, quant)
    live = c["w"] != 0
    if fault == "drop_row":
        r = int((gs[layer].abs().sum(1) * live).argmax())
        assert float(gs[layer][r].abs().sum()) > 0
        gs[layer][r] = 0.0
    elif fault == "shift_code":
        qs[layer][3] = _next_product_input(qs[layer][3], quant)
    else:
        gs[layer] = gs[layer] * (1.0 + 2.0**-10)
    res = replay.check_step(want, want, c, name, quant, qs, gs, critic)
    assert res["failures"], "a planted fault passed the check"
    assert any(f.startswith(f"layer {layer}") for f in res["failures"]), res["failures"]


@pytest.mark.parametrize("fault", ["pass2_drops_a_row", "tree_left_as_it_was"])
@pytest.mark.parametrize("phase", PHASES)
@pytest.mark.parametrize("name", NAMES)
def test_check_refuses_a_fault_in_pass_2(name, phase, fault):
    quant = phase == "quant"
    c = _case(12, 40, 6)
    want, qs, gs, critic = _step(c, name, quant)
    trees = [c[name], c[f"{name}_m"], c[f"{name}_v"], c[f"{name}_t"]]
    if fault == "pass2_drops_a_row":
        r = int((gs[0].abs().sum(1)).argmax())
        keep = torch.ones(qs[0].shape[0], dtype=torch.bool)
        keep[r] = False
        dws = [q[keep].t() @ g[keep] for q, g in zip(qs, gs)]
        dbs = [g[keep].sum(0) for g in gs]
        got = (*_update_trees(*trees, dws, dbs, c["hyper"], True), *want[4:])
    else:
        got = (want[0], trees[1], want[2], want[3], *want[4:])
    res = replay.check_step(got, want, c, name, quant, qs, gs, critic)
    assert res["failures"], "a planted fault passed the check"


@pytest.mark.parametrize("phase", PHASES)
def test_check_admits_a_relu_decision_only_within_rounding(phase):
    """A ReLU decision taken the other way passes only where the exact
    pre-activation lies within the float32 rounding bound of 0: the
    kernel-5 actor's unit with the pre-activation nearest 0 (turned to an
    exact 0 by its bias) passes either way; the same flip at a unit far
    from 0 fails."""
    quant = phase == "quant"
    c = _case(13, 40, 0)
    want, qs, gs, critic = _step(c, "actor", quant)
    w, b = c["actor"][0][1].double(), c["actor"][1][1].double()
    pre = qs[1].double() @ w + b
    r, j = divmod(int(pre.abs().argmin()), pre.shape[1])
    bias = c["actor"][1][1].clone()
    bias[j] = float(b[j] - pre[r, j])  # row r's pre-activation at unit j now 0, up to float32 rounding of the bias
    c["actor"] = (c["actor"][0], [c["actor"][1][0], bias, c["actor"][1][2]])
    want, qs, gs, critic = _step(c, "actor", quant)
    dx = gs[2] @ c["actor"][0][2].t()
    flipped = [g.clone() for g in gs]
    flipped[1][r, j] = dx[r, j] if float(gs[1][r, j]) == 0.0 else 0.0
    # layer 0's cotangents follow from the flipped ones, as the kernel's would
    _, _, _, _, hs = ref_mlp_forward(c["obs"], *c["actor"], c["deltas"][:3], c["zs"][:3], activations=KW["actor_acts"],
                                     quant=quant, save_residuals=True)
    mask = ste_pass_mask(hs[0], quant, c["deltas"][1], c["zs"][1], n_bits=16, fxp32_phase1=True)
    g0 = flipped[1] @ c["actor"][0][1].t()
    flipped[0] = torch.where((hs[0] > 0) & mask, g0, torch.zeros_like(g0))
    near = replay.check_step_operands(c, "actor", quant, qs, flipped, critic)
    far_j = int((pre[r].abs() * (gs[1][r] != 0)).argmax())
    flipped = [g.clone() for g in gs]
    flipped[1][r, far_j] = 0.0
    far = replay.check_step_operands(c, "actor", quant, qs, flipped, critic)
    assert near["failures"] == [] and near["ambiguous"] >= 1
    assert any(f.startswith("layer 1") for f in far["failures"]), far["failures"]
