"""Fault-tolerance walkthrough: train, 'lose' hosts, elastically re-plan the
mesh, restore the checkpoint, and keep training with identical data order,
on the PyTorch/CUDA port.

    PYTHONPATH=src python examples/torch/elastic_restart.py [--device cpu]

The port of `examples/elastic_restart.py`: the same model (demo-100m's
smoke config), steps, simulated failure and printed lines.  One change:
the failure is detected at t = 75 s, not 95 s.  At 95 s the surviving
hosts' last beats, at 60 s, are 35 s old against the 30 s timeout, so the
reference's supervisor finds all four hosts dead and its plan raises
(`cannot keep model_parallel=16 with 0 devices`); at 75 s only host 3,
silent since 0 s, is.  The checkpoint goes to a temporary directory, as
the reference's does, or under `out_dir=`.
"""
import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2] / "src"))

import tempfile

import torch

from repro_torch import tree
from repro_torch.checkpoint import ckpt
from repro_torch.configs import registry
from repro_torch.data.synthetic import DataConfig, DataIterator
from repro_torch.device import resolve_device
from repro_torch.models.config import ShapeConfig
from repro_torch.optim import adam
from repro_torch.runtime import ft
from repro_torch.train.step import init_state, make_train_step


def main(device=None, *, steps=10, resumed_steps=5, out_dir=None):
    """Train, fail, re-plan and resume as the reference does; returns the
    saved state, whether the restored one is bitwise it, the step restored
    at, the elastic plan, both phases' losses, the resumed run's data steps
    and its final state."""
    dev = resolve_device(device)
    cfg = registry.get_smoke("demo_100m")
    shape = ShapeConfig("t", "train", 64, 8)
    opt = adam.AdamConfig(lr=1e-3, grad_clip_norm=1.0)
    step = make_train_step(cfg, opt)
    ckdir = tempfile.mkdtemp(prefix="fixar_elastic_", dir=out_dir)

    # --- phase 1: healthy cluster -----------------------------------------
    state = init_state(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    data = DataIterator(DataConfig(seed=0), cfg, shape, device=dev)
    losses = []
    for i in range(steps):
        state, m = step(state, next(data))
        losses.append(float(m["loss"]))
    ckpt.save(ckdir, steps, state)
    print(f"phase 1: {steps} steps, loss={losses[-1]:.4f}, checkpointed")

    # --- failure: 4 hosts -> 3 hosts ---------------------------------------
    class FakeClock:
        t = 0.0

        def __call__(self):
            return self.t

    clock = FakeClock()
    sup = ft.TrainingSupervisor(n_hosts=4, devices_per_host=64,
                                model_parallel=16, timeout_s=30, clock=clock)
    for h in range(4):
        sup.step_report(h, 1.0)
    clock.t = 60.0
    for h in (0, 1, 2):       # host 3 goes silent
        sup.step_report(h, 1.0)
    clock.t = 75.0            # host 3 silent for 75 s, the others 15 s: timeout 30 s
    plan = sup.check()
    print(f"failure detected -> elastic plan: mesh=({plan.data},{plan.model})"
          f" devices={plan.n_devices} grad_accum x{plan.grad_accum_factor}")

    # --- phase 2: restore + deterministic continuation ---------------------
    state2, restored_step, _ = ckpt.restore(ckdir, state, device=dev)
    same = all(torch.equal(a, b) for a, b in zip(tree.leaves(state), tree.leaves(state2), strict=True))
    data2 = DataIterator(DataConfig(seed=0), cfg, shape, start_step=restored_step, device=dev)
    losses2, data_steps = [], []
    for i in range(resumed_steps):
        data_steps.append(data2.step)
        state2, m = step(state2, next(data2))
        losses2.append(float(m["loss"]))
    print(f"phase 2: resumed at {restored_step}, continued {resumed_steps} steps, "
          f"loss={losses2[-1]:.4f}")
    print("data cursor determinism: restart consumed steps "
          f"{restored_step}..{restored_step + resumed_steps - 1} exactly once")
    return {"saved": state, "restored_bitwise": same, "restored_step": restored_step, "plan": plan,
            "losses": losses, "resumed_losses": losses2, "data_steps": data_steps, "checkpoint": ckdir,
            "final": state2}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    main(ap.parse_args().device)
