"""Quickstart: FIXAR fixed-point QAT training of DDPG on a continuous-control
task — the paper's platform in ~40 lines, on the PyTorch/CUDA port.

    PYTHONPATH=src python examples/torch/quickstart.py [--device cpu]

The port of `examples/quickstart.py`: the same task, sizes and printed
lines.  `loop.train_fused` runs the chunked window driver; on the card it
captures the updating timestep as a CUDA graph, which needs the whole
update in the fused kernels 4 + 5 (`backend="pallas_fused_step"`), so this
script selects that backend (the reference's window driver runs its
default jnp update inside one `lax.scan`).  On the CPU (`device="cpu"`)
the same timestep runs eagerly through the kernels' plain versions.
"""
import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2] / "src"))

from repro_torch.device import resolve_device
from repro_torch.rl import ddpg, loop
from repro_torch.rl.envs.locomotion import make


def main(device=None, *, total_steps=6_000, warmup_steps=500, eval_every=2_000, chunk=1_000,
         eval_episodes=4, batch_size=64, replay_capacity=20_000):
    """Train and print as the reference does; returns the history, the
    quantization delay, the updates run, the QAT step and phase at each
    evaluation and the captured activation ranges ({site: (min, max)})."""
    dev = resolve_device(device)
    env = make("pendulum")

    # FIXAR Algorithm 1: fxp32 everywhere; activations drop to 16-bit affine
    # after the quantization delay (40% of training, as in the paper's runs).
    dcfg = ddpg.DDPGConfig(
        batch_size=batch_size,
        actor_lr=3e-4, critic_lr=1e-3,
        qat_enabled=True, fxp_weights=True,
        qat_delay=int(0.4 * total_steps),
        qat_bits=16,
        backend="pallas_fused_step",
    )
    cfg = loop.LoopConfig(total_steps=total_steps, warmup_steps=warmup_steps,
                          eval_every=eval_every, replay_capacity=replay_capacity,
                          eval_episodes=eval_episodes, seed=0)

    print(f"training DDPG on {env.spec.name} "
          f"(obs={env.spec.obs_dim}, act={env.spec.act_dim}), "
          f"quantization delay={dcfg.qat_delay} steps")
    at_eval = []  # (QAT step, quantized phase) at each evaluation

    def evaluate(env, agent, dcfg, generator, n_episodes):
        at_eval.append((int(agent.qat.step), bool(agent.qat.quantized_phase)))
        return loop.evaluate(env, agent, dcfg, generator, n_episodes)

    ts, hist = loop.train_fused(env, cfg, dcfg, eval_fn=evaluate, chunk=chunk, device=dev)
    for s, r, ips in zip(hist["step"], hist["eval_reward"], hist["ips"]):
        phase = "fxp16-activations" if s >= dcfg.qat_delay else "fxp32"
        print(f"  step {s:6d}  eval_reward {r:8.1f}  ips {ips:7.1f}  [{phase}]")
    ranges = {k: (float(v.a_min), float(v.a_max)) for k, v in ts.agent.qat.ranges.items()}
    print("done — captured activation ranges:",
          {k: (round(lo, 2), round(hi, 2)) for k, (lo, hi) in ranges.items()})
    return {"history": hist, "qat_delay": dcfg.qat_delay, "updates": int(ts.agent.step), "at_eval": at_eval,
            "ranges": ranges}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    main(ap.parse_args().device)
