"""Stream batched DDPG updates through the learner engine, on the
PyTorch/CUDA port.

Simulates the training workload FIXAR's headline number comes from (many
update batches driven through the fused kernels with intra-batch
parallelism): producer threads submit replay batches and trajectory
chunks; the update batcher coalesces them into padded buckets; the
train-phase adaptive dispatcher picks per micro-batch between the
whole-update kernels (`fused_step`: kernels 4 + 5, fwd+bwd+Adam+soft-update
resident per loss), the fused forward/backward pair (`fused`: kernels B
and 3), and plain autograd (`jnp`); every update applies sequentially to
one training state.

    PYTHONPATH=src python examples/torch/train_learner.py [--device cpu]

The port of `examples/train_learner.py`: the same nets, producers, sizes
and printed lines, and the same calibration file (`BENCH_fused_mlp.json`,
the reference's kernel bench).
"""
import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2] / "src"))

import threading
import time

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.rl import ddpg
from repro_torch.rl.envs.locomotion import make
from repro_torch.serve.policy import BatcherConfig, CostModel
from repro_torch.train.learner import LearnerEngine

REPO = pathlib.Path(__file__).resolve().parents[2]


def replay_batch(rng, n, obs_dim, act_dim):
    return {
        "obs": rng.standard_normal((n, obs_dim)).astype(np.float32),
        "action": rng.uniform(-1, 1, (n, act_dim)).astype(np.float32),
        "reward": rng.standard_normal((n,)).astype(np.float32),
        "next_obs": rng.standard_normal((n, obs_dim)).astype(np.float32),
        "done": np.zeros((n,), bool),
    }


def main(device=None, *, producers=4, per_producer=8, trajectory=300):
    """Stream and print as the reference does; returns the engine's stats,
    the last trajectory metrics and the state's step."""
    dev = resolve_device(device)
    env = make("halfcheetah")
    cfg = ddpg.DDPGConfig(qat_delay=0)  # quantized phase from step 0
    state = ddpg.init(env.spec, cfg, generator=torch.Generator().manual_seed(0), device=dev)

    # train-phase dispatch calibrated from the tracked kernel bench
    cm = CostModel.from_bench(REPO / "BENCH_fused_mlp.json")
    engine = LearnerEngine.from_ddpg(
        state, cfg, cost_model=cm,
        batcher=BatcherConfig(buckets=(8, 32, 128), max_wait_ms=2.0))
    # warm the buckets the producers actually hit — large buckets dispatch
    # to the fused-step whole-update kernels once calibration favors them
    n = engine.warmup(buckets=(8, 32), padded=True)
    print(f"learner up: net={engine.dims}, calibration={cm.source}, "
          f"warmed {n} executables")
    print("train dispatch:",
          {b: cm.choose(b, engine.dims, phase='train') for b in (8, 32, 128)})

    rng = np.random.default_rng(0)
    engine.start()
    t0 = time.perf_counter()

    def producer(k):
        prng = np.random.default_rng(k)
        futs = [engine.submit(replay_batch(prng, int(prng.integers(4, 32)), env.spec.obs_dim, env.spec.act_dim))
                for _ in range(per_producer)]
        for f in futs:
            m = f.result(timeout=600.0)
            assert "critic_loss" in m

    threads = [threading.Thread(target=producer, args=(k,)) for k in range(producers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    # one whole-trajectory chunk, larger than the top bucket (auto-split)
    traj = replay_batch(rng, trajectory, env.spec.obs_dim, env.spec.act_dim)
    m = engine.submit(traj).result(timeout=600.0)
    engine.stop()
    dt = time.perf_counter() - t0

    s = engine.stats()
    print(f"{s['requests']} requests -> {s['updates']} updates "
          f"({s['transitions']} transitions) in {dt:.2f}s: "
          f"{s['train_ips_wall']:.0f} wall train-IPS, "
          f"{s['train_ips_device']:.0f} device train-IPS")
    print(f"latency p50 {s['p50_ms']:.2f} ms, p99 {s['p99_ms']:.2f} ms; "
          f"occupancy {s['batch_occupancy']:.2f}; "
          f"dispatch {s['mode_histogram']}; trajectory chunks={m['chunks']}")
    step = int(engine.state.step)
    print(f"state advanced to step {step}")
    return {"stats": s, "trajectory": m, "step": step, "warmed": n}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    main(ap.parse_args().device)
