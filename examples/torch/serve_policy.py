"""Serve a frozen-quantized DDPG policy to concurrent clients, on the
PyTorch/CUDA port.

Simulates the deployment workload FIXAR is built for (many low-latency
policy queries against one quantized network): client threads fire single
observations at the engine; the micro-batcher coalesces them into padded
buckets; the adaptive dispatcher picks the kernel dataflow per batch
(intra-layer — kernel A, the dense layer — for trickles, the fused
intra-batch kernel B for bursts).

    PYTHONPATH=src python examples/torch/serve_policy.py [--device cpu]

The port of `examples/serve_policy.py`: the same sizes and printed lines.
On the CPU (`device="cpu"`) the kernels' plain versions serve.
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
from repro_torch.launch.mesh import make_serve_mesh
from repro_torch.rl import ddpg
from repro_torch.rl.envs.locomotion import make
from repro_torch.serve.policy import BatcherConfig, PolicyEngine


def main(device=None, *, n_clients=8, per_client=25, pool=512):
    """Serve and print as the reference does; returns the engine's stats,
    the observation pool and the actions `run_batch` gave for it."""
    dev = resolve_device(device)
    env = make("halfcheetah")
    cfg = ddpg.DDPGConfig(qat_delay=0)  # quantized phase from step 0
    state = ddpg.init(env.spec, cfg, generator=torch.Generator().manual_seed(0), device=dev)

    engine = PolicyEngine.from_ddpg(
        state,
        batcher=BatcherConfig(buckets=(1, 8, 32, 128, 512), max_wait_ms=2.0),
        mesh=make_serve_mesh(device=dev), device=dev)
    n = engine.warmup(buckets=(8, 32, 128))
    print(f"engine up: net={engine.dims}, frozen_quantized="
          f"{engine.frozen.quantized}, warmed {n} executables")

    # burst of concurrent clients, each a stream of single-obs requests
    rng = np.random.default_rng(0)
    obs_pool = rng.standard_normal((pool, env.spec.obs_dim)).astype(np.float32)
    engine.start()
    t0 = time.perf_counter()

    def client(k):
        for i in range(per_client):
            a = engine.submit(obs_pool[(k * per_client + i) % pool]).result(timeout=120.0)
            assert a.shape == (env.spec.act_dim,)

    threads = [threading.Thread(target=client, args=(k,)) for k in range(n_clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    engine.stop()
    dt = time.perf_counter() - t0

    s = engine.stats()
    print(f"{s['requests']} requests in {dt:.2f}s "
          f"({s['requests'] / dt:.0f} wall IPS, "
          f"{s['ips_device']:.0f} device IPS)")
    print(f"latency p50 {s['p50_ms']:.2f} ms, p99 {s['p99_ms']:.2f} ms; "
          f"occupancy {s['batch_occupancy']:.2f}; "
          f"dispatch {s['mode_histogram']}")
    # the big batched call for contrast (one device call, fused kernel)
    acts = engine.run_batch(obs_pool)
    print(f"batched run_batch({pool}) -> {acts.shape}, "
          f"mode histogram now {engine.stats()['mode_histogram']}")
    return {"stats": s, "obs": obs_pool, "actions": acts, "engine": engine}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    main(ap.parse_args().device)
