"""Observe a serving run end to end: metrics registry, request-lifecycle
trace, QAT saturation telemetry, and the dispatch predicted-vs-measured
audit, on the PyTorch/CUDA port.

Runs the same concurrent-client workload as serve_policy.py but with the
unified observability bundle attached, then shows how to read each layer:

  * ``engine.stats()`` — the familiar summary (now registry-backed).
  * ``obs.registry.snapshot()`` — every counter/gauge/histogram by name,
    shared across the engine, the micro-batcher, and anything else wired
    to the same registry.
  * ``stats()["dispatch_audit"]`` — CostModel predictions vs measured
    wall time per (phase, mode, bucket), with a drift factor that flags
    stale calibration.
  * ``stats()["qat_telemetry"]`` — per-site activation ranges and
    clip-saturation rates for the frozen quantized policy.
  * a Chrome trace-event JSONL — open it at https://ui.perfetto.dev to
    see enqueue -> coalesce -> dispatch -> launch -> block_until_ready
    -> reply spans per request.

    PYTHONPATH=src python examples/torch/observe_serve.py [--device cpu]

The port of `examples/observe_serve.py`: the same workload, sizes and
printed lines; the trace and the snapshot go to `results/` (as the
reference's), or under `out_dir=`.
"""
import argparse
import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2] / "src"))

import threading

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.obs import Observability
from repro_torch.rl import ddpg
from repro_torch.rl.envs.locomotion import make
from repro_torch.serve.policy import BatcherConfig, PolicyEngine

RESULTS = pathlib.Path(__file__).resolve().parents[2] / "results"


def main(device=None, *, n_clients=8, per_client=20, out_dir=None):
    """Serve and print as the reference does; returns the engine's stats,
    the registry's snapshot and the two files' paths."""
    dev = resolve_device(device)
    env = make("halfcheetah")
    cfg = ddpg.DDPGConfig(qat_delay=0)  # quantized phase from step 0
    state = ddpg.init(env.spec, cfg, generator=torch.Generator().manual_seed(0), device=dev)

    # tracing() enables the span tracer; qat_probe_every=4 re-measures
    # activation saturation every 4th batch (0 disables the probe)
    obs = Observability.tracing(qat_probe_every=4)
    engine = PolicyEngine.from_ddpg(
        state,
        batcher=BatcherConfig(buckets=(1, 8, 32, 128), max_wait_ms=2.0),
        obs=obs, device=dev)
    engine.warmup(buckets=(8, 32))
    engine.reset_stats()  # drop warmup from the telemetry

    rng = np.random.default_rng(0)
    obs_pool = rng.standard_normal((256, env.spec.obs_dim)).astype(np.float32)
    engine.start()

    def client(k):
        for i in range(per_client):
            engine.submit(obs_pool[(k * per_client + i) % 256]).result(
                timeout=120.0)

    threads = [threading.Thread(target=client, args=(k,))
               for k in range(n_clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    engine.stop()

    st = engine.stats()
    print(f"{st['requests']} requests, {st['batches']} device batches, "
          f"p50 {st['p50_ms']:.2f} ms / p99 {st['p99_ms']:.2f} ms, "
          f"dispatch {st['mode_histogram']}")

    audit = st["dispatch_audit"]
    print(f"\ndispatch audit over {audit['batches']} batches: "
          f"drift x{audit['drift_factor']:.2f} "
          f"(stale={audit['stale']}, threshold x{audit['threshold']:.1f})")
    for phase, modes in audit["table"].items():
        for mode, cells in modes.items():
            for bucket, c in cells.items():
                print(f"  {phase}/{mode}/b{bucket}: predicted "
                      f"{c['predicted_us']:.0f} us, measured "
                      f"{c['measured_us']:.0f} us over n={c['n']}")

    print("\nQAT telemetry (per-site range + clip saturation):")
    for site, t in sorted(st["qat_telemetry"].items()):
        line = f"  {site}: range [{t['a_min']:.3f}, {t['a_max']:.3f}]"
        if t.get("probes"):
            line += (f", acts [{t['act_min']:.3f}, {t['act_max']:.3f}], "
                     f"saturation {t['saturation']:.4f} "
                     f"over {t['probes']} probes")
        print(line)

    snap = obs.registry.snapshot()
    print(f"\nregistry: {len(snap['counters'])} counters, "
          f"{len(snap['gauges'])} gauges, "
          f"{len(snap['histograms'])} histograms")
    wait = snap["histograms"].get("serve.batcher.queue_wait_s")
    if wait and wait["count"]:
        print(f"  queue wait p50 {wait['p50'] * 1e3:.2f} ms, "
              f"p99 {wait['p99'] * 1e3:.2f} ms over {wait['count']} reqs")

    out = pathlib.Path(out_dir) if out_dir is not None else RESULTS
    out.mkdir(parents=True, exist_ok=True)
    trace_path = obs.tracer.write(out / "trace_observe_serve.jsonl")
    n_events = len(obs.tracer.events())
    print(f"\nwrote {n_events} trace events -> {trace_path}")
    print("open at https://ui.perfetto.dev (or chrome://tracing)")

    (out / "observe_serve_snapshot.json").write_text(
        json.dumps({"stats": st, "registry": snap}, indent=2))
    print(f"wrote registry snapshot -> {out / 'observe_serve_snapshot.json'}")
    return {"stats": st, "registry": snap, "trace": trace_path, "snapshot": out / "observe_serve_snapshot.json"}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    main(ap.parse_args().device)
