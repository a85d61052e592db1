"""Fleet observability end to end: N serving processes, one merged view,
on the PyTorch/CUDA port.

Spawns three OS processes, each running its own `PolicyEngine` with an
`Observability(serve_http=0)` bundle — every host serves its registry over
HTTP (``/metrics`` Prometheus text, ``/snapshot`` lossless wire JSON,
``/healthz`` engine health).  The parent is the fleet control plane:

  * polls each host's ``/snapshot`` into a `FleetAggregator` — counters
    summed, latency histograms bucket-merged (fleet p50/p99), gauges
    last-write-wins with the per-host breakdown kept;
  * tracks per-host liveness (snapshots still arriving?) and staleness
    (how old is the data itself?);
  * runs the default `SLOWatchdog` rules against the merged registry.

One host ("rogue") is deliberately mis-calibrated: its dispatcher runs
from a `CostModel` whose latency predictions are absurd, so its
predicted-vs-measured audit drifts immediately, its
``serve.dispatch_audit.stale`` gauge flips to 1.0, its ``/healthz`` turns
503 — and the fleet-level ``dispatch-calibration-stale`` SLO rule fires,
naming exactly that host's gauge.  At the end the workers are stopped and
the aggregator is polled once more to show liveness flipping dead
(the ``heartbeat-gap`` rule fires for every silent host).

    PYTHONPATH=src python examples/torch/observe_fleet.py [--device cpu]

The port of `examples/observe_fleet.py`: the same fleet, rounds and
printed lines.  Every host serves on `device` (the card unless "cpu"; the
three share it); the merged exposition and snapshot go to `results/` (as
the reference's), or under `out_dir=`.  The hosts are spawned processes
that import this file by its module name: run it as a script, or import it
with `examples/torch` on `sys.path`.
"""

import argparse
import json
import multiprocessing as mp
import pathlib
import sys
import time
import urllib.request

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2] / "src"))

RESULTS = pathlib.Path(__file__).resolve().parents[2] / "results"

OBS_DIM, ACT_DIM = 9, 3
STALENESS_S = 2.0


def serve_host(name: str, rogue: bool, port_q, stop_evt, device: str) -> None:
    """One fleet member: engine + HTTP endpoint, traffic until told to
    stop.  Runs in its own OS process (own registry, own port)."""
    import numpy as np
    import torch

    from repro_torch.obs import MetricsRegistry, Observability
    from repro_torch.rl import ddpg
    from repro_torch.rl.envs.base import EnvSpec
    from repro_torch.serve.policy import BatcherConfig, PolicyEngine
    from repro_torch.serve.policy.dispatch import CostModel, ModeCost

    spec = EnvSpec(name="fleet-demo", obs_dim=OBS_DIM, act_dim=ACT_DIM, episode_length=50)
    cfg = ddpg.DDPGConfig(qat_delay=0)
    state = ddpg.init(spec, cfg, generator=torch.Generator().manual_seed(0), device=device)

    kwargs = {}
    if rogue:
        # a cost model predicting nanosecond latencies: measured wall time
        # is off by orders of magnitude, so the audit's drift crosses the
        # default 3x threshold within a batch -> stale gauge -> 503 -> SLO
        kwargs["cost_model"] = CostModel(
            {
                m: ModeCost(per_launch_us=0.001, us_per_kflop=1e-9)
                for m in ("fused", "layer", "jnp")
            },
            source="rogue-demo",
        )
        threshold = 3.0
    else:
        # healthy hosts: this demo machine's CPU timings bear no relation
        # to the checked-in accelerator calibration, so park the threshold
        # high — the demo is about the ROGUE host drifting, not about
        # recalibrating the demo machine
        threshold = 1e9

    obsb = Observability(
        registry=MetricsRegistry(host=name), serve_http=0, audit_threshold=threshold
    )
    eng = PolicyEngine.from_ddpg(
        state,
        batcher=BatcherConfig(buckets=(1, 8, 32), max_wait_ms=1.0),
        obs=obsb,
        force_mode="jnp",
        device=device,
        **kwargs,
    )
    port_q.put((name, obsb.server.port))

    rng = np.random.default_rng(0)
    pool = rng.standard_normal((64, OBS_DIM)).astype(np.float32)
    with eng:
        i = 0
        while not stop_evt.is_set():
            eng.submit(pool[i % 64]).result(timeout=60.0)
            i += 1
            time.sleep(0.002)
    obsb.close()


def fetch(port: int, route: str):
    """GET a host endpoint; returns (status, parsed body)."""
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{route}", timeout=5.0) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as err:  # 503 still carries JSON
        return err.code, json.loads(err.read())


def _stop(procs, stop_evt) -> None:
    """Tell the hosts to stop and join them; one that outlives the wait is
    killed."""
    stop_evt.set()
    for p in procs:
        p.join(timeout=60.0)
        if p.is_alive():
            p.kill()
            p.join()


def main(device=None, *, rounds=6, out_dir=None):
    """Run the fleet and print as the reference does; returns the alerts of
    the first evaluation, the per-host /healthz codes, the liveness after
    shutdown, the watchdog's firing rules then, and the two files' paths."""
    from repro_torch.device import resolve_device
    from repro_torch.obs import FleetAggregator, SLOWatchdog, render_prometheus

    dev = resolve_device(device)
    ctx = mp.get_context("spawn")  # fresh interpreters: no CUDA-after-fork
    port_q = ctx.Queue()
    stop_evt = ctx.Event()
    hosts = [("actor-0", False), ("actor-1", False), ("rogue", True)]
    procs = [
        ctx.Process(target=serve_host, args=(n, r, port_q, stop_evt, str(dev)), daemon=True) for n, r in hosts
    ]
    for p in procs:
        p.start()
    try:
        ports = dict(port_q.get(timeout=180.0) for _ in procs)
        print(f"fleet up: { {n: f'127.0.0.1:{p}' for n, p in ports.items()} }")

        agg = FleetAggregator(staleness_s=STALENESS_S)
        watchdog = SLOWatchdog()

        # ---- poll the fleet for a few rounds --------------------------------
        for _ in range(rounds):
            time.sleep(0.5)
            for name, port in ports.items():
                _, snap = fetch(port, "/snapshot")
                agg.ingest(snap)
        alerts = watchdog.evaluate(agg)

        # ---- the merged view ------------------------------------------------
        merged = agg.merged()
        lat = merged.histogram("serve.latency_s")
        reqs = merged.counter("serve.requests").value
        print(
            f"\nfleet: {reqs:.0f} requests, merged latency "
            f"p50 {lat.quantile(0.5) * 1e3:.2f} ms / "
            f"p99 {lat.quantile(0.99) * 1e3:.2f} ms"
        )

        print("\nper-host liveness:")
        for name, h in agg.hosts().items():
            print(
                f"  {name}: alive={h['alive']} seq={h['seq']} "
                f"snapshot_age={h['snapshot_age_s']:.2f}s"
            )

        print("\nper-host dispatch calibration (gauges the LWW merge keeps broken out):")
        by_host = agg.gauges_by_host()
        for name in ports:
            drift = by_host.get("serve.dispatch_audit.drift_factor", {})
            stale = by_host.get("serve.dispatch_audit.stale", {})
            d = drift.get(name)
            print(
                f"  {name}: drift x{d:.2f} stale={stale.get(name)}"
                if d is not None
                else f"  {name}: no batches yet"
            )

        print("\nper-host /healthz (rogue must be 503):")
        codes = {}
        for name, port in ports.items():
            code, health = fetch(port, "/healthz")
            codes[name] = code
            print(f"  {name}: {code} ok={health['ok']}")

        print(f"\nSLO evaluation -> {len(alerts)} alert(s):")
        for a in alerts:
            print(f"  [{a['severity']}] {a['rule']}: {a['message']}")
        assert any(
            a["rule"] == "dispatch-calibration-stale" for a in alerts
        ), "the rogue host's drifted calibration must trip the SLO rule"

        # ---- stop the fleet; silent hosts flip dead -------------------------
        _stop(procs, stop_evt)
        time.sleep(STALENESS_S + 0.5)
        watchdog.evaluate(agg)
        print(
            "\nafter shutdown (no snapshots for "
            f"{STALENESS_S + 0.5:.1f}s): "
            f"alive={ {n: h['alive'] for n, h in agg.hosts().items()} }, "
            f"firing={watchdog.firing()}"
        )
    finally:
        _stop(procs, stop_evt)

    out = pathlib.Path(out_dir) if out_dir is not None else RESULTS
    out.mkdir(parents=True, exist_ok=True)
    (out / "observe_fleet_metrics.prom").write_text(
        render_prometheus(merged, labels={"fleet": "demo"})
    )
    (out / "observe_fleet_snapshot.json").write_text(json.dumps(agg.snapshot(), indent=2) + "\n")
    print(f"\nwrote merged Prometheus exposition -> {out / 'observe_fleet_metrics.prom'}")
    print(f"wrote fleet snapshot -> {out / 'observe_fleet_snapshot.json'}")
    return {"alerts": alerts, "healthz": codes, "requests": reqs,
            "alive": {n: h["alive"] for n, h in agg.hosts().items()}, "firing": watchdog.firing(),
            "prometheus": out / "observe_fleet_metrics.prom", "snapshot": out / "observe_fleet_snapshot.json"}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    main(ap.parse_args().device)
