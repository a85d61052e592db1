"""The port's fleet telemetry layer (`repro_torch.obs.{export, server,
aggregate, slo}`, `Observability(serve_http=)`, `runtime.ft` mirrored into
the registry) against the reference's.

1. Every test of the reference's `tests/obs/test_{export, server,
   aggregate, slo, ft_metrics}.py`, run on the port's copies: each file's
   source with its `from repro.` imports pointed at `repro_torch.`,
   collected here as `test_<file>__<name>`.  The port's modules are
   copies, so the reference's own tests are their contract.
2. Parity: the same updates on a port registry and a reference registry
   render the same Prometheus text (metric names, labels and values; only
   the snapshot's timestamp differs), and a port and a reference learner
   engine fed the same request stream publish the same metric names and
   labels, with equal counts.
3. The port's engines on the HTTP endpoint: `PolicyEngine` and
   `LearnerEngine` with `Observability(serve_http=0)` serve `/metrics` and
   `/healthz` on an ephemeral port (xdist-safe), stopped in a `finally`.
"""

import json
import pathlib
import re
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401  (one intra-op thread a worker)

from repro.obs import export as r_export
from repro.obs import metrics as r_metrics

from repro_torch.obs import Observability, default_rules
from repro_torch.obs import export as p_export
from repro_torch.obs import metrics as p_metrics
from repro_torch.obs.aggregate import FleetAggregator
from repro_torch.obs.slo import SLOWatchdog

TESTS = pathlib.Path(__file__).resolve().parent
MIRRORED = ("test_export", "test_server", "test_aggregate", "test_slo", "test_ft_metrics")


def _mirror(stem: str) -> None:
    """Collect the reference test file `tests/obs/<stem>.py`, its imports
    pointed at the port, into this module (module docstring, item 1)."""
    path = TESTS / "obs" / f"{stem}.py"
    src = re.sub(r"^from repro\.", "from repro_torch.", path.read_text(), flags=re.M)
    assert "repro." not in re.sub(r"repro_torch\.", "", "\n".join(
        line for line in src.splitlines() if line.startswith(("from ", "import "))))
    ns = {"__name__": f"{__name__}.{stem}", "__file__": str(path)}
    exec(compile(src, str(path), "exec"), ns)
    for name, obj in ns.items():
        if name.startswith("test_") and callable(obj):
            globals()[f"test_{stem[5:]}__{name[5:]}"] = obj


for _stem in MIRRORED:
    _mirror(_stem)


def test_every_reference_fleet_test_is_mirrored():
    here = {n for n in globals() if "__" in n and n.startswith("test_")}
    for stem in MIRRORED:
        ref = re.findall(r"^def (test_\w+)", (TESTS / "obs" / f"{stem}.py").read_text(), flags=re.M)
        assert ref, stem
        assert {f"test_{stem[5:]}__{n[5:]}" for n in ref} <= here, stem


# --------------------------------------------------------------------- #
# Prometheus parity
# --------------------------------------------------------------------- #


def _fill(reg, rng):
    """The same updates on either package's registry."""
    reg.counter("learner.requests").inc(7)
    reg.counter("serve.batches").inc(3)
    reg.gauge("learner.dispatch_audit.drift_factor").set(1.25)
    reg.gauge("serve.qat.act0.saturation").set(0.0)
    h = reg.histogram("learner.latency_s")
    for v in rng.lognormal(-6.0, 1.0, size=200):
        h.observe(float(v))


def _samples(text: str) -> list[str]:
    """The sample lines of a Prometheus text, without the snapshot clock."""
    return [ln for ln in text.splitlines() if not ln.startswith(("obs_snapshot_ts", "# TYPE obs_snapshot_ts"))]


def test_prometheus_text_matches_reference():
    p_reg = p_metrics.MetricsRegistry(host="h")
    r_reg = r_metrics.MetricsRegistry(host="h")
    _fill(p_reg, np.random.default_rng(0))
    _fill(r_reg, np.random.default_rng(0))
    labels = {"host": "h", "role": "learner"}
    got = _samples(p_export.render_prometheus(p_reg, labels))
    want = _samples(r_export.render_prometheus(r_reg, labels))
    assert got == want
    assert any(ln.startswith("learner_latency_s_bucket{") for ln in got)
    # the wire forms agree too, but for the meta stamp
    p_wire, r_wire = p_reg.to_wire(), r_reg.to_wire()
    for wire in (p_wire, r_wire):
        wire.pop("meta")
    assert json.dumps(p_wire, sort_keys=True) == json.dumps(r_wire, sort_keys=True)


def _names_and_labels(text: str) -> set:
    return {ln.rsplit(" ", 1)[0] for ln in text.splitlines()
            if ln and not ln.startswith("#") and "_bucket{" not in ln}


def test_learner_engines_publish_the_same_metrics():
    """A port and a reference learner ("jnp", narrow nets) after the same
    four requests: the same Prometheus series (histogram buckets aside:
    they hold times), and equal counts."""
    import jax

    from repro.runtime.engine import BatcherConfig as RBatcherConfig
    from repro.train.learner import LearnerEngine as RLearner

    from repro_torch.convert import ddpg_state_from_numpy
    from repro_torch.runtime.engine import BatcherConfig
    from repro_torch.train.learner import LearnerEngine

    from test_torch_learner import narrow_reference_state, requests

    cfg_r, cfg_p, st_r = narrow_reference_state(qat=True)
    st_p = ddpg_state_from_numpy(jax.tree.map(np.asarray, st_r), device="cpu")
    r_eng = RLearner.from_ddpg(st_r, cfg_r, force_mode="jnp", batcher=RBatcherConfig(buckets=(8, 32)))
    p_eng = LearnerEngine.from_ddpg(st_p, cfg_p, force_mode="jnp", batcher=BatcherConfig(buckets=(8, 32)))
    for batch in requests((5, 8, 27, 40), seed=3):
        r_eng.run_update(batch)
        p_eng.run_update(batch)
    for eng in (r_eng, p_eng):
        eng.record_qat_telemetry(requests((8,), seed=4)[0])
    got = p_export.render_prometheus(p_eng.obs.registry)
    want = r_export.render_prometheus(r_eng.obs.registry)
    assert _names_and_labels(got) == _names_and_labels(want)
    p_c, r_c = p_eng.obs.registry.snapshot()["counters"], r_eng.obs.registry.snapshot()["counters"]
    assert p_c.keys() == r_c.keys()
    timed = {"learner.device_s"}  # seconds: each package's own
    assert {k: v for k, v in p_c.items() if k not in timed} == {k: v for k, v in r_c.items() if k not in timed}
    assert p_c["learner.updates"] == 5 and p_c["learner.transitions"] == 80


# --------------------------------------------------------------------- #
# the port's engines on the endpoint
# --------------------------------------------------------------------- #


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=5.0) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as err:
        return err.code, err.read().decode()


def test_policy_engine_serves_metrics_on_construction():
    from repro_torch.rl import ddpg
    from repro_torch.serve.policy import BatcherConfig, PolicyEngine

    actor = ddpg.init_actor(5, 2, generator=torch.Generator().manual_seed(0), device="cpu")
    obs = Observability(serve_http=0)
    try:
        engine = PolicyEngine(actor, device="cpu", force_mode="jnp", batcher=BatcherConfig(buckets=(1, 4)), obs=obs)
        assert obs.server is not None and obs.server.port not in (None, 0)
        engine.run_batch(np.zeros((3, 5), np.float32))
        code, body = _get(obs.server.url + "/metrics")
        assert code == 200 and "serve_batches 1" in body
        code, body = _get(obs.server.url + "/healthz")
        health = json.loads(body)
        # 503 when the dispatch audit finds the (uncalibrated) cost model stale
        assert code == (200 if health["ok"] else 503) and health["checks"]["serve"]["serving"] is False
        assert health["checks"]["serve"]["batches"] == 1
    finally:
        obs.close()
    assert obs.server is None


def test_learner_on_the_endpoint_slo_and_fleet():
    from repro_torch.runtime.engine import BatcherConfig
    from repro_torch.train.learner import LearnerEngine

    from test_torch_learner import narrow_port_state, requests

    cfg, state = narrow_port_state(qat=True)
    obs = Observability(serve_http=0)
    try:
        eng = LearnerEngine.from_ddpg(state, cfg, force_mode="fused", batcher=BatcherConfig(buckets=(8, 32)), obs=obs)
        for batch in requests((5, 8, 27), seed=1):
            eng.run_update(batch)
        code, body = _get(obs.server.url + "/metrics")
        assert code == 200
        assert "learner_updates 3" in body and "learner_transitions 40" in body
        code, body = _get(obs.server.url + "/healthz")
        health = json.loads(body)
        assert code == (200 if health["ok"] else 503) and health["checks"]["learner"]["training"] is False
        assert health["checks"]["learner"]["updates"] == 3
        alerts = SLOWatchdog(default_rules()).evaluate(obs.registry)
        assert isinstance(alerts, list)
        fleet = FleetAggregator()
        assert fleet.ingest(p_export.as_wire(obs.registry)) is not None
        assert fleet.merged().counter("learner.updates").value == 3
    finally:
        obs.close()
