"""The port's checkpoints, `repro_torch.checkpoint.ckpt`, against the
reference's `repro.checkpoint.ckpt`.

1. `tests/test_checkpoint.py`'s cases on the port, with torch tensors:
   round trip, latest/prune, a changed structure refused, the async
   writer, and restore onto a device (`device=`, the port's counterpart of
   `shardings=`).
2. Cross-restore, bitwise, both ways: a reference `DDPGState` saved by the
   reference restores in the port (into a port template) equal to
   `convert.ddpg_state_from_numpy` of it, and a port `DDPGState` saved by
   the port restores in the reference equal to the port's leaves.  Both
   packages write the same `leaf_names`, leaf shapes and dtypes (the Adam
   and QAT counters int32).  The states are narrow (actor 5-32-24-2) and
   have taken updates, so every moment, count and range is set.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401  (one intra-op thread a worker)

import jax

from repro.checkpoint import ckpt as rckpt
from repro.rl import ddpg as rddpg

from repro_torch import tree
from repro_torch.checkpoint import ckpt
from repro_torch.convert import ddpg_state_from_numpy, ddpg_state_to_numpy
from repro_torch.rl import ddpg as pddpg

from test_torch_learner import narrow_port_state, narrow_reference_state, requests


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn(4, 8, generator=g), "nested": {"b": torch.arange(5), "c": torch.tensor(3.5)}}


def _zeros_like(t):
    return tree.tree_map(torch.zeros_like, t)


def _equal(a, b) -> bool:
    la, lb = tree.leaves(a), tree.leaves(b)
    return len(la) == len(lb) and all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def test_roundtrip(tmp_path):
    t = _tree()
    ckpt.save(tmp_path, 7, t, extra={"note": "x"})
    restored, step, extra = ckpt.restore(tmp_path, _zeros_like(t))
    assert step == 7 and extra == {"note": "x"}
    assert _equal(restored, t)


def test_latest_and_prune(tmp_path):
    t = _tree()
    for s in (1, 2, 3, 4):
        ckpt.save(tmp_path, s, t)
    assert ckpt.latest_step(tmp_path) == 4
    ckpt.prune(tmp_path, keep=2)
    assert ckpt.latest_step(tmp_path) == 4
    with pytest.raises(FileNotFoundError):
        ckpt.restore(tmp_path, t, step=1)
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        ckpt.restore(tmp_path / "empty", t)


def test_structure_mismatch_rejected(tmp_path):
    ckpt.save(tmp_path, 1, _tree())
    with pytest.raises(ValueError, match="leaves"):
        ckpt.restore(tmp_path, {"a": torch.zeros(4, 8)})
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(tmp_path, {"a": torch.zeros(4, 9), "nested": {"b": torch.arange(5), "c": torch.tensor(0.0)}})


def test_async_checkpointer(tmp_path):
    w = ckpt.AsyncCheckpointer(tmp_path, keep=2)
    for s in (10, 20, 30):
        w.save(s, _tree(s))
    w.close()
    assert ckpt.latest_step(tmp_path) == 30
    assert sorted(p.name for p in tmp_path.glob("step_*")) == ["step_00000020", "step_00000030"]
    restored, _, _ = ckpt.restore(tmp_path, _tree())
    assert _equal(restored, _tree(30))


def test_restore_onto_a_device(tmp_path, monkeypatch):
    """`device=` places every leaf there, numpy template leaves included;
    without it each leaf lands where its template leaf is.  The device
    rule holds: `cuda` without a card raises."""
    t = {"t": torch.arange(6, dtype=torch.int32), "n": np.ones((2, 3), np.float32)}
    ckpt.save(tmp_path, 1, t)
    kept, _, _ = ckpt.restore(tmp_path, t)
    assert isinstance(kept["n"], np.ndarray) and kept["t"].device.type == "cpu"
    placed, _, _ = ckpt.restore(tmp_path, t, device="cpu")
    assert all(isinstance(x, torch.Tensor) and x.device.type == "cpu" for x in tree.leaves(placed))
    assert placed["t"].dtype == torch.int32 and placed["n"].dtype == torch.float32
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ckpt.restore(tmp_path, t, device="cuda")


# --------------------------------------------------------------------- #
# cross-restore with the reference
# --------------------------------------------------------------------- #


def _trained_reference():
    cfg_r, _, st = narrow_reference_state(qat=True, delay=1)
    for b in requests((8, 8, 8), seed=5):
        st, _ = rddpg.update(st, b, cfg_r)
    return st


def _trained_port():
    cfg, st = narrow_port_state(qat=True, delay=1)
    for b in requests((8, 8, 8), seed=6):
        st, _ = pddpg.update(st, {k: torch.from_numpy(v) for k, v in b.items()}, cfg)
    return st


def _manifest(path, step):
    return json.loads((path / f"step_{step:08d}" / "manifest.json").read_text())


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    st_r = _trained_reference()
    rckpt.save(tmp_path, 3, st_r, extra={"from": "reference"})
    _, template = narrow_port_state(qat=True, delay=1)
    got, step, extra = ckpt.restore(tmp_path, template)
    assert step == 3 and extra == {"from": "reference"}
    want = ddpg_state_from_numpy(jax.tree.map(np.asarray, st_r), device="cpu")
    assert _equal(got, want)
    assert int(got.actor_opt.step) == 3 and bool(got.qat.quantized_phase)
    assert _manifest(tmp_path, 3)["leaf_names"] == [p for p, _ in tree.flatten_with_path(template)]


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    st_p = _trained_port()
    ckpt.save(tmp_path / "port", 3, st_p)
    cfg_r, _, template = narrow_reference_state(qat=True, delay=1)
    got, step, _ = rckpt.restore(tmp_path / "port", template)
    assert step == 3
    want = tree.leaves(ddpg_state_to_numpy(st_p))
    leaves = jax.tree_util.tree_leaves(got)
    assert len(leaves) == len(want)
    for a, b in zip(leaves, want):
        assert np.asarray(a).dtype == b.dtype and np.array_equal(np.asarray(a), b)
    # the reference's own checkpoint of what it restored names and types
    # every leaf as the port's did
    rckpt.save(tmp_path / "reference", 3, got)
    mp, mr = _manifest(tmp_path / "port", 3), _manifest(tmp_path / "reference", 3)
    assert mp["leaf_names"] == mr["leaf_names"] == rckpt._leaf_paths(template)
    assert mp["leaves"] == mr["leaves"]
    # and the restored reference state trains on
    rddpg.update(got, requests((8,), seed=7)[0], cfg_r)


def test_ddpg_state_to_numpy_inverts_from_numpy():
    st_p = _trained_port()
    host = ddpg_state_to_numpy(st_p)
    assert all(isinstance(x, np.ndarray) for x in tree.leaves(host))
    assert host.actor_opt.step.dtype == np.int32 and host.qat.ranges["actor/l0"].count.dtype == np.int32
    assert _equal(ddpg_state_from_numpy(host, device="cpu"), st_p)
