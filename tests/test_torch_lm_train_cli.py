"""The port's LM launch layer: `repro_torch.launch.specs` against the
reference's `repro.launch.specs`, and the training driver
`repro_torch.launch.train` as the reference's `tests/test_system.py` drives
its own; and the loss and gradient parity of the two frontend archs
(phi3-vision's image prefix, hubert's audio frames), QAT off, in the
monitor and the quant phase, at `tests/_torch_lm_train.py`'s tolerances
(loss 2e-5·|loss| + 2e-5; gradient leaves 1e-4·max|g_leaf| + 1e-6, 1e-3 in
the quant phase; ranges rtol 1e-4 / atol 5e-5).

Specs, for all ten archs at their full configs and every `ALL_SHAPES`
cell: input, param, train-state and decode-cache shapes and dtypes path by
path equal the reference's `jax.eval_shape` results (the port builds them
under `FakeTensorMode`, no memory); the logical trees equal the
reference's; and every sharding spec of `train_shardings` /
`serve_shardings` on the (16, 16) production layout equals the reference
rules' spec for the same logical axes and shape (the divisibility guard
on), exactly.  The driver: the loss falls on the synthetic stream (the
reference's rule: the mean of the last 5 steps below the first 5's by
0.2), a checkpointed run resumes to the step an uninterrupted run reaches,
bitwise on the CPU, and the device and mesh rules raise.
"""

import dataclasses
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401  (one intra-op thread a worker)

import jax  # noqa: E402

import _torch_lm_train as H  # noqa: E402

from repro.configs import registry as rreg  # noqa: E402
from repro.core import parallelism as rpar  # noqa: E402
from repro.launch import specs as RS  # noqa: E402
from repro.models.config import ALL_SHAPES  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.configs import registry as preg  # noqa: E402
from repro_torch.core import parallelism as ppar  # noqa: E402
from repro_torch.data.synthetic import DataConfig, DataIterator  # noqa: E402
from repro_torch.launch import specs as PS  # noqa: E402
from repro_torch.launch.train import main  # noqa: E402
from repro_torch.models.config import ShapeConfig  # noqa: E402
from repro_torch.optim import adam  # noqa: E402
from repro_torch.train.step import init_state, make_train_step  # noqa: E402

LAYOUT = ((16, 16), ("data", "model"))


class _RefMesh:
    """What the reference's rules read of a mesh: axis names and sizes."""

    def __init__(self, sizes, names):
        self.axis_names = names
        self.shape = dict(zip(names, sizes))


def _flat(node, path=""):
    """(keystr path, leaf) of a port tree whose leaves are `ShapeDtype`s,
    `Logical`s or `NamedSharding`s, in pytree order."""
    if isinstance(node, (PS.ShapeDtype, ppar.Logical, ppar.NamedSharding)):
        yield path, node
    elif isinstance(node, dict):
        for k in sorted(node):
            yield from _flat(node[k], f"{path}[{k!r}]")
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            yield from _flat(v, f"{path}[{i}]")
    elif dataclasses.is_dataclass(node):
        for f in dataclasses.fields(node):
            yield from _flat(getattr(node, f.name), f"{path}.{f.name}")


def _ref_flat(node, leaf=None):
    return [(jax.tree_util.keystr(p), x) for p, x in jax.tree_util.tree_flatten_with_path(node, is_leaf=leaf)[0]]


def _is_logical(x):
    return isinstance(x, rpar.Logical)


def _dtype_name(dt) -> str:
    return str(dt).removeprefix("torch.")


def _assert_same_shapes(got, want, what):
    got, want = list(_flat(got)), _ref_flat(want)
    assert got and [p for p, _ in got] == [p for p, _ in want], what
    for (path, g), (_, w) in zip(got, want):
        assert g.shape == tuple(w.shape) and _dtype_name(g.dtype) == np.dtype(w.dtype).name, (what, path, g, w)


def _assert_same_logical(got, want, what):
    got, want = list(_flat(got)), _ref_flat(want, _is_logical)
    assert got and [p for p, _ in got] == [p for p, _ in want], what
    assert all(g.axes == w.axes for (_, g), (_, w) in zip(got, want)), what


def _assert_shardings(got, logical, shapes, rules, what):
    """Every NamedSharding's spec against the reference rules' spec for the
    reference's logical axes at the reference's shape."""
    ref_mesh = _RefMesh(*LAYOUT)
    got = list(_flat(got))
    want = [(p, tuple(rules.mesh_axes(lg.axes, tuple(s.shape), ref_mesh)))
            for (p, lg), (_, s) in zip(_ref_flat(logical, _is_logical), _ref_flat(shapes))]
    assert got and [p for p, _ in got] == [p for p, _ in want], what
    for (path, g), (_, w) in zip(got, want):
        assert g.spec == w, (what, path, g.spec, w)


@pytest.mark.parametrize("arch", preg.lm_archs())
def test_specs_match_reference(arch):
    rcfg, pcfg = rreg.get(arch), preg.get(arch)
    _assert_same_shapes(PS.state_shapes(pcfg), RS.state_shapes(rcfg), f"{arch} state")
    _assert_same_shapes(PS.params_shapes(pcfg), RS.params_shapes(rcfg), f"{arch} params")
    _assert_same_logical(PS.state_logical(pcfg), RS.state_logical(rcfg), f"{arch} state logical")
    mesh = ppar.Mesh(*LAYOUT)
    ref_mesh = _RefMesh(*LAYOUT)
    for shape in ALL_SHAPES:
        what = f"{arch} {shape.name}"
        pshape = ShapeConfig(shape.name, shape.kind, shape.seq_len, shape.global_batch)
        _assert_same_shapes(PS.input_specs(pcfg, pshape), RS.input_specs(rcfg, shape), what)
        _assert_same_logical(PS.input_spec_logical(pcfg, pshape), RS.input_spec_logical(rcfg, shape), what)
        if shape.kind == "train":
            st_sh, b_sh = PS.train_shardings(pcfg, pshape, mesh, ppar.train_rules(mesh))
            rules = rpar.train_rules(ref_mesh)
            _assert_shardings(st_sh, RS.state_logical(rcfg), RS.state_shapes(rcfg), rules, what)
        else:
            p_sh, b_sh, c_sh = PS.serve_shardings(pcfg, pshape, mesh, ppar.serve_rules(mesh))
            rules = rpar.serve_rules(ref_mesh)
            _assert_shardings(p_sh, RS.T.param_specs(rcfg), RS.params_shapes(rcfg), rules, what)
            if shape.kind == "decode":
                c_shapes = RS.cache_shapes(rcfg, shape.global_batch, shape.seq_len)
                _assert_same_shapes(PS.cache_shapes(pcfg, shape.global_batch, shape.seq_len), c_shapes, what)
                _assert_shardings(c_sh, RS.T.cache_specs(rcfg), c_shapes, rules, what)
            else:
                assert c_sh is None
        _assert_shardings(b_sh, RS.input_spec_logical(rcfg, shape), RS.input_specs(rcfg, shape), rules, what)


def test_lm_loss_decreases_on_synthetic_stream():
    """Train demo-smoke on fresh synthetic batches: loss goes down (the
    stream has learnable n-gram structure, see data/synthetic.py)."""
    cfg = preg.get_smoke("demo_100m")
    shape = ShapeConfig("t", "train", 64, 8)
    state = init_state(0, cfg, device="cpu")
    step = make_train_step(cfg, adam.AdamConfig(lr=3e-3, grad_clip_norm=1.0))
    it = DataIterator(DataConfig(seed=0), cfg, shape, device="cpu")
    losses = []
    for _ in range(30):
        state, m = step(state, next(it))
        losses.append(float(m["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.2


def _cli(*extra):
    return ["--arch", "demo_100m", "--smoke", "--device", "cpu", "--batch", "2", "--seq", "32", "--qat",
            "--qat-delay", "8", *extra]


def test_train_driver_cli_resume(tmp_path, capsys):
    """The launch driver trains, checkpoints and resumes: with its last
    checkpoint deleted (a run preempted after step 12), the same command
    resumes from step 12 and reaches bitwise the uninterrupted run's state;
    its log lines are the reference's."""
    ck = tmp_path / "ck"
    argv = _cli("--steps", "18", "--ckpt-dir", str(ck), "--ckpt-every", "6", "--log-every", "6")
    whole, whole_records = main(argv)
    assert [r["quant_phase"] for r in whole_records] == [0, 1, 1]
    assert ckpt.latest_step(ck) == 18
    shutil.rmtree(ck / f"step_{18:08d}")
    capsys.readouterr()
    resumed, records = main(argv + ["--resume"])
    assert "resumed from step 12" in capsys.readouterr().out
    assert ckpt.latest_step(ck) == 18
    assert [r["step"] for r in records] == [18]
    assert set(records[0]) == {"step", "loss", "lr", "grad_norm", "quant_phase", "s_per_step", "tokens_per_s"}
    assert records[0]["loss"] == whole_records[-1]["loss"]
    assert all(torch.equal(a, b) for a, b in zip(tree.leaves(resumed), tree.leaves(whole)))
    assert int(resumed.step) == 18


def test_train_driver_device_and_mesh_rules():
    """Without `--device cpu` the driver needs a card; a mesh of more than
    one device needs a process group of its size (one process per rank,
    tests/test_torch_dist_ckpt.py): started alone it raises, never falling
    back to one device, and so does the 256-device production layout."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            main(["--arch", "demo_100m", "--smoke", "--steps", "1"])
    with pytest.raises(RuntimeError, match="torch.distributed.run"):
        main(_cli("--steps", "1", "--mesh", "debug"))
    with pytest.raises(RuntimeError, match="no process group"):
        main(_cli("--steps", "1", "--mesh", "pod16x16"))


@pytest.mark.parametrize("mode", H.MODES)
@pytest.mark.parametrize("arch", ["phi3_vision_4_2b", "hubert_xlarge"])
def test_frontend_loss_and_grads_match_reference(arch, mode):
    want_loss, want_grads, want_ranges = H.reference(arch, mode)
    loss, grads, ranges = H.port(arch, mode)
    H.assert_loss(loss, want_loss, f"{arch} {mode}")
    H.assert_grads(grads, want_grads, H.GRAD_TOL[mode], f"{arch} {mode}")
    if mode != "off":
        H.assert_ranges(ranges, want_ranges, f"{arch} {mode}")
