"""Port parity: the adaptive-parallelism rules (`repro_torch.core.parallelism`)
and the mesh builders (`repro_torch.launch.mesh`) against the JAX reference.

The rules are pure data and shape arithmetic, so parity is exact: every
preset and keyword gives the reference's rules dict on the (1, 1), (2, 4),
(16, 16) and (2, 16, 16) layouts, and `mesh_axes` gives the reference's
spec (entry for entry of its PartitionSpec) for every leaf of every
LM arch's `param_specs` and `cache_specs`, with the shape-aware
divisibility guard, at the full configs' shapes.  The reference's meshes
are stand-ins with `.axis_names` / `.shape` (as tests/test_sharding.py
builds one), so no layout needs devices.  `constrain` is a no-op on one
device and raises on more.
"""

import itertools
import types

import pytest

torch = pytest.importorskip("torch")

import jax
from jax.sharding import PartitionSpec as P

from repro.configs import registry as rreg
from repro.core import parallelism as rpar
from repro.models import transformer as RT

from repro_torch import core as pcore
from repro_torch.configs import registry as preg
from repro_torch.core import parallelism as ppar
from repro_torch.launch import mesh as pmesh
from repro_torch.models import transformer as PT

LAYOUTS = {
    "1x1": ((1, 1), ("data", "model")),
    "2x4": ((2, 4), ("data", "model")),
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
}
PRESETS = [("train", {}), ("train", {"shard_seq": True})] + [
    ("serve", dict(shard_kv_seq=a, prefer_head_dim=b, shard_expert_ffn=c))
    for a, b, c in itertools.product((False, True), repeat=3)
]
ARCHS = preg.lm_archs()  # every block family: attention, MoE, RWKV-6, RG-LRU


class _RefMesh:
    """What the reference's rules read of a mesh: axis names and sizes."""

    def __init__(self, sizes, names):
        self.axis_names = names
        self.shape = dict(zip(names, sizes))


def _meshes(layout):
    sizes, names = LAYOUTS[layout]
    return _RefMesh(sizes, names), ppar.Mesh(sizes, names)


def _preset_id(p):
    return p[0] + "-" + "-".join(f"{k}={v}" for k, v in p[1].items())


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("preset", PRESETS, ids=_preset_id)
def test_rules_dict_matches_reference(layout, preset):
    ref_mesh, mesh = _meshes(layout)
    phase, kw = preset
    want = rpar.rules_for(ref_mesh, phase, **kw)
    got = ppar.rules_for(mesh, phase, **kw)
    assert got.rules == want.rules and got.phase == want.phase
    assert got.spec("batch", "seq", "kv_heads", "head_dim") == tuple(want.spec("batch", "seq", "kv_heads", "head_dim"))
    if phase == "train":
        assert ppar.train_rules(mesh, **kw).rules == rpar.train_rules(ref_mesh, **kw).rules
    else:
        assert ppar.serve_rules(mesh, **kw).rules == rpar.serve_rules(ref_mesh, **kw).rules


def test_unknown_phase_raises_like_the_reference():
    ref_mesh, mesh = _meshes("1x1")
    with pytest.raises(ValueError, match="unknown phase"):
        rpar.rules_for(ref_mesh, "eval")
    with pytest.raises(ValueError, match="unknown phase"):
        ppar.rules_for(mesh, "eval")


def _pairs(ref_tree, port_tree, path=""):
    """(path, reference Logical, port Logical) over two spec trees of the
    same layout."""
    if isinstance(port_tree, ppar.Logical):
        assert isinstance(ref_tree, rpar.Logical), path
        yield path, ref_tree, port_tree
    elif isinstance(port_tree, dict):
        assert isinstance(ref_tree, dict) and set(ref_tree) == set(port_tree), path
        for k in port_tree:
            yield from _pairs(ref_tree[k], port_tree[k], f"{path}/{k}")
    else:
        assert len(ref_tree) == len(port_tree), path
        for i, (r, p) in enumerate(zip(ref_tree, port_tree)):
            yield from _pairs(r, p, f"{path}[{i}]")


def _leaf(tree, path):
    for part in path.strip("/").replace("[", "/[").split("/"):
        if part:
            tree = tree[int(part[1:-1])] if part.startswith("[") else tree[part]
    return tree


def _ref_tree(arch, what):
    cfg = rreg.get(arch)
    if what == "params":
        return RT.param_specs(cfg), jax.eval_shape(lambda: RT.init_params(jax.random.key(0), cfg))
    return RT.cache_specs(cfg), jax.eval_shape(lambda: RT.init_cache(cfg, 128, 32_768))


_SHAPES: dict = {}


@pytest.mark.parametrize("what", ["params", "cache"])
@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_axes_match_reference_on_every_leaf(arch, what):
    """Every leaf of the arch's spec tree, at the full config's shapes, on
    every layout and preset: the port's spec is the reference's, with the
    divisibility guard on."""
    if (arch, what) not in _SHAPES:
        _SHAPES[arch, what] = _ref_tree(arch, what)
    ref_specs, shapes = _SHAPES[arch, what]
    cfg = preg.get(arch)
    port_specs = PT.param_specs(cfg) if what == "params" else PT.cache_specs(cfg)
    pairs = list(_pairs(ref_specs, port_specs))
    assert pairs and all(r.axes == p.axes for _, r, p in pairs)
    n = 0
    for layout in LAYOUTS:
        ref_mesh, mesh = _meshes(layout)
        for phase, kw in PRESETS:
            want_rules, got_rules = rpar.rules_for(ref_mesh, phase, **kw), ppar.rules_for(mesh, phase, **kw)
            for path, r, p in pairs:
                shape = _leaf(shapes, path).shape
                want = want_rules.mesh_axes(r.axes, shape, ref_mesh)
                assert isinstance(want, P)
                assert got_rules.mesh_axes(p.axes, shape, mesh) == tuple(want), (layout, phase, kw, path)
                assert got_rules.mesh_axes(p.axes) == tuple(want_rules.mesh_axes(r.axes)), path
                n += 1
    assert n == len(pairs) * len(LAYOUTS) * len(PRESETS)


@pytest.mark.parametrize("arch", ARCHS)
def test_tree_pspecs_and_shardings_follow_the_rules(arch):
    cfg = preg.get(arch)
    ref_mesh, mesh = _meshes("16x16")
    rules, ref_rules = ppar.serve_rules(mesh), rpar.serve_rules(ref_mesh)
    specs = PT.param_specs(cfg)
    pspecs = ppar.tree_pspecs(specs, rules)
    ref_pspecs = rpar.tree_pspecs(RT.param_specs(rreg.get(arch)), ref_rules)
    assert [tuple(s) for s in jax.tree.leaves(ref_pspecs, is_leaf=lambda x: isinstance(x, P))] == \
        [s for _, s in _flat(pspecs)]
    # a same-layout tree of `.shape`s: every dim 16 divides, every dim 8 does not
    for dim, same in ((16, True), (8, False)):
        shapes = ppar.map_logical(lambda lg: types.SimpleNamespace(shape=(dim,) * len(lg.axes)), specs)
        sh = ppar.tree_shardings(specs, mesh, rules, shapes)
        for (_, spec), (_, named) in zip(_flat(pspecs), _flat(sh)):
            assert named.mesh is mesh
            assert named.spec == spec if same else all(a is None for a in named.spec)
    assert all(named.spec == spec for (_, spec), (_, named) in
               zip(_flat(pspecs), _flat(ppar.tree_shardings(specs, mesh, rules))))


def _flat(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{path}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{path}[{i}]")
    else:
        yield path, tree


def test_ranges_specs_replicate_every_leaf():
    cfg = preg.get_smoke("gemma3_1b")
    specs = PT.ranges_specs(cfg)
    rules = ppar.train_rules(ppar.Mesh((16, 16), ("data", "model")))
    pspecs = ppar.tree_pspecs(specs, rules)
    leaves = [pspecs["head"]["head_in"].a_min] + [r.count for slot in pspecs["scan"] for r in slot.values()]
    assert all(s == (None,) for s in leaves)
    ref = RT.ranges_specs(rreg.get_smoke("gemma3_1b"))
    assert len(jax.tree.leaves(ref, is_leaf=lambda x: isinstance(x, rpar.Logical))) == \
        3 * (sum(len(slot) for slot in specs["scan"] + specs["tail"]) + len(specs["head"]))


# ---- the reference's own sharding tests, ported (tests/test_sharding.py) ----


def test_adaptive_parallelism_rules_differ_by_phase():
    """FIXAR §V-B: inference emphasizes intra-layer (model-axis) splits,
    training emphasizes intra-batch (data-axis) splits."""
    mesh = pmesh.make_auto_mesh((1, 1), ("data", "model"))
    tr = ppar.train_rules(mesh)
    sv_long = ppar.serve_rules(mesh, shard_kv_seq=True)
    assert tr.rules["batch"] == "data"          # intra-batch for training
    assert tr.rules["mlp"] == "model"
    assert sv_long.rules["batch"] is None       # single request: batch idle
    assert sv_long.rules["kv_seq"] == "data"    # sequence-parallel decode
    assert sv_long.rules["mlp"] == "model"      # intra-layer split


def test_divisibility_guard_drops_axis():
    mesh = pmesh.make_auto_mesh((1, 1), ("data", "model"))

    class FakeMesh:
        shape = {"data": 16, "model": 16}

    rules = ppar.train_rules(mesh)
    assert rules.mesh_axes(("kv_heads",), shape=(1,), mesh=FakeMesh()) == tuple(P(None))
    assert rules.mesh_axes(("kv_heads",), shape=(32,), mesh=FakeMesh()) == tuple(P("model"))


# ---- constrain, meshes ------------------------------------------------------


def test_constrain_is_identity_on_one_device_and_without_a_mesh():
    x = torch.arange(24.0).reshape(2, 3, 4)
    rules = ppar.serve_rules(ppar.Mesh((1, 1), ("data", "model")))
    assert ppar.constrain(x, None, "batch", "seq", "embed") is x
    assert ppar.ambient_mesh() is None
    assert ppar.constrain(x, rules, "batch", "seq", "embed") is x
    with pmesh.mesh_context(ppar.Mesh((1, 1), ("data", "model"), ["cpu"])) as m:
        assert ppar.ambient_mesh() is m
        assert ppar.constrain(x, rules, "batch", "seq", "embed") is x
    assert ppar.ambient_mesh() is None


@pytest.mark.parametrize("layout", ["2x4", "16x16", "2x16x16"])
def test_constrain_raises_on_a_multi_device_mesh(layout):
    """A mesh of several devices with no process group behind it (a
    layout) cannot run a constraint: it raises, for a sharded spec and a
    replicated one alike, rather than leave the tensor unsharded.  (Meshes
    over a live process group: tests/test_torch_dist_cells.py.)"""
    sizes, names = LAYOUTS[layout]
    mesh = ppar.Mesh(sizes, names)
    x = torch.zeros(32, 8, 16)
    with pmesh.mesh_context(mesh):
        with pytest.raises(RuntimeError, match="no process group"):
            ppar.constrain(x, ppar.train_rules(mesh), "batch", "seq", "embed")
        # a replicated spec would still move data onto every device
        with pytest.raises(RuntimeError, match="no process group"):
            ppar.constrain(x, ppar.train_rules(mesh), None, None, None)
    inner = ppar.Mesh((1,), ("data",), ["cpu"])
    with pmesh.mesh_context(mesh), pmesh.mesh_context(inner):
        assert ppar.constrain(x, ppar.train_rules(inner), "batch", None, None) is x


def test_mesh_builders():
    prod, pod = pmesh.make_production_mesh(), pmesh.make_production_mesh(multi_pod=True)
    assert prod.shape == {"data": 16, "model": 16} and prod.size == 256
    assert pod.axis_names == ("pod", "data", "model") and pod.size == 512
    dbg = pmesh.make_debug_mesh()
    assert dbg.shape == {"data": 2, "model": 4}
    if torch.cuda.device_count() < 8:
        assert dbg.is_layout_only and prod.is_layout_only
    serve = pmesh.make_serve_mesh(device="cpu")
    assert serve.shape == {"data": 1} and serve.devices == (torch.device("cpu"),)
    assert pmesh.make_serve_mesh(2, device="cpu").size == 2
    with pytest.raises(ValueError, match="needs 4 devices"):
        ppar.Mesh((2, 2), ("data", "model"), ["cpu"])
    with pytest.raises(ValueError, match="repeated axis"):
        ppar.Mesh((2, 2), ("data", "data"))


def test_serve_mesh_needs_a_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pmesh.make_serve_mesh()


def test_core_reexports_match_reference():
    import repro.core as rcore

    names = [n for n in dir(rcore) if n in rpar.__all__]
    assert names and all(getattr(pcore, n) is getattr(ppar, n) for n in names)
