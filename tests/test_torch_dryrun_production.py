"""The production dry run on the CPU: `launch.dryrun` on the reference's
256-rank (data 16, model 16) and 512-rank (pod 2, data 16, model 16)
layouts, each over a fake world (`launch.mesh.init_fake_world`: a "fake"
process group in one process, rank 0) with every tensor fake
(`FakeTensorMode`), at the full configs.

A process holds one default process group, so each world runs in a
subprocess of its own (`_PORT`, one for 256 ranks and one for 512), beside
a third that asks the JAX reference for its layouts (`_REF`: 512 forced
host devices; `repro.launch.specs` and `NamedSharding.shard_shape` only,
no lowering, no compile).  They hold:

  * *layout parity*: for all ten archs × four shapes × both meshes, rank
    0's local shape of every leaf of the cell's arguments (train: state and
    batch; prefill: params and batch; decode: params, tokens and cache) is
    the reference's shard shape; every sharded dim divides evenly (so every
    rank holds rank 0's shapes); the per-rank argument bytes — the sum of
    the shard shapes and the bytes of the storages rank 0 holds
    (`RankTracker.hold`) — are the reference's;
  * *runs*: one cell per fault site the production layouts exposed, each
    at full width with its depth cut to one `block_pattern` period (fake
    tensors cost by depth, not width), reaches "ok" with a positive peak
    and DTensor's planner recognised (`planner_ops`):
    qwen2-0.5b decode_32k (its q and kv heads do not divide 16: the
    attention weights shard on head_dim, `layers._heads_by_rank`),
    deepseek-7b decode_32k (`layers._cache_write` at a slot, from the
    shapes), rwkv6-1.6b train_4k (the WKV recurrence per rank,
    `rwkv6._by_rank`), gemma3-1b long_500k (a sequence-sharded ring cache),
    and qwen2-0.5b train_4k on the (2, 16, 16) mesh.  The first three
    stopped on the parent's code.  And dbrx-132b train_4k (one layer) with
    its backward run where the forward's mesh is not in scope, as the
    card's autograd thread runs it: it stopped without
    `transformer._in_this_mesh`;
  * *flops*: deepseek-7b train_4k's whole-step flops (the products of all
    ranks together) equal the same step's count on one device with no
    mesh (its heads, kv heads, d_ff and vocab all divide 16, so no product
    is replicated); qwen2-0.5b's exceed it by what its layout replicates
    (14 heads: attention on every model rank), recorded, not equal.

In this process, the memory tracker gives the same record on real CPU
tensors and on fake ones for a small train cell (qwen2's smoke config,
QAT, remat "dots").
"""

import dataclasses
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401  (one intra-op thread a worker)

SRC = str(pathlib.Path(__file__).resolve().parents[1] / "src")
TIMEOUT = 600

# one cell per fault site, at one block_pattern period; the 512-rank world's
RUNS = {256: [("qwen2_0_5b", "decode_32k"), ("deepseek_7b", "decode_32k"), ("rwkv6_1_6b", "train_4k"),
              ("gemma3_1b", "long_500k")],
        512: [("qwen2_0_5b", "train_4k")]}
FLOPS = (("deepseek_7b", "train_4k"), ("qwen2_0_5b", "train_4k"))
# run with the backward outside the forward's context, as on the card (see `_PORT`)
ELSEWHERE = (("dbrx_132b", "train_4k"),)

_PORT = r"""
import dataclasses, json, sys
sys.path.insert(0, sys.argv[1])
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from repro_torch import tree
from repro_torch.configs import registry
from repro_torch.data.synthetic import DataConfig, DataIterator
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import mesh_context
from repro_torch.models.config import ALL_SHAPES
from repro_torch.optim import adam
from repro_torch.train.step import init_state, make_train_step

world, runs, flops, elsewhere = int(sys.argv[2]), json.loads(sys.argv[3]), json.loads(sys.argv[4]), \
    json.loads(sys.argv[5])
shapes = {s.name: s for s in ALL_SHAPES}
mesh = dryrun.production_mesh(multi_pod=world == 512, device="cpu")
out = {"layouts": {}, "runs": {}, "flops": {}}
for arch in registry.lm_archs():
    for shape in ALL_SHAPES:
        with FakeTensorMode(), mesh_context(mesh):
            _, args = dryrun.build_cell(registry.get(arch), shape, mesh, qat=True)
            leaves = [t for t in tree.leaves(args) if isinstance(t, torch.Tensor)]
            even = all(t.shape[p.dim] % mesh.device_mesh.size(i) == 0 for t in leaves
                       for i, p in enumerate(t.placements) if p.is_shard())
            out["layouts"][f"{arch}:{shape.name}"] = {
                "local": [list(t.to_local().shape) for t in leaves],
                "itemsize": [t.element_size() for t in leaves],
                "held": dryrun.RankTracker().hold(args), "even": even}
            del args, leaves


def cut(arch):
    cfg = registry.get(arch)
    return dataclasses.replace(cfg, n_layers=len(cfg.block_pattern))


for arch, name in runs:
    rec = dryrun.measure_cell(cut(arch), shapes[name], mesh, qat=True)
    out["runs"][f"{arch}:{name}"] = {k: rec[k] for k in ("status", "n_devices", "flops", "flops_per_rank",
                                                        "collective_bytes", "memory", "planner_ops")}
for arch, name in flops:
    cfg, shape = cut(arch), shapes[name]
    rec = dryrun.measure_cell(cfg, shape, mesh, qat=True)
    with FakeTensorMode():  # the same step on one device, no mesh
        c = dataclasses.replace(cfg, qat=True, qat_delay=10_000)
        fn = make_train_step(c, adam.AdamConfig(lr=1e-4, grad_clip_norm=1.0))
        args = (init_state(torch.Generator().manual_seed(0), c, device="cpu"),
                next(DataIterator(DataConfig(seed=0), c, shape, device="cpu")))
        plain = dryrun.measure(fn, args)
    out["flops"][f"{arch}:{name}"] = {"mesh": rec["flops"], "per_rank": rec["flops_per_rank"],
                                      "one_device": plain["flops_per_rank"]}
# On the card the autograd engine runs a CUDA backward (a checkpoint's
# recompute included) on a device thread of its own: thread-local state
# travels there, a context variable (the ambient mesh) does not.  The same
# here: the backward in an empty context.
import contextvars
_grad = torch.autograd.grad
torch.autograd.grad = lambda *a, **k: contextvars.Context().run(_grad, *a, **k)
for arch, name in elsewhere:
    rec = dryrun.measure_cell(cut(arch), shapes[name], mesh, qat=True)
    out["runs"][f"{arch}:{name}:elsewhere"] = {k: rec[k] for k in ("status", "n_devices", "flops",
                                                                   "flops_per_rank", "collective_bytes", "memory")}
torch.autograd.grad = _grad
json.dump(out, sys.stdout)
"""

_REF = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, sys.argv[1])
import json
import jax
import numpy as np
from jax.sharding import NamedSharding
from repro.configs import registry
from repro.core.parallelism import rules_for
from repro.launch import specs as S
from repro.launch.dryrun import _serve_layout_hints
from repro.launch.mesh import make_production_mesh
from repro.models.config import ALL_SHAPES

out = {}
for multi_pod in (False, True):
    mesh = make_production_mesh(multi_pod=multi_pod)
    for arch in registry.lm_archs():
        cfg = registry.get(arch)
        for shape in ALL_SHAPES:
            if shape.kind == "train":
                st_sh, b_sh = S.train_shardings(cfg, shape, mesh, rules_for(mesh, "train"))
                shards, shapes = (st_sh, b_sh), (S.state_shapes(cfg), S.input_specs(cfg, shape))
            elif shape.kind == "prefill":
                p_sh, b_sh, _ = S.serve_shardings(cfg, shape, mesh, rules_for(mesh, "serve"))
                shards, shapes = (p_sh, b_sh), (S.params_shapes(cfg), S.input_specs(cfg, shape))
            else:
                rules = rules_for(mesh, "serve", shard_kv_seq=shape.global_batch == 1,
                                  **_serve_layout_hints(cfg, mesh))
                p_sh, b_sh, c_sh = S.serve_shardings(cfg, shape, mesh, rules)
                shards = (p_sh, b_sh["tokens"], c_sh)
                shapes = (S.params_shapes(cfg), S.input_specs(cfg, shape)["tokens"],
                          S.cache_shapes(cfg, shape.global_batch, shape.seq_len))
            sh = jax.tree.leaves(shards, is_leaf=lambda x: isinstance(x, NamedSharding))
            leaves = jax.tree.leaves(shapes)
            assert len(sh) == len(leaves), (arch, shape.name)
            out[f"{512 if multi_pod else 256}:{arch}:{shape.name}"] = {
                "shard": [list(s.shard_shape(l.shape)) for s, l in zip(sh, leaves)],
                "itemsize": [np.dtype(l.dtype).itemsize for l in leaves]}
json.dump(out, sys.stdout)
"""


def _start(script, *args):
    return subprocess.Popen([sys.executable, "-c", script, SRC, *map(str, args)], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _wait(proc, what):
    try:
        out, err = proc.communicate(timeout=TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise AssertionError(f"{what} did not finish within {TIMEOUT} s")
    assert proc.returncode == 0, f"{what} failed:\n{err[-4000:]}"
    return json.loads(out)


@pytest.fixture(scope="module")
def worlds():
    ref = _start(_REF)
    port = {w: _start(_PORT, w, json.dumps(RUNS[w]), json.dumps(FLOPS if w == 256 else []),
                      json.dumps(ELSEWHERE if w == 256 else [])) for w in (256, 512)}
    got = {w: _wait(p, f"the port's {w}-rank world") for w, p in port.items()}
    return got, _wait(ref, "the reference's layouts")


@pytest.mark.parametrize("world", [256, 512])
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k", "long_500k"])
@pytest.mark.parametrize("arch", ["gemma3_1b", "internlm2_1_8b", "qwen2_0_5b", "deepseek_7b", "rwkv6_1_6b",
                                  "dbrx_132b", "moonshot_v1_16b_a3b", "phi3_vision_4_2b", "hubert_xlarge",
                                  "recurrentgemma_2b"])
def test_layout_parity(worlds, arch, shape, world):
    port, ref = worlds
    got, want = port[world]["layouts"][f"{arch}:{shape}"], ref[f"{world}:{arch}:{shape}"]
    assert got["local"] == want["shard"]
    assert got["itemsize"] == want["itemsize"]
    assert got["even"]
    ref_bytes = sum(int(np.prod(s)) * n for s, n in zip(want["shard"], want["itemsize"]))
    assert got["held"] == ref_bytes


def test_every_arch_is_laid_out(worlds):
    from repro_torch.configs import registry

    port, _ = worlds
    assert sorted({k.split(":")[0] for k in port[256]["layouts"]}) == sorted(registry.lm_archs())


@pytest.mark.parametrize("world, cell", [(w, c) for w in RUNS for c in RUNS[w]],
                         ids=[f"{w}-{a}-{s}" for w in RUNS for a, s in RUNS[w]])
def test_fault_site_cell_runs(worlds, world, cell):
    r = worlds[0][world]["runs"][":".join(cell)]
    assert r["status"] == "ok" and r["n_devices"] == world
    mem = r["memory"]
    assert mem["argument_bytes"] > 0 and mem["peak_bytes"] >= mem["argument_bytes"] + mem["output_bytes"] > 0
    assert r["flops_per_rank"] > 0 and r["flops"] == r["flops_per_rank"] * world
    assert r["collective_bytes"] and all(v > 0 for v in r["collective_bytes"].values())
    assert r["planner_ops"] > 0  # DTensor's planner recognised, its global-shape ops left out of the peak


@pytest.mark.parametrize("cell", ELSEWHERE, ids=[f"{a}-{s}" for a, s in ELSEWHERE])
def test_backward_outside_the_forward_context_runs(worlds, cell):
    """dbrx-132b's train step (the expert-parallel MoE body, remat "dots")
    with its backward run where the forward's ambient mesh is not set, as
    the card's autograd thread runs it: the recompute must re-enter the
    forward's mesh (`transformer._in_this_mesh`); without it the recompute
    took the dense MoE dispatch and stopped on a shape."""
    r = worlds[0][256]["runs"][":".join(cell) + ":elsewhere"]
    assert r["status"] == "ok" and r["memory"]["peak_bytes"] > r["memory"]["argument_bytes"] > 0


def test_whole_step_flops_against_one_device(worlds):
    f = worlds[0][256]["flops"]
    deepseek, qwen2 = f["deepseek_7b:train_4k"], f["qwen2_0_5b:train_4k"]
    assert deepseek["mesh"] == deepseek["one_device"] > 0
    # qwen2's 14 heads and 2 kv heads do not divide 16: attention runs whole on every model rank
    assert qwen2["mesh"] > qwen2["one_device"] > 0


def test_tracker_real_and_fake_agree():
    """The same small train step (qwen2 smoke, B = 2, S = 64, QAT, remat
    "dots") measured on real CPU tensors and under fake ones: the same
    argument, output and peak bytes and the same flops.  The layers'
    per-device constants (`layers._const`, `rope_freqs`) are cached by a
    real run and made anew under fake tensors; the caches are warmed first,
    so the real run holds them from before, and the fake run's peak may
    exceed the real one by at most their bytes."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs import registry
    from repro_torch.data.synthetic import DataConfig, DataIterator
    from repro_torch.launch import dryrun
    from repro_torch.models.config import ShapeConfig
    from repro_torch.optim import adam
    from repro_torch.train.step import init_state, make_train_step

    cfg = dataclasses.replace(registry.get_smoke("qwen2_0_5b"), qat=True, qat_delay=10)
    shape = ShapeConfig("t", "train", 64, 2)

    def cell():
        fn = make_train_step(cfg, adam.AdamConfig(lr=1e-4, grad_clip_norm=1.0))
        return fn, (init_state(torch.Generator().manual_seed(0), cfg, device="cpu"),
                    next(DataIterator(DataConfig(seed=0), cfg, shape, device="cpu")))

    fn, args = cell()
    fn(*args)  # warm the per-device constants
    real = dryrun.measure(*cell())
    with FakeTensorMode():
        fake = dryrun.measure(*cell())
    assert real["flops_per_rank"] == fake["flops_per_rank"] > 0
    for key in ("argument_bytes", "output_bytes"):
        assert real["memory"][key] == fake["memory"][key] > 0, key
    assert 0 <= fake["memory"]["peak_bytes"] - real["memory"]["peak_bytes"] <= 64
    assert real["memory"]["peak_bytes"] > real["memory"]["argument_bytes"] + real["memory"]["output_bytes"]
