"""Per-rank cases of the port's sharded tests (run by `_torch_dist.run_ranks`
on CPU ranks of a gloo group; each returns plain numbers and numpy arrays
for rank 0 to report).  Torch and the port only: no JAX here.

Every case builds the same full inputs on every rank from a seed, runs the
port's unsharded path on them (already held to the JAX reference by the
parity tests) and the sharded path on DTensors laid out by the rules, and
returns both sides' results, gathered whole.
"""

from __future__ import annotations

import dataclasses
import pathlib

import numpy as np
import torch

from repro_torch import tree
from repro_torch.checkpoint import ckpt
from repro_torch.configs import registry
from repro_torch.core import parallelism as par
from repro_torch.core.ranges import RangeStat
from repro_torch.data.synthetic import DataConfig, DataIterator
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as M
from repro_torch.launch import specs as S
from repro_torch.models import layers as PL
from repro_torch.models import moe as PM
from repro_torch.models import transformer as T
from repro_torch.models.config import ShapeConfig
from repro_torch.optim import adam
from repro_torch.train import step as TS


def _f32(arch: str):
    return dataclasses.replace(registry.get_smoke(arch), dtype="float32")


def _np(x) -> np.ndarray:
    x = x.full_tensor() if par.is_dtensor(x) else x
    return x.detach().cpu().numpy()


def _leaves(node) -> list:
    return [_np(t) for t in tree.leaves(node)]


def _on_rank0(rank: int, fn):
    """`fn()` on rank 0 only: the unsharded reference, which only rank 0's
    report reads (it runs no collective, so the other ranks need not wait
    for it in step)."""
    return fn() if rank == 0 else None


def _mesh(multi_pod: bool = False):
    return M.make_debug_mesh(n_model=2, multi_pod=True) if multi_pod else M.make_debug_mesh()


# ---------------------------------------------------------------------------
# meshes and placements
# ---------------------------------------------------------------------------


def mesh_guards(rank, world):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    out = {}
    try:
        M.make_debug_mesh(multi_pod=True)  # 2 x 2 x 4 = 16 ranks on a world of 8
        out["bigger_mesh"] = "no error"
    except ValueError as e:
        out["bigger_mesh"] = str(e)
    mesh = M.make_debug_mesh()
    out["device_mesh"] = tuple(mesh.device_mesh.mesh.shape)
    x = distribute_tensor(torch.zeros(8, 4, 16), mesh.device_mesh, (Shard(0), Replicate()))
    layout = M.make_production_mesh()
    try:
        with M.mesh_context(layout):
            par.constrain(x, par.train_rules(layout), "batch", "seq", "embed")
        out["layout_runs"] = "no error"
    except RuntimeError as e:
        out["layout_runs"] = str(e)
    pod = M.make_debug_mesh(n_model=2, multi_pod=True)
    rules = par.train_rules(pod)
    out["pod_placements"] = [str(p) for p in par.placements_for(pod, rules, (8, 4, 16), ("batch", "seq", "mlp"))]
    y = par.constrain(distribute_tensor(torch.arange(128.0).reshape(8, 16), pod.device_mesh, (Replicate(),) * 3),
                      rules, "batch", "mlp")
    with M.mesh_context(pod):
        y = par.constrain(y, rules, "batch", "mlp")
    out["pod_local"] = y.to_local().numpy()
    out["pod_coord"] = pod.device_mesh.get_coordinate()
    return out


# ---------------------------------------------------------------------------
# the cells of the reference's tests/test_sharding.py
# ---------------------------------------------------------------------------


def train_cell(rank, world, arch, multi_pod=False, seq=256, batch=8, steps=2, qat_delay=1, n_model=None):
    """value_and_grad at step 0 and `steps` whole train steps (QAT on, the
    quant phase from `qat_delay`, the reference's Adam config with a clip),
    sharded against unsharded: after each step the loss, clip norm,
    params, ranges and the optimizer's state (count, mu, nu).  On the debug
    mesh, or on a (world / n_model, n_model) one."""
    cfg = dataclasses.replace(_f32(arch), qat=True, qat_delay=qat_delay)
    shape = ShapeConfig("t", "train", seq, batch)
    mesh = _mesh(multi_pod) if n_model is None else M.make_debug_mesh(world // n_model, n_model)
    rules = par.train_rules(mesh)
    st_sh, b_sh = S.train_shardings(cfg, shape, mesh, rules)
    state = TS.init_state(0, cfg, device="cpu")
    dstate = par.distribute_tree(state, st_sh)
    data = DataIterator(DataConfig(seed=0), cfg, shape, device="cpu")
    first = next(data)
    phase = state.step >= cfg.qat_delay
    loss, extras, grads = _on_rank0(rank, lambda: TS.value_and_grad(cfg, state.params, state.ranges, first,
                                                                    phase)) or (None, None, None)
    with M.mesh_context(mesh):
        dloss, dextras, dgrads = TS.value_and_grad(cfg, dstate.params, dstate.ranges,
                                                   par.distribute_tree(first, b_sh), dstate.step >= cfg.qat_delay,
                                                   rules=rules)
    out = {"loss": (rank or float(loss), float(_np(dloss))),
           "grads": (rank or _leaves(grads), _leaves(dgrads)),
           "ranges": (rank or _leaves(extras["ranges"]), _leaves(dextras["ranges"])),
           "grad_placements": sorted({str(g.placements) for g in tree.leaves(dgrads)})}
    opt = adam.AdamConfig(lr=1e-4, grad_clip_norm=1.0)
    plain, sharded = TS.make_train_step(cfg, opt), TS.make_train_step(cfg, opt, rules=rules)
    out["steps"] = []
    batch_i = first
    for i in range(steps):
        state, m = _on_rank0(rank, lambda: plain(state, batch_i)) or (state, None)
        with M.mesh_context(mesh):
            dstate, dm = sharded(dstate, par.distribute_tree(batch_i, b_sh))

        def record(st, met):
            return {"loss": float(_np(met["loss"])), "grad_norm": float(_np(met["grad_norm"])),
                    "quant_phase": int(_np(met["quant_phase"])), "params": _leaves(st.params),
                    "ranges": _leaves(st.ranges), "count": int(_np(st.opt.step)), "mu": _leaves(st.opt.mu),
                    "nu": _leaves(st.opt.nu)}

        got = record(dstate, dm)
        want = _on_rank0(rank, lambda: record(state, m)) or {}
        out["steps"].append({k: (want.get(k), v) for k, v in got.items()})
        out["steps"][-1]["placements_kept"] = all(
            t.placements == sh.placements() for t, sh in zip(tree.leaves(dstate), par.sharding_leaves(st_sh)))
        batch_i = next(data)
    return out


def prefill_cell(rank, world, arch="gemma3_1b", seq=512, batch=4, n_model=None):
    """A prefill, sharded (the serve rules on the debug mesh, or on a
    (world / n_model, n_model) mesh) against unsharded."""
    cfg = _f32(arch)
    shape = ShapeConfig("p", "prefill", seq, batch)
    mesh = _mesh() if n_model is None else M.make_debug_mesh(world // n_model, n_model)
    rules = par.serve_rules(mesh)
    p_sh, b_sh, _ = S.serve_shardings(cfg, shape, mesh, rules)
    params = T.init_params(0, cfg, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq), generator=torch.Generator().manual_seed(1),
                           dtype=torch.int32)
    want = _on_rank0(rank, lambda: _np(T.prefill(params, {"tokens": tokens}, cfg)))
    with M.mesh_context(mesh):
        got = T.prefill(par.distribute_tree(params, p_sh), par.distribute_tree({"tokens": tokens}, b_sh), cfg,
                        rules=rules)
    return {"logits": (want, _np(got)), "placements": str(got.placements),
            "wq_placements": str(p_sh["scan"][0]["attn"]["wq"].placements())}


def decode_cell(rank, world, arch="rwkv6_1_6b", cache_len=512, batch=8, prompt=16, steps=2, shard_kv_seq=False,
                n_model=None, row_offsets=None):
    """A prompt prefilled into a `cache_len` cache, then `steps` greedy
    decode steps, sharded (the decode rules with the reference's layout
    hints, and its sequence-parallel cache when `shard_kv_seq`; on the
    debug mesh or a (world / n_model, n_model) one) against unsharded.
    With `row_offsets` (one int a row) the steps decode at per-row
    positions, row b at prompt + i + row_offsets[b] (continuous batching's
    (B,) position tensor; the slots a row skips stay empty)."""
    cfg = _f32(arch)
    shape = ShapeConfig("d", "decode", cache_len, batch)
    mesh = _mesh() if n_model is None else M.make_debug_mesh(world // n_model, n_model)
    rules = par.serve_rules(mesh, shard_kv_seq=shard_kv_seq, **dryrun._serve_layout_hints(cfg, mesh))
    p_sh, b_sh, c_sh = S.serve_shardings(cfg, shape, mesh, rules)
    params = T.init_params(0, cfg, device="cpu")
    dparams = par.distribute_tree(params, p_sh)
    tokens = torch.randint(0, cfg.vocab_size, (batch, prompt), generator=torch.Generator().manual_seed(2),
                           dtype=torch.int32)
    cache = T.init_cache(cfg, batch, cache_len, device="cpu")
    dcache = par.distribute_tree(T.init_cache(cfg, batch, cache_len, device="cpu"), c_sh)
    tok_sh = par.NamedSharding(mesh, rules.mesh_axes(("batch", "seq"), (batch, prompt), mesh))
    want = _on_rank0(rank, lambda: T.prefill(params, {"tokens": tokens}, cfg, cache=cache)[0])
    with M.mesh_context(mesh):
        got, dcache = T.prefill(dparams, {"tokens": par.distribute_tree(tokens, tok_sh)}, cfg, rules=rules,
                                cache=dcache)
    got = _np(got)
    logits = [(None if want is None else _np(want), got)]
    for i in range(steps):
        tok = torch.from_numpy(got.argmax(-1)[:, None].astype(np.int32))  # the sharded path's greedy token
        pos = prompt + i if row_offsets is None else torch.tensor(row_offsets) + (prompt + i)
        want = _on_rank0(rank, lambda: T.decode_step(params, tok, cache, pos, cfg)[0][:, -1])
        with M.mesh_context(mesh):
            got, dcache = T.decode_step(dparams, par.distribute_tree({"tokens": tok}, b_sh)["tokens"], dcache,
                                        pos, cfg, rules=rules)
        got = _np(got)[:, -1]
        logits.append((None if want is None else _np(want), got))
    state_placements = sorted({str(t.placements) for t in tree.leaves(dcache)})
    return {"logits": logits, "cache": (rank or _leaves(cache), _leaves(dcache)), "state_placements": state_placements,
            "cache_placements": [tuple(str(p) for p in t.placements) for t in tree.leaves(dcache)]}


# ---------------------------------------------------------------------------
# the dry-run cells
# ---------------------------------------------------------------------------


def dryrun_cell(rank, world, arch, kind, seq, batch, repeat=1):
    """The cell as the CLI runs it on the debug mesh (real tensors); run
    `repeat` times, the last reported (after the first, the per-device
    constants the layers cache exist before the step, as under fake
    tensors, which never cache them, they are made and freed within it)."""
    for _ in range(repeat):
        rec = dryrun.run_cell(arch, ShapeConfig(kind[0], kind, seq, batch), multi_pod=False, qat=True,
                              debug_mesh=True, smoke=True)
    return {k: rec[k] for k in ("status", "n_devices", "flops", "flops_per_rank", "collective_bytes",
                                "collective_counts", "memory", "planner_ops")}


# ---------------------------------------------------------------------------
# the expert-parallel MoE body
# ---------------------------------------------------------------------------


def moe_inputs(cfg, batch, seq, seed=0):
    """The MoE body's inputs (numpy), shared with the reference's run."""
    rng = np.random.default_rng(seed)
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {"router": rng.uniform(-d ** -0.5, d ** -0.5, (d, e)).astype(np.float32),
         "wg": rng.uniform(-d ** -0.5, d ** -0.5, (e, d, f)).astype(np.float32),
         "wu": rng.uniform(-d ** -0.5, d ** -0.5, (e, d, f)).astype(np.float32),
         "wd": rng.uniform(-f ** -0.5, f ** -0.5, (e, f, d)).astype(np.float32)}
    x = rng.standard_normal((batch, seq, d)).astype(np.float32)
    return x, p


def _qat_stats(sites, lo=-2.0, hi=2.0):
    return {s: RangeStat(torch.tensor(lo), torch.tensor(hi), torch.tensor(1, dtype=torch.int32)) for s in sites}


def _place_moe(cfg, mesh, rules, x, p):
    sh = par.tree_shardings(PM.moe_specs(cfg), mesh, rules, shape_tree=p)
    xs = par.NamedSharding(mesh, rules.mesh_axes(("batch", "seq", "embed"), x.shape, mesh))
    return par.distribute_tree(x, xs), par.distribute_tree(p, sh)


def moe_body(rank, world, arch, batch, seq, quant_phase):
    """`_moe_forward_sharded` on the debug mesh with QAT on, and the
    routing of each data shard (`route` at the per-shard capacity)."""
    cfg = _f32(arch)
    x, p = moe_inputs(cfg, batch, seq)
    x, p = torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in p.items()}
    mesh = _mesh()
    rules = par.train_rules(mesh)
    dx, dp = _place_moe(cfg, mesh, rules, x, p)
    qat = PL.LayerQAT(_qat_stats(("router_in", "expert_in", "expert_down_in")), torch.tensor(quant_phase))
    with M.mesh_context(mesh), par.sharded_scope():
        y, aux = PM._moe_forward_sharded(dx, dp, cfg, rules, qat, mesh)
    stats = {k: (float(_np(v.a_min)), float(_np(v.a_max)), int(_np(v.count))) for k, v in qat.collect().items()}
    n_shards = mesh.shape["data"]
    c_local = PM.capacity(batch * seq // n_shards, cfg)

    def routing():  # each data shard's, on the token stream the body saw
        q_ref = PL.LayerQAT(_qat_stats(("router_in", "expert_in")), torch.tensor(quant_phase))
        xq = q_ref.site("expert_in", q_ref.site("router_in", x))
        return [{k: r[k].numpy() for k in ("experts", "pos", "keep")}
                for r in (PM.route(shard.reshape(-1, cfg.d_model), p["router"], cfg, c_local)
                          for shard in xq.chunk(n_shards, 0))]

    return {"y": _np(y), "aux": float(_np(aux)), "stats": stats, "routing": _on_rank0(rank, routing), "c_local": c_local}


def moe_selected(rank, world, arch="dbrx_132b", batch=2, seq=PM.SHARDED_MIN_TOKENS // 2):
    """`moe_forward` at 65,536 tokens on the debug mesh (QAT off) takes the
    expert-parallel path: bitwise the body called directly, and against
    the unsharded dense dispatch on the tokens whose keep flags agree."""
    from torch.distributed.tensor.debug import CommDebugMode

    cfg = _f32(arch)
    x, p = moe_inputs(cfg, batch, seq, seed=3)
    x, p = torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in p.items()}
    mesh = _mesh()
    rules = par.train_rules(mesh)
    dx, dp = _place_moe(cfg, mesh, rules, x, p)
    none = PL.LayerQAT(None, None)
    with M.mesh_context(mesh), par.sharded_scope():
        with CommDebugMode() as comm:
            y, aux = PM.moe_forward(dx, dp, cfg, rules, none)
        y_body, _ = PM._moe_forward_sharded(dx, dp, cfg, rules, none, mesh)
    y, y_body = _np(y), _np(y_body)
    out = {"y": y, "y_body": y_body, "counts": {str(k).split(".")[-1]: v for k, v in comm.get_comm_counts().items()}}
    if rank == 0:  # the unsharded dense dispatch, and where the two capacities keep the same pairs
        out["want"] = PM.moe_forward(x, p, cfg, None, none)[0].numpy()
        r_all = PM.route(x.reshape(-1, cfg.d_model), p["router"], cfg)
        c_local = PM.capacity(batch * seq // mesh.shape["data"], cfg)
        keep_local = torch.cat([PM.route(s.reshape(-1, cfg.d_model), p["router"], cfg, c_local)["keep"]
                                for s in x.chunk(mesh.shape["data"], 0)])
        out["same_keep"] = (keep_local == r_all["keep"]).all(-1).numpy()
    return out


def moe_plain_input(rank, world, arch="dbrx_132b"):
    """`moe_forward` given plain tensors at 65,536 tokens on a live mesh of
    8 ranks, (data 2, model 4) and (data 8, model 1): the expert-parallel
    path is selected and refuses them (the errors' texts)."""
    cfg = _f32(arch)
    x, p = moe_inputs(cfg, 1, PM.SHARDED_MIN_TOKENS)
    x, p = torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in p.items()}
    out = {}
    for n_data, n_model in ((2, 4), (8, 1)):
        mesh = M.make_debug_mesh(n_data, n_model)
        try:
            with M.mesh_context(mesh):
                PM.moe_forward(x, p, cfg, par.train_rules(mesh), PL.LayerQAT(None, None))
            out[(n_data, n_model)] = "no error"
        except ValueError as e:
            out[(n_data, n_model)] = str(e)
    return out


def moe_grads(rank, world, arch="dbrx_132b", batch=8, seq=64):
    """Gradients through the expert-parallel body (QAT off) against the
    plain computation of its semantics: the dense dispatch on each data
    shard's tokens (capacity per shard), the balance losses averaged."""
    cfg = _f32(arch)
    x, p = moe_inputs(cfg, batch, seq, seed=4)
    x, p = torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in p.items()}
    w = torch.from_numpy(np.random.default_rng(5).standard_normal((batch, seq, cfg.d_model)).astype(np.float32))
    mesh = _mesh()
    rules = par.train_rules(mesh)
    none = PL.LayerQAT(None, None)

    def plain():
        xs = x.clone().requires_grad_(True)
        ps = {k: v.clone().requires_grad_(True) for k, v in p.items()}
        ys, auxs = zip(*(PM._moe_forward_dense(xi, ps, cfg, None, none) for xi in xs.chunk(mesh.shape["data"], 0)))
        y_plain, aux_plain = torch.cat(ys), torch.stack(auxs).mean()
        loss = (y_plain * w).sum() + 0.5 * aux_plain
        grads = torch.autograd.grad(loss, [xs, *ps.values()])
        return float(loss), y_plain.detach().numpy(), float(aux_plain), [g.numpy() for g in grads]

    loss, y_plain, aux_plain, want = _on_rank0(rank, plain) or (None,) * 4

    dx, dp = _place_moe(cfg, mesh, rules, x, p)
    dx = dx.detach().requires_grad_(True)
    dp = {k: v.detach().requires_grad_(True) for k, v in dp.items()}
    with M.mesh_context(mesh), par.sharded_scope():
        y, aux = PM._moe_forward_sharded(dx, dp, cfg, rules, none, mesh)
        dw = par.distribute_tree(w, par.NamedSharding(mesh, tuple(
            rules.mesh_axes(("batch", "seq", "embed"), w.shape, mesh))))
        dloss = (y * dw).sum() + 0.5 * aux
        got = torch.autograd.grad(dloss, [dx, *dp.values()])
    return {"loss": (loss, float(_np(dloss))), "y": (y_plain, _np(y)), "aux": (aux_plain, float(_np(aux))),
            "grads": (want, [_np(g) for g in got]), "names": ["x", *p]}


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def ckpt_elastic(rank, world, directory):
    """A train state saved from the 8-rank debug mesh (gathered, written
    once) restores onto meshes of 8, 4, 2 and 1 ranks, bitwise."""
    from torch.distributed.device_mesh import DeviceMesh

    cfg = dataclasses.replace(registry.get_smoke("demo_100m"), qat=True, qat_delay=1)
    shape = ShapeConfig("t", "train", 64, 8)
    mesh = _mesh()
    rules = par.train_rules(mesh)
    st_sh, b_sh = S.train_shardings(cfg, shape, mesh, rules)
    state = TS.init_state(0, cfg, device="cpu")
    dstate = par.distribute_tree(state, st_sh)
    step = TS.make_train_step(cfg, adam.AdamConfig(lr=1e-3, grad_clip_norm=1.0), rules=rules)
    data = DataIterator(DataConfig(seed=0), cfg, shape, device="cpu")
    with M.mesh_context(mesh):
        for _ in range(2):
            dstate, _ = step(dstate, par.distribute_tree(next(data), b_sh))
    full = _leaves(dstate)
    directory = pathlib.Path(directory)
    path = ckpt.save(directory, 2, dstate, extra={"arch": cfg.name})
    writer = ckpt.AsyncCheckpointer(directory / "async")
    writer.save(2, dstate)
    writer.close()
    out = {"written": sorted(p.name for p in directory.iterdir()), "path": str(path)}
    for n, shape_n in ((8, (2, 4)), (4, (2, 2)), (2, (1, 2)), (1, (1, 1))):
        sub = DeviceMesh("cpu", torch.arange(n).reshape(shape_n), mesh_dim_names=("data", "model"))
        if rank >= n:
            continue
        m = par.Mesh(shape_n, ("data", "model"), ["cpu"] * n, device_mesh=sub)
        sh, _ = S.train_shardings(cfg, shape, m, par.train_rules(m))
        got, at, extra = ckpt.restore(directory, state, shardings=sh)
        got_async, _, _ = ckpt.restore(directory / "async", state, shardings=sh)
        out[n] = {"step": at, "extra": extra,
                  "bitwise": all(np.array_equal(a, b) for a, b in zip(full, _leaves(got))),
                  "async_bitwise": all(np.array_equal(a, b) for a, b in zip(full, _leaves(got_async))),
                  "placements": sorted({str(t.placements) for t in tree.leaves(got)})}
    return out
