"""Launch wrappers for the fused whole-network MLP kernels.

* `fxp_mlp_fwd_cuda` — kernel B, the forward (`csrc/fxp_mlp_fwd.cu`;
  replaces `repro.kernels.fxp_mlp.kernel.fxp_mlp_pallas` → `_mlp_kernel`),
  with or without the training residuals.  A thread-block cluster per
  block of rows, the layers' columns split over its blocks, persistent
  clusters striding over the row blocks; `mlp_plan` is its launch plan
  (pure Python).  It returns one row of range monitors per cluster,
  (`monitor_rows(m, dims)`, L), which `ops.fxp_mlp_forward` reduces.
* `fxp_mlp_bwd_cuda` — kernel 3, the backward (`csrc/fxp_mlp_bwd.cu`;
  replaces `fxp_mlp_bwd_pallas` → `_mlp_bwd_kernel`): dx, dW and db from
  the forward's residuals, in two CUDA launches, both deterministic: the
  chain on the same weight-split clusters as kernels 4 + 5, whose backward
  code it shares (`csrc/fxp_bwd_slices.cuh`; `bwd_plan` is its launch
  plan, pure Python), then the dW/db reduction over rows.
* `ddpg_critic_step_cuda` / `ddpg_actor_step_cuda` — kernels 4 and 5, the
  whole DDPG update (`csrc/fxp_ddpg_step.cu`; replace
  `ddpg_critic_step_pallas` → `_ddpg_critic_step_kernel` and
  `ddpg_actor_step_pallas` → `_ddpg_actor_step_kernel`): forwards,
  cotangent chain, dW/db, Adam and the Polyak update, deterministic.  The
  chain runs on thread-block clusters with the nets' weight slices
  resident, as kernel B's forward, and carries the backward on the same
  slices; `step_plan` is its launch plan (pure Python), one row of
  monitors and loss partials per cluster (`step_monitor_rows`).  Kernel 4
  is three CUDA launches (its target pass, its critic pass, then the
  reduction and optimizer over parameter tiles), kernel 5 two.  Bound
  ≈ 4.0 / 3.5 µs (f32 operations, monitor phase, B = 128); design in the
  source's header.

All take unpadded CUDA tensors, launch on PyTorch's current stream without
synchronising, and count their calls in `<wrapper>.launches` (one per
call; the backward's calls are two CUDA launches, the steps' three and
two).
They never fall back: a tensor a kernel does not take, or a refused
launch, raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Sequence

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._compat import round_up
from repro_torch.kernels.fxp_matmul.kernel import ACTIVATION_CODES
from repro_torch.kernels.fxp_mlp.ref import HYPER_LEN

Tensor = torch.Tensor

LIB = "fxp_mlp_fwd"
LIB_BWD = "fxp_mlp_bwd"
LIB_STEP = "fxp_ddpg_step"
STEP_MAX_LAYERS = 4  # csrc/fxp_ddpg_step.cu MAX_LAYERS
MAX_LAYERS = 8  # csrc/fxp_mlp_{fwd,bwd}.cu MAX_LAYERS
MAX_SMEM = 232448  # bytes of shared memory a block may use on sm_90


# Clusters of C blocks an H100 runs at once with kernel B's shared memory
# (cudaOccupancyMaxActiveClusters on an H100 80GB HBM3: its GPCs hold 15
# clusters of 8, not 132 // 8 = 16; `chip_smoke.py` reports the query).
CLUSTER_SLOTS = {4: 30, 8: 15, 16: 7}
STATIC_SMEM = 1024  # csrc/fxp_{mlp_fwd,ddpg_step}.cu STATIC_SMEM: kept back for static shared memory
KSPLIT_MAX_N = 8  # a layer this narrow sums K slices across the cluster


def row_block(m: int) -> int:
    """Rows per block: 8, or 1 for a single row (the kernel's two
    instantiations)."""
    return 1 if m == 1 else 8


def slice_width(d: int, c: int) -> int:
    """Columns of a width-d vector each of c blocks owns: ⌈d / c⌉ rounded
    up to 4 (16-byte rows); the last slices are shorter or empty."""
    return round_up(-(-d // c), 4)


class MlpPlan(NamedTuple):
    """Kernel B's launch plan (csrc/fxp_mlp_fwd.cu's header): rows per
    block, blocks per cluster, clusters in the grid, whether the weights
    are resident in shared memory, which layers split K, how many copies of
    the whole-input limb buffers a block keeps, and the shared-memory
    layout in floats (smem in bytes)."""

    bm: int
    cluster: int
    n_clusters: int
    resident: bool
    ksplit: tuple
    kmax: int
    smax: int
    pmax: int
    nbuf: int
    w_off: tuple
    full_off: int
    act_off: int
    part_off: int
    smem: int


def tma_rows(k: int) -> int:
    """Rows of one tensor box of a column-split W slice: ⌈K/256⌉ boxes of
    ⌈K / boxes⌉ rows rounded up to 8 (csrc/fxp_mlp_fwd.cu tma_rows)."""
    boxes = -(-k // 256)
    return round_up(-(-k // boxes), 8)


def _w_extent(k: int, n: int, c: int, ksplit: bool) -> int:
    """Floats of a block's resident W slice, 128-byte aligned."""
    floats = slice_width(k, c) * n if ksplit else -(-k // 256) * tma_rows(k) * slice_width(n, c)
    return round_up(floats, 32)


def _layout(bm: int, c: int, dims: Sequence[int], resident: bool, nbuf: int) -> MlpPlan:
    layers = list(zip(dims[:-1], dims[1:]))
    ksplit = tuple(n <= KSPLIT_MAX_N for _, n in layers)
    w_off, end = [], 0
    for (k, n), ks in zip(layers, ksplit):
        w_off.append(end)
        if resident:
            end += _w_extent(k, n, c, ks)
    kmax = round_up(max(dims[:-1]), 4)
    smax = max(slice_width(d, c) for d in dims)
    pmax = round_up(max([n for (_, n), ks in zip(layers, ksplit) if ks], default=0), 4)
    full_off = end
    act_off = full_off + nbuf * 2 * bm * kmax
    part_off = act_off + bm * smax
    smem = 4 * (part_off + 2 * bm * pmax)
    return MlpPlan(bm, c, 0, resident, ksplit, kmax, smax, pmax, nbuf, tuple(w_off), full_off, act_off, part_off,
                   smem)


def mlp_plan(m: int, dims: Sequence[int]) -> MlpPlan:
    """The launch plan of kernel B for m rows through an MLP of widths
    `dims` — FIXAR's adaptive parallelism: while the row blocks fit one wave
    of clusters of 8 blocks, each layer is split 8 ways (intra-layer);
    beyond, into 4 ways over twice as many clusters (intra-batch).  Weights
    resident in shared memory where their slices fit (else clusters of 16,
    else W read from L2 in clusters of 8), two copies of the input buffers
    where they fit, else one; as many clusters as the card holds at once
    (`CLUSTER_SLOTS`), or one per row block.  Raises for the shapes the
    kernel does not take: the widths whose three row-block buffers
    (3 · bm · max(dims) floats) exceed a block's shared memory."""
    if m < 1 or len(dims) < 2 or min(dims) < 1:
        raise ValueError(f"no plan for {m} rows through {list(dims)}")
    bm = row_block(m)
    if 3 * bm * max(dims) * 4 > MAX_SMEM:
        raise ValueError(f"layer width {max(dims)} needs {3 * bm * max(dims) * 4} B of shared memory (> {MAX_SMEM})")
    n_rb = -(-m // bm)
    limit = MAX_SMEM - STATIC_SMEM
    widths = (8, 16) if n_rb <= CLUSTER_SLOTS[8] else (4, 8, 16)
    candidates = [(True, c) for c in widths] + [(False, 8)]
    layouts = (_layout(bm, c, dims, resident, nbuf) for resident, c in candidates for nbuf in (2, 1))
    plan = next((p for p in layouts if p.smem <= limit), None)
    if plan is None:
        raise AssertionError(f"no kernel B layout fits for {list(dims)}")
    return plan._replace(n_clusters=min(n_rb, CLUSTER_SLOTS[plan.cluster]))


def monitor_rows(m: int, dims: Sequence[int]) -> int:
    """Rows of kernel B's mins/maxs outputs for m rows through `dims`: one
    per cluster of the grid."""
    return mlp_plan(m, dims).n_clusters


class StepPlan(NamedTuple):
    """The launch plan of one chain pass of kernels 4 and 5
    (csrc/fxp_ddpg_step.cu's header): rows per block, blocks per cluster,
    clusters in the grid, whether the weights are resident in shared
    memory, the copies of the limb buffers, the row strides (kmax the whole
    layer input, smax a slice, pmax a K-split layer's outputs, rmax a
    reduction's rows, gmax a cotangent share), per net and layer whether it
    splits K, and the shared-memory layout in floats: the W slices, the
    limb buffers (which the backward's reductions reuse), the K-split
    partials, two cotangent buffers, each layer input's own slice (and the
    last output's, x_off[L]) and each K-split layer's whole output
    (hf_off, -1 where none); smem in bytes."""

    bm: int
    cluster: int
    n_clusters: int
    resident: bool
    nbuf: int
    kmax: int
    smax: int
    pmax: int
    rmax: int
    gmax: int
    ksplit: tuple
    w_off: tuple
    x_off: tuple
    hf_off: tuple
    full_off: int
    part_off: int
    g_off: tuple
    smem: int


# The nets each chain pass keeps resident, in order: kernel 4's target pass
# (target actor, target critic) and its critic pass, kernel 5's pass.
STEP_NETS = {"target": ("actor", "critic"), "critic": ("critic",), "actor": ("actor", "critic")}
STEP_ROWS = (8, 16)  # rows per block the kernel is built for


def _step_layout(bm: int, c: int, nets: Sequence[Sequence[int]], resident: bool, nbuf: int) -> StepPlan:
    ksplit = tuple(tuple(n <= KSPLIT_MAX_N for n in dims[1:]) for dims in nets)
    all_dims = [d for dims in nets for d in dims]
    kmax = round_up(max(d for dims in nets for d in dims[:-1]), 4)
    smax = max(slice_width(d, c) for d in all_dims)
    pmax = round_up(max([n for dims, ks in zip(nets, ksplit) for n, k in zip(dims[1:], ks) if k], default=0), 4)
    rmax = gmax = max(smax, pmax)
    end, w_off = 0, []
    for dims, ks in zip(nets, ksplit):
        offs = []
        for (k, n), split in zip(zip(dims[:-1], dims[1:]), ks):
            offs.append(end)
            if resident:
                end += _w_extent(k, n, c, split)
        w_off.append(tuple(offs))
    full_off = end
    end += max(nbuf * 2 * bm * kmax, 2 * c * bm * rmax)
    part_off = end
    end += 2 * bm * pmax
    g_off = (end, end + bm * gmax)
    end += 2 * bm * gmax
    x_off, hf_off = [], []
    for dims, ks in zip(nets, ksplit):
        xs, hs = [], []
        for d in dims:
            xs.append(end)
            end += bm * slice_width(d, c)
        for split in ks:
            hs.append(end if split else -1)
            end += bm * pmax if split else 0
        x_off.append(tuple(xs))
        hf_off.append(tuple(hs))
    return StepPlan(bm, c, 0, resident, nbuf, kmax, smax, pmax, rmax, gmax, ksplit, tuple(w_off), tuple(x_off),
                    tuple(hf_off), full_off, part_off, g_off, 4 * end)


def _step_refused(actor_dims: Sequence[int], critic_dims: Sequence[int], which: str) -> int:
    """Shared-memory bytes the chain pass kernels 4 and 5 had before
    clusters (8 rows a block, W from L2) asked for; they refused a shape past
    MAX_SMEM.  Kernel 4 (passes "target" and "critic") and kernel 5."""
    maxw = max(*actor_dims, *critic_dims)
    c0 = critic_dims[0]
    if which == "actor":
        floats = c0 + 2 * maxw + sum(actor_dims[1:-1]) + sum(critic_dims[1:])
    else:
        floats = 2 * c0 + 4 * maxw + sum(critic_dims[1:])
    return 8 * floats * 4  # 8 rows a block


def step_plan(m: int, actor_dims: Sequence[int], critic_dims: Sequence[int], which: str) -> StepPlan:
    """The launch plan of one chain pass of kernels 4 and 5 (`_step_plan`),
    kept per shape: the wrappers ask for it at every update."""
    return _step_plan(int(m), tuple(map(int, actor_dims)), tuple(map(int, critic_dims)), which)


@functools.lru_cache(maxsize=256)
def _step_plan(m: int, actor_dims: tuple, critic_dims: tuple, which: str) -> StepPlan:
    """The launch plan of one chain pass of kernels 4 and 5 for a batch of m
    rows (`which`: "target" or "critic", kernel 4's two passes; "actor",
    kernel 5's).  Each row block runs on a thread-block cluster whose
    blocks split every layer's columns (N > 8) or K (N ≤ 8), the pass's
    nets resident in shared memory.  Prefers the plan that runs every row
    block in one wave of clusters (`CLUSTER_SLOTS`) with the fewest rows
    and blocks: 8 rows on clusters of 8, of 4, then 16 rows on clusters of
    8, of 4, then clusters of 16; else the fewest waves of persistent
    clusters.  Where no resident layout fits, the streamed-W instance of
    the same kernel (W read from L2) on clusters of 8.  Raises ValueError
    for the shapes the kernel takes no more than before: a batch of 0, an
    empty layer, more than STEP_MAX_LAYERS layers, a critic input that is
    not (obs, action), or widths whose row-block buffers the kernels
    without clusters could not hold (`_step_refused`)."""
    if which not in STEP_NETS:
        raise ValueError(f"unknown chain pass {which!r}; expected one of {list(STEP_NETS)}")
    a, cr = list(actor_dims), list(critic_dims)
    if (m < 1 or len(a) != len(cr) or not 2 <= len(a) <= STEP_MAX_LAYERS + 1 or min(a + cr) < 1
            or cr[0] != a[0] + a[-1]):
        raise ValueError(f"no plan for {m} rows through actor {a} and critic {cr}")
    need = _step_refused(a, cr, "actor" if which == "actor" else "critic")
    if need > MAX_SMEM:
        raise ValueError(f"layer widths need {need} B of shared memory (> {MAX_SMEM})")
    nets = [a if name == "actor" else cr for name in STEP_NETS[which]]
    limit = MAX_SMEM - STATIC_SMEM
    order = [(8, 8), (8, 4), (16, 8), (16, 4), (8, 16), (16, 16)]
    fits = []
    for bm, c in order:
        layout = next((p for p in (_step_layout(bm, c, nets, True, nbuf) for nbuf in (2, 1)) if p.smem <= limit),
                      None)
        if layout is not None:
            fits.append(layout._replace(n_clusters=min(-(-m // bm), CLUSTER_SLOTS[c])))
    if fits:
        def waves(p: StepPlan) -> int:  # row blocks a cluster walks
            return -(-(-(-m // p.bm)) // p.n_clusters)

        return min(fits, key=waves)  # the first of the fewest waves
    plan = next((p for p in (_step_layout(8, 8, nets, False, nbuf) for nbuf in (2, 1)) if p.smem <= limit), None)
    if plan is None:
        raise AssertionError(f"no kernel 4/5 layout fits for actor {a}, critic {cr}")
    return plan._replace(n_clusters=min(-(-m // 8), CLUSTER_SLOTS[8]))


def step_monitor_rows(m: int, actor_dims: Sequence[int], critic_dims: Sequence[int], which: str) -> int:
    """Rows of a chain pass's mins/maxs and loss partials: one per cluster
    (kernel 4's come from its "critic" pass, kernel 5's from "actor")."""
    return step_plan(m, actor_dims, critic_dims, which).n_clusters


class BwdPlan(NamedTuple):
    """Kernel 3's launch plan (csrc/fxp_mlp_bwd.cu's header): rows per
    block, blocks per cluster, clusters in the grid, whether the weights are
    resident in shared memory, the row strides (smax a slice, pmax a K-split
    layer's outputs, rmax a reduction's rows, gmax a cotangent buffer's),
    per layer whether it splits K, and the shared-memory layout in floats:
    the W slices, the receive rows (two sets of C·bm rows, by reduction
    parity), two cotangent buffers, each layer input's own slice (and the
    last output's, x_off[L]) and each K-split layer's whole output (hf_off,
    -1 where none); smem in bytes."""

    bm: int
    cluster: int
    n_clusters: int
    resident: bool
    smax: int
    pmax: int
    rmax: int
    gmax: int
    ksplit: tuple
    w_off: tuple
    x_off: tuple
    hf_off: tuple
    full_off: int
    g_off: tuple
    smem: int


BWD_ROWS = {True: (8, 16), False: (8, 4)}  # rows per block the chain kernel is built for, resident W or not


def _bwd_layout(bm: int, c: int, dims: Sequence[int], resident: bool) -> BwdPlan:
    layers = list(zip(dims[:-1], dims[1:]))
    ksplit = tuple(n <= KSPLIT_MAX_N for _, n in layers)
    smax = max(slice_width(d, c) for d in dims)
    pmax = round_up(max([n for (_, n), k in zip(layers, ksplit) if k], default=0), 4)
    rmax = gmax = max(smax, pmax)
    end, w_off = 0, []
    for (k, n), split in zip(layers, ksplit):
        w_off.append(end)
        if resident:
            end += _w_extent(k, n, c, split)
    full_off = end
    end += 2 * c * bm * rmax
    g_off = (end, end + bm * gmax)
    end += 2 * bm * gmax
    x_off = []
    for d in dims:
        x_off.append(end)
        end += bm * slice_width(d, c)
    hf_off = []
    for split in ksplit:
        hf_off.append(end if split else -1)
        end += bm * pmax if split else 0
    return BwdPlan(bm, c, 0, resident, smax, pmax, rmax, gmax, ksplit, tuple(w_off), tuple(x_off), tuple(hf_off),
                   full_off, g_off, 4 * end)


def bwd_plan(m: int, dims: Sequence[int]) -> BwdPlan:
    """The launch plan of kernel 3 for m rows through an MLP of widths
    `dims` (`_bwd_plan`), kept per shape: the wrapper asks for it at every
    backward."""
    return _bwd_plan(int(m), tuple(map(int, dims)))


@functools.lru_cache(maxsize=256)
def _bwd_plan(m: int, dims: tuple) -> BwdPlan:
    """The launch plan of kernel 3's chain pass: each row block on a
    thread-block cluster whose blocks split every layer's columns (N > 8)
    or K (N ≤ 8), the net's W slices resident in shared memory.  As
    `step_plan`: prefers the plan that runs every row block in one wave of
    clusters (`CLUSTER_SLOTS`) with the fewest rows and blocks — 8 rows on
    clusters of 8, of 4, then 16 rows on clusters of 8, of 4, then clusters
    of 16 — else the fewest waves of persistent clusters.  Where no
    resident layout fits, the streamed-W instance of the same kernel (W
    read from L2) on clusters of 8, with 8 rows or, for the widest nets, 4.
    Raises ValueError for the shapes the kernel takes no more than before:
    a batch of 0, an empty layer, more than MAX_LAYERS layers, or a width
    whose two 8-row buffers (2 · 8 · max(dims) floats) exceed a block's
    shared memory."""
    if m < 1 or not 2 <= len(dims) <= MAX_LAYERS + 1 or min(dims) < 1:
        raise ValueError(f"no plan for {m} rows through {list(dims)}")
    need = 2 * 8 * max(dims) * 4
    if need > MAX_SMEM:
        raise ValueError(f"layer width {max(dims)} needs {need} B of shared memory (> {MAX_SMEM})")
    limit = MAX_SMEM - STATIC_SMEM
    order = [(8, 8), (8, 4), (16, 8), (16, 4), (8, 16), (16, 16)]
    fits = [p._replace(n_clusters=min(-(-m // p.bm), CLUSTER_SLOTS[p.cluster]))
            for p in (_bwd_layout(bm, c, dims, True) for bm, c in order) if p.smem <= limit]
    if fits:
        def waves(p: BwdPlan) -> int:  # row blocks a cluster walks
            return -(-(-(-m // p.bm)) // p.n_clusters)

        return min(fits, key=waves)  # the first of the fewest waves
    plan = next((p for p in (_bwd_layout(bm, 8, dims, False) for bm in BWD_ROWS[False]) if p.smem <= limit), None)
    if plan is None:
        raise AssertionError(f"no kernel 3 layout fits for {list(dims)}")
    return plan._replace(n_clusters=min(-(-m // plan.bm), CLUSTER_SLOTS[8]))


def _c_bwd_plan(plan: BwdPlan, weights) -> ctypes.Array:
    """A plan as the ints the launch function reads, with each layer's bulk
    flag (as `_c_step_plan`)."""
    bulk = [int(plan.resident and w.shape[1] % 4 == 0 and w.data_ptr() % 16 == 0
                and (k or slice_width(int(w.shape[1]), plan.cluster) <= 256)) for w, k in zip(weights, plan.ksplit)]
    ints = [plan.bm, plan.cluster, plan.n_clusters, int(plan.resident), plan.smax, plan.pmax, plan.rmax, plan.gmax,
            plan.full_off, *plan.g_off, plan.smem, *map(int, plan.ksplit), *bulk, *plan.w_off, *plan.x_off,
            *plan.hf_off]
    return (ctypes.c_int * len(ints))(*ints)


def _c_step_plan(plan: StepPlan, trees) -> ctypes.Array:
    """A plan as the ints the launch function reads, with each layer's bulk
    flag (its resident slice loads with bulk copies: W's width a multiple
    of 4, W 16-byte aligned, a tensor box at most 256 columns wide)."""
    head = [plan.bm, plan.cluster, plan.n_clusters, int(plan.resident), plan.nbuf, plan.kmax, plan.smax, plan.pmax,
            plan.rmax, plan.gmax, plan.full_off, plan.part_off, *plan.g_off, plan.smem, len(plan.ksplit)]
    body = []
    for ws, ks, wo, xo, ho in zip(trees, plan.ksplit, plan.w_off, plan.x_off, plan.hf_off):
        bulk = [int(plan.resident and w.shape[1] % 4 == 0 and w.data_ptr() % 16 == 0
                    and (k or slice_width(int(w.shape[1]), plan.cluster) <= 256)) for w, k in zip(ws, ks)]
        body += [*map(int, ks), *bulk, *wo, *xo, *ho]
    return (ctypes.c_int * (len(head) + len(body)))(*head, *body)


def _launcher():
    lib = _build.load(LIB)
    fn = lib.fxp_mlp_fwd_launch
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_void_p] * 5
            + [ctypes.c_int]
            + [ctypes.c_void_p] * 5
            + [ctypes.c_int]
            + [ctypes.c_void_p]
            + [ctypes.c_int] * 5
            + [ctypes.c_void_p] * 4
        )
        fn.restype = ctypes.c_int
    return lib, fn


def _bwd_launcher():
    lib = _build.load(LIB_BWD)
    fn = lib.fxp_mlp_bwd_launch
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_void_p] * 10
            + [ctypes.c_int]
            + [ctypes.c_void_p] * 3
            + [ctypes.c_int]
            + [ctypes.c_void_p]
            + [ctypes.c_int] * 4
            + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    return lib, fn


def _check_net(x, weights, deltas, zs, activations, qat: bool, n_bits: int, what: str) -> list[int]:
    """Validate the operands both kernels share; returns the layer dims."""
    n_layers = len(weights)
    if not 1 <= n_layers <= MAX_LAYERS:
        raise ValueError(f"{what} takes 1..{MAX_LAYERS} layers, got {n_layers}")
    if len(activations) != n_layers:
        raise ValueError(f"{n_layers} weights vs {len(activations)} activations")
    if not 1 <= n_bits <= 24:
        raise ValueError(f"n_bits {n_bits} outside 1..24")
    _build.check_operand(x, "x", 2)
    dims = [int(x.shape[1])]
    for i, w in enumerate(weights):
        _build.check_operand(w, f"weights[{i}]", 2)
        if w.shape[0] != dims[-1]:
            raise ValueError(f"layer {i}: w {tuple(w.shape)} after input width {dims[-1]}")
        dims.append(int(w.shape[1]))
    if qat:
        for t, name in ((deltas, "deltas"), (zs, "zs")):
            _build.check_operand(t, name, 1)
            if t.shape[0] != n_layers:
                raise ValueError(f"{name} has {t.shape[0]} entries for {n_layers} layers")
    for t in (*weights, *((deltas, zs) if qat else ())):
        if t.device != x.device:
            raise ValueError(f"operands on {x.device} and {t.device}")
    unknown = [a for a in activations if a not in ACTIVATION_CODES]
    if unknown:
        raise ValueError(f"unknown activations {unknown}; expected one of {list(ACTIVATION_CODES)}")
    if int(x.shape[0]) == 0:
        raise ValueError("empty batch")
    return dims


def _ptrs(tensors) -> ctypes.Array:
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def _check_phase(phase, device) -> None:
    """A device phase operand is a (1,) int32 tensor beside the data."""
    if not isinstance(phase, torch.Tensor) or phase.dtype != torch.int32 or tuple(phase.shape) != (1,):
        raise ValueError(f"phase: expected a (1,) int32 tensor, got {getattr(phase, 'shape', phase)}")
    if phase.device != device:
        raise ValueError(f"phase on {phase.device}, data on {device}")


def fxp_mlp_fwd_cuda(
    x: Tensor,
    weights: Sequence[Tensor],
    biases: Sequence[Tensor],
    deltas: Optional[Tensor],
    zs: Optional[Tensor],
    *,
    activations: Sequence[str],
    quant: bool,
    qat: bool,
    n_bits: int,
    fxp32_phase1: bool,
    save_residuals: bool = False,
    phase: Optional[Tensor] = None,
):
    """The whole forward through kernel B.

    x: (M, K0); weights[i]: (K_i, N_i); biases[i]: (N_i,); deltas/zs: (L,)
    per-site affine operands (read only when qat).  All contiguous float32
    on the current CUDA device.  `phase`, a (1,) int32 on the same device,
    is read in-kernel in place of `quant` (> 0: the quant phase), so the
    launch needs no host read of the phase; not with `save_residuals`.
    Returns (y (M, N_L), mins, maxs), the last two (monitor_rows(M, dims),
    L) per-cluster site extrema; with `save_residuals` also (qs, hs) as
    `ref.ref_mlp_forward` returns them (hs[L-1] is y).
    """
    if len(biases) != len(weights):
        raise ValueError(f"{len(weights)} weights vs {len(biases)} biases")
    dims = _check_net(x, weights, deltas, zs, activations, qat, n_bits, "kernel B")
    n_layers = len(weights)
    for i, b in enumerate(biases):
        _build.check_operand(b, f"biases[{i}]", 1)
        if b.shape[0] != dims[i + 1] or b.device != x.device:
            raise ValueError(f"layer {i}: b {tuple(b.shape)} on {b.device} for w {tuple(weights[i].shape)}")
    if phase is not None:
        _check_phase(phase, x.device)
        if save_residuals:
            raise ValueError("kernel B takes a device phase only without residuals")
    m = int(x.shape[0])
    plan = mlp_plan(m, dims)
    y = torch.empty((m, dims[-1]), dtype=torch.float32, device=x.device)
    mins = torch.empty((plan.n_clusters, n_layers), dtype=torch.float32, device=x.device)
    maxs = torch.empty((plan.n_clusters, n_layers), dtype=torch.float32, device=x.device)
    # bulk copies need 16-byte rows: a resident slice of W loads with them
    # where W's width is a multiple of 4, W is 16-byte aligned and a tensor
    # box is at most 256 columns wide
    bulk = [int(plan.resident and w.shape[1] % 4 == 0 and w.data_ptr() % 16 == 0
                and (ks or slice_width(int(w.shape[1]), plan.cluster) <= 256))
            for w, ks in zip(weights, plan.ksplit)]
    c_plan = (ctypes.c_int * (12 + 3 * n_layers))(
        plan.bm, plan.cluster, plan.n_clusters, int(plan.resident), plan.kmax, plan.smax, plan.pmax, plan.nbuf,
        plan.full_off, plan.act_off, plan.part_off, plan.smem,
        *[int(k) for k in plan.ksplit], *bulk, *plan.w_off)
    qs = hs = []
    if save_residuals:
        qs = [torch.empty((m, k), dtype=torch.float32, device=x.device) for k in dims[:-1]]
        hs = [torch.empty((m, n), dtype=torch.float32, device=x.device) for n in dims[1:-1]]
    w_ptrs = _ptrs(weights)
    b_ptrs = _ptrs(biases)
    c_dims = (ctypes.c_int * (n_layers + 1))(*dims)
    c_acts = (ctypes.c_int * n_layers)(*[ACTIVATION_CODES[a] for a in activations])
    lib, fn = _launcher()
    rc = fn(
        x.data_ptr(),
        w_ptrs,
        b_ptrs,
        c_dims,
        c_acts,
        n_layers,
        deltas.data_ptr() if qat else None,
        zs.data_ptr() if qat else None,
        y.data_ptr(),
        mins.data_ptr(),
        maxs.data_ptr(),
        m,
        c_plan,
        int(bool(quant)),
        int(bool(qat)),
        int(bool(fxp32_phase1)),
        n_bits,
        int(bool(save_residuals)),
        _ptrs(qs) if save_residuals else None,
        _ptrs(hs) if save_residuals and hs else None,
        None if phase is None else phase.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check_launch(lib, LIB, rc)
    fxp_mlp_fwd_cuda.launches += 1
    fxp_mlp_fwd_cuda.residual_launches += bool(save_residuals)
    if save_residuals:
        return y, mins, maxs, qs, hs + [y]
    return y, mins, maxs


fxp_mlp_fwd_cuda.launches = 0
fxp_mlp_fwd_cuda.residual_launches = 0  # the calls among them that saved residuals


def _fxp_mlp_bwd(
    g: Tensor,
    x0: Tensor,
    weights: Sequence[Tensor],
    qs: Sequence[Tensor],
    hs: Sequence[Tensor],
    deltas: Optional[Tensor],
    zs: Optional[Tensor],
    *,
    activations: Sequence[str],
    quant: bool,
    qat: bool,
    n_bits: int,
    fxp32_phase1: bool,
):
    """`fxp_mlp_bwd_cuda`, also returning what pass 2 reduced: (its result,
    gs), gs[l] (M, N_l) the cotangent of layer l's output after the
    activation backward."""
    dims = _check_net(x0, weights, deltas, zs, activations, qat, n_bits, "kernel 3")
    n_layers = len(weights)
    m = int(x0.shape[0])
    if len(qs) != n_layers or len(hs) != n_layers:
        raise ValueError(f"{len(qs)} qs and {len(hs)} hs for {n_layers} layers")
    for name, t, shape in (
        ("g", g, (m, dims[-1])),
        *((f"qs[{i}]", q, (m, dims[i])) for i, q in enumerate(qs)),
        *((f"hs[{i}]", h, (m, dims[i + 1])) for i, h in enumerate(hs)),
    ):
        _build.check_operand(t, name, 2)
        if tuple(t.shape) != shape or t.device != x0.device:
            raise ValueError(f"{name}: shape {tuple(t.shape)} on {t.device}, expected {shape} on {x0.device}")
    plan = bwd_plan(m, dims)
    dev = x0.device
    dx = torch.empty((m, dims[0]), dtype=torch.float32, device=dev)
    dws = [torch.empty((k, n), dtype=torch.float32, device=dev) for k, n in zip(dims[:-1], dims[1:])]
    dbs = [torch.empty((n,), dtype=torch.float32, device=dev) for n in dims[1:]]
    gs = [torch.empty((m, n), dtype=torch.float32, device=dev) for n in dims[1:]]
    c_dims = (ctypes.c_int * (n_layers + 1))(*dims)
    c_acts = (ctypes.c_int * n_layers)(*[ACTIVATION_CODES[a] for a in activations])
    lib, fn = _bwd_launcher()
    rc = fn(
        g.data_ptr(),
        x0.data_ptr(),
        _ptrs(weights),
        _ptrs(qs),
        _ptrs(hs),
        _ptrs(gs),
        _ptrs(dws),
        _ptrs(dbs),
        c_dims,
        c_acts,
        n_layers,
        deltas.data_ptr() if qat else None,
        zs.data_ptr() if qat else None,
        dx.data_ptr(),
        m,
        _c_bwd_plan(plan, weights),
        int(bool(quant)),
        int(bool(qat)),
        int(bool(fxp32_phase1)),
        n_bits,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check_launch(lib, LIB_BWD, rc)
    fxp_mlp_bwd_cuda.launches += 1
    return (dx, dws, dbs), gs


@functools.wraps(_fxp_mlp_bwd, assigned=())
def fxp_mlp_bwd_cuda(*args, **kw) -> tuple[Tensor, list, list]:
    """The whole backward through kernel 3.

    g: (M, N_L) cotangent of y; x0: (M, K0) the forward's input; weights,
    deltas/zs as for the forward; qs[l] (M, K_l) and hs[l] (M, N_l) the
    forward's residuals, hs[L-1] = y.  All contiguous float32 on the
    current CUDA device.  Returns (dx (M, K0), [dW_l (K_l, N_l)],
    [db_l (N_l,)]).  Two CUDA launches: the chain on thread-block clusters
    (`bwd_plan`), then the dW/db reduction over rows.
    """
    return _fxp_mlp_bwd(*args, **kw)[0]


fxp_mlp_bwd_cuda.launches = 0


def _step_launcher(name: str, n_ptrs_head: int, n_trees: int, n_plans: int):
    lib = _build.load(LIB_STEP)
    fn = getattr(lib, f"fxp_ddpg_step_{name}_launch")
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = ([p] * n_ptrs_head + [i] * 3 + [p] * n_trees + [p] * 4 + [i] + [p] * 9 + [p] * n_plans
                       + [i] * 4 + [p])
        fn.restype = ctypes.c_int
    return lib, fn


def _flat(tree) -> list:
    """(ws, bs) → [w0, b0, w1, b1, ...], the kernels' tree layout."""
    ws, bs = tree
    return [t for pair in zip(ws, bs) for t in pair]


def _check_tree(tree, dims, name: str, dev) -> None:
    ws, bs = tree
    if len(ws) != len(dims) - 1 or len(bs) != len(dims) - 1:
        raise ValueError(f"{name}: {len(ws)} weights and {len(bs)} biases for {len(dims) - 1} layers")
    for i, (w, b) in enumerate(zip(ws, bs)):
        _build.check_operand(w, f"{name} w{i}", 2)
        _build.check_operand(b, f"{name} b{i}", 1)
        if tuple(w.shape) != (dims[i], dims[i + 1]) or tuple(b.shape) != (dims[i + 1],):
            raise ValueError(f"{name} layer {i}: w {tuple(w.shape)}, b {tuple(b.shape)}; expected "
                             f"({dims[i]}, {dims[i + 1]}), ({dims[i + 1]},)")
        if w.device != dev or b.device != dev:
            raise ValueError(f"{name} layer {i} on {w.device}, data on {dev}")


def _check_rows(tensors: dict, m: int, dev) -> None:
    for name, (t, width) in tensors.items():
        _build.check_operand(t, name, 1 if width is None else 2)
        shape = (m,) if width is None else (m, width)
        if tuple(t.shape) != shape or t.device != dev:
            raise ValueError(f"{name}: shape {tuple(t.shape)} on {t.device}, expected {shape} on {dev}")


def _check_step_common(deltas, zs, hyper, phase, n_layers: int, qat: bool, n_bits: int, dev) -> None:
    if not 1 <= n_layers <= STEP_MAX_LAYERS:
        raise ValueError(f"kernels 4 and 5 take 1..{STEP_MAX_LAYERS} layers, got {n_layers}")
    if not 1 <= n_bits <= 24:
        raise ValueError(f"n_bits {n_bits} outside 1..24")
    operands = [("hyper", hyper, HYPER_LEN)] + ([("deltas", deltas, 2 * n_layers), ("zs", zs, 2 * n_layers)]
                                              if qat else [])
    for name, t, n in operands:
        _build.check_operand(t, name, 1)
        if t.shape[0] != n or t.device != dev:
            raise ValueError(f"{name}: shape {tuple(t.shape)} on {t.device}, expected ({n},) on {dev}")
    _check_phase(phase, dev)


def _new_trees(tree, n: int = 4) -> list:
    """`n` fresh trees shaped like `tree` (the step's p, m, v, t outputs)."""
    ws, bs = tree
    return [([torch.empty_like(w) for w in ws], [torch.empty_like(b) for b in bs]) for _ in range(n)]


def _ddpg_critic_step(
    obs: Tensor,
    action: Tensor,
    reward: Tensor,
    done: Tensor,
    next_obs: Tensor,
    w: Tensor,
    actor_t,
    critic,
    critic_t,
    critic_m,
    critic_v,
    deltas: Optional[Tensor],
    zs: Optional[Tensor],
    hyper: Tensor,
    phase: Tensor,
    *,
    actor_acts: Sequence[str],
    critic_acts: Sequence[str],
    n_bits: int,
    qat: bool,
    fxp32_phase1: bool,
    fxp_weights: bool,
):
    """`ddpg_critic_step_cuda`, also returning what pass 2 reduced: (its
    result, (qs, gs)), qs[l] (B, K_l) each layer's product input and gs[l]
    (B, N_l) its cotangent after the activation backward."""
    dev = obs.device
    m = int(obs.shape[0])
    obs_dim, act_dim = int(obs.shape[1]), int(action.shape[1])
    n_layers = len(critic_acts)
    a_dims = [obs_dim] + [int(t.shape[1]) for t in actor_t[0]]
    c_dims = [obs_dim + act_dim] + [int(t.shape[1]) for t in critic[0]]
    _check_rows({"obs": (obs, obs_dim), "action": (action, act_dim), "next_obs": (next_obs, obs_dim),
                 "reward": (reward, None), "done": (done, None), "w": (w, None)}, m, dev)
    if m == 0 or a_dims[-1] != act_dim or len(actor_acts) != n_layers:
        raise ValueError(f"batch {m}, actor dims {a_dims} for action width {act_dim}")
    _check_tree(actor_t, a_dims, "actor_t", dev)
    for name, tree in (("critic", critic), ("critic_t", critic_t), ("critic_m", critic_m), ("critic_v", critic_v)):
        _check_tree(tree, c_dims, name, dev)
    _check_step_common(deltas, zs, hyper, phase, n_layers, qat, n_bits, dev)
    plan_t = step_plan(m, a_dims, c_dims, "target")
    plan_c = step_plan(m, a_dims, c_dims, "critic")
    outs = _new_trees(critic)
    mins = torch.empty((plan_c.n_clusters, n_layers), dtype=torch.float32, device=dev)
    maxs = torch.empty_like(mins)
    part = torch.empty((plan_c.n_clusters, 2), dtype=torch.float32, device=dev)
    y = torch.empty((m,), dtype=torch.float32, device=dev)  # the TD target, from the target pass to the critic pass
    qs = [torch.empty((m, k), dtype=torch.float32, device=dev) for k in c_dims[:-1]]
    gs = [torch.empty((m, n), dtype=torch.float32, device=dev) for n in c_dims[1:]]
    codes = lambda acts: (ctypes.c_int * n_layers)(*[ACTIVATION_CODES[a] for a in acts])  # noqa: E731
    lib, fn = _step_launcher("critic", 6, 9, 3)
    rc = fn(
        obs.data_ptr(), action.data_ptr(), reward.data_ptr(), done.data_ptr(), w.data_ptr(), next_obs.data_ptr(),
        m, obs_dim, act_dim,
        *(_ptrs(_flat(t)) for t in (actor_t, critic, critic_m, critic_v, critic_t, *outs)),
        (ctypes.c_int * (n_layers + 1))(*a_dims), codes(actor_acts),
        (ctypes.c_int * (n_layers + 1))(*c_dims), codes(critic_acts), n_layers,
        deltas.data_ptr() if qat else None, zs.data_ptr() if qat else None, hyper.data_ptr(), phase.data_ptr(),
        _ptrs(qs), _ptrs(gs), mins.data_ptr(), maxs.data_ptr(), part.data_ptr(),
        y.data_ptr(), _c_step_plan(plan_t, [actor_t[0], critic_t[0]]), _c_step_plan(plan_c, [critic[0]]),
        int(bool(qat)), int(bool(fxp32_phase1)), int(bool(fxp_weights)), n_bits,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check_launch(lib, LIB_STEP, rc)
    ddpg_critic_step_cuda.launches += 1
    return (*outs, mins, maxs, part), (qs, gs)


@functools.wraps(_ddpg_critic_step, assigned=())
def ddpg_critic_step_cuda(*args, **kw):
    """The critic half of one DDPG update through kernel 4.

    obs (B, O), action (B, A), next_obs (B, O); reward, done (0/1) and the
    row weights w (B,); trees (ws, bs): the target actor, and the critic,
    its Adam moments and its target; deltas/zs (2L,) site operands (actor
    sites, then critic sites; read only when qat); hyper (12,) the step's
    scalars (`ref.HYPER_LEN` layout); phase (1,) int32.  All contiguous
    float32 (phase int32) on the current CUDA device.  Returns (critic,
    critic_m, critic_v, critic_t) as new trees, then mins/maxs (R, L) and
    partials (R, 2) = per cluster [Σ w(q−y)², Σ w·y], R =
    `step_monitor_rows(B, actor_dims, critic_dims, "critic")`.
    """
    return _ddpg_critic_step(*args, **kw)[0]



ddpg_critic_step_cuda.launches = 0


def _ddpg_actor_step(
    obs: Tensor,
    w: Tensor,
    actor,
    actor_m,
    actor_v,
    actor_t,
    critic,
    deltas: Optional[Tensor],
    zs: Optional[Tensor],
    hyper: Tensor,
    phase: Tensor,
    *,
    actor_acts: Sequence[str],
    critic_acts: Sequence[str],
    n_bits: int,
    qat: bool,
    fxp32_phase1: bool,
    fxp_weights: bool,
):
    """`ddpg_actor_step_cuda`, also returning (qs, gs) of the actor, as
    `_ddpg_critic_step` does."""
    dev = obs.device
    m = int(obs.shape[0])
    obs_dim = int(obs.shape[1])
    n_layers = len(actor_acts)
    a_dims = [obs_dim] + [int(t.shape[1]) for t in actor[0]]
    act_dim = a_dims[-1]
    c_dims = [obs_dim + act_dim] + [int(t.shape[1]) for t in critic[0]]
    _check_rows({"obs": (obs, obs_dim), "w": (w, None)}, m, dev)
    if m == 0 or len(critic_acts) != n_layers:
        raise ValueError(f"batch {m}, {n_layers} actor and {len(critic_acts)} critic layers")
    for name, tree in (("actor", actor), ("actor_m", actor_m), ("actor_v", actor_v), ("actor_t", actor_t)):
        _check_tree(tree, a_dims, name, dev)
    _check_tree(critic, c_dims, "critic", dev)
    _check_step_common(deltas, zs, hyper, phase, n_layers, qat, n_bits, dev)
    plan = step_plan(m, a_dims, c_dims, "actor")
    outs = _new_trees(actor)
    mins = torch.empty((plan.n_clusters, 2 * n_layers), dtype=torch.float32, device=dev)
    maxs = torch.empty_like(mins)
    part = torch.empty((plan.n_clusters, 1), dtype=torch.float32, device=dev)
    qs = [torch.empty((m, k), dtype=torch.float32, device=dev) for k in a_dims[:-1]]
    gs = [torch.empty((m, n), dtype=torch.float32, device=dev) for n in a_dims[1:]]
    codes = lambda acts: (ctypes.c_int * n_layers)(*[ACTIVATION_CODES[a] for a in acts])  # noqa: E731
    lib, fn = _step_launcher("actor", 2, 9, 1)
    rc = fn(
        obs.data_ptr(), w.data_ptr(), m, obs_dim, act_dim,
        *(_ptrs(_flat(t)) for t in (actor, actor_m, actor_v, actor_t, *outs, critic)),
        (ctypes.c_int * (n_layers + 1))(*a_dims), codes(actor_acts),
        (ctypes.c_int * (n_layers + 1))(*c_dims), codes(critic_acts), n_layers,
        deltas.data_ptr() if qat else None, zs.data_ptr() if qat else None, hyper.data_ptr(), phase.data_ptr(),
        _ptrs(qs), _ptrs(gs), mins.data_ptr(), maxs.data_ptr(), part.data_ptr(),
        _c_step_plan(plan, [actor[0], critic[0]]),
        int(bool(qat)), int(bool(fxp32_phase1)), int(bool(fxp_weights)), n_bits,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check_launch(lib, LIB_STEP, rc)
    ddpg_actor_step_cuda.launches += 1
    return (*outs, mins, maxs, part), (qs, gs)


@functools.wraps(_ddpg_actor_step, assigned=())
def ddpg_actor_step_cuda(*args, **kw):
    """The actor half of one DDPG update through kernel 5, through the
    updated `critic`.  obs (B, O), w (B,); trees (ws, bs): the actor, its
    Adam moments, its target, and the critic; the rest as for
    `ddpg_critic_step_cuda`.  Returns (actor, actor_m, actor_v, actor_t) as
    new trees, then mins/maxs (R, 2L) (actor sites, then the critic sites of
    this pass) and partials (R, 1) = per cluster Σ w·q, R =
    `step_monitor_rows(B, actor_dims, critic_dims, "actor")`."""
    return _ddpg_actor_step(*args, **kw)[0]



ddpg_actor_step_cuda.launches = 0


__all__ = [
    "fxp_mlp_fwd_cuda",
    "fxp_mlp_bwd_cuda",
    "ddpg_critic_step_cuda",
    "ddpg_actor_step_cuda",
    "row_block",
    "mlp_plan",
    "monitor_rows",
    "step_plan",
    "step_monitor_rows",
    "StepPlan",
    "bwd_plan",
    "BwdPlan",
    "slice_width",
    "MlpPlan",
    "MAX_LAYERS",
    "STEP_MAX_LAYERS",
    "BWD_ROWS",
]
