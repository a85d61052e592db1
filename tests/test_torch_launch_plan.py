"""The launch plans of kernels A and B, as pure Python (no card needed).

`dense_plan` (kernel A: output tile, body, split of K over a thread-block
cluster) and `mlp_plan` (kernel B: rows per block, cluster width, cluster
count, resident weights, shared-memory layout) decide what each block of a
launch computes.  These tests walk the plans as the kernels do and check
that every output is owned once and every k summed once, that clusters
divide the grid with at most 16 blocks, that shared memory stays within a
block's 232,448 bytes, that a single row uses more than one SM, and that
kernel B raises for exactly the widths the kernel it replaced raised for.
Shapes: the paper's actor and critic, the CPU tests' shapes, and ragged
ones.
"""

import numpy as np
import pytest

from repro_torch.kernels.fxp_matmul import kernel as ka
from repro_torch.kernels.fxp_mlp import kernel as kb

MAX_SMEM = 232448
ACTOR = (17, 400, 300, 6)
CRITIC = (23, 400, 300, 1)
BATCHES = (1, 2, 7, 8, 9, 16, 17, 32, 33, 120, 121, 128, 200, 511, 512, 1000)
DENSE_LAYERS = [(17, 400), (400, 300), (300, 6), (23, 400), (300, 1), (33, 5), (300, 6), (5, 129), (301, 70),
                (257, 300), (0, 3), (1, 1), (4096, 40)]


def _dense_blocks(m, k, n):
    """Walk kernel A's grid as the kernel does: (rows, columns, k range) of
    each block, and the rank of the cluster that finishes each output."""
    bm, bn, split, grid = ka.dense_plan(m, k, n)
    n_ct = -(-n // bn)
    chunk = -(-k // split) if k else 0
    for bx in range(grid[0]):
        row0, col0 = (bx // n_ct) * bm, (bx % n_ct) * bn
        for z in range(grid[2]):
            yield row0, col0, z * chunk, min(k, (z + 1) * chunk) if split > 1 else k


@pytest.mark.parametrize("k,n", DENSE_LAYERS, ids=[f"{k}x{n}" for k, n in DENSE_LAYERS])
@pytest.mark.parametrize("m", BATCHES)
def test_dense_plan_owns_every_output_once_and_sums_every_k_once(m, k, n):
    bm, bn, split, grid = ka.dense_plan(m, k, n)
    assert (bm, bn) in ((64, 64), (32, 64), (8, 8), (8, 16), (8, 32))
    assert 1 <= split <= 16 and grid[1] == 1 and grid[2] == split  # clusters (1, 1, split) tile the grid
    summed = np.zeros((m, n, max(k, 1)), np.int32)
    tiles = np.zeros((m, n), np.int32)
    for row0, col0, k_lo, k_hi in _dense_blocks(m, k, n):
        assert k_hi > k_lo or k == 0, "an empty chunk of K"
        summed[row0:row0 + bm, col0:col0 + bn, k_lo:k_hi] += 1
        if k_lo == 0:
            tiles[row0:row0 + bm, col0:col0 + bn] += 1
    assert (tiles == 1).all()
    if k:
        assert (summed == 1).all()
    # split K: each rank finishes outputs rank·THREADS + tid, stepping split·THREADS
    # (the kernel's cluster_reduce loop): every output of the tile exactly once
    finished = np.zeros(bm * bn, np.int32)
    for rank in range(split):
        for tid in range(ka.THREADS):
            finished[rank * ka.THREADS + tid::split * ka.THREADS] += 1
    assert (finished == 1).all()


@pytest.mark.parametrize("k,n", [(17, 400), (400, 300), (300, 6), (23, 400), (300, 1)])
def test_dense_plan_spreads_one_row_over_many_sms_and_tiles_large_batches(k, n):
    bm, bn, split, grid = ka.dense_plan(1, k, n)
    assert grid[0] * grid[2] > 1
    if k >= 300:  # deep enough to split: on the order of a wave of blocks
        assert grid[0] * grid[2] >= ka.SMS // 8
    for m in (128, 512):
        bm, bn, split, grid = ka.dense_plan(m, k, n)
        if n > ka.SMALL_MAX_M and k >= 2 * ka.MIN_CHUNK["tiled"]:
            # a layer deep enough to split: the tiled body, a 4 × 4 register tile
            # a thread (the 17- and 23-deep first layers take more, smaller
            # tiles instead, which the H100 ran faster)
            assert (bm, bn) == (64, 64) and bm * bn // ka.THREADS >= 16


def test_dense_plan_shared_memory_and_cluster_sizes():
    for body, smem in ka.SMEM.items():
        assert smem <= 48 * 1024 < MAX_SMEM, body  # static shared memory
    for m in BATCHES:
        for k, n in DENSE_LAYERS:
            assert ka.dense_plan(m, k, n)[2] <= 16


@pytest.mark.parametrize("m,k,n", [(0, 3, 4), (2, -1, 4), (2, 3, 0)])
def test_dense_plan_rejects_empty_shapes(m, k, n):
    with pytest.raises(ValueError):
        ka.dense_plan(m, k, n)


NETS = {"actor": ACTOR, "critic": CRITIC, "tiny": (5, 33, 7), "deep": (17, 64, 64, 64, 64, 2),
        "wide16": (256, 600, 400, 6), "stream": (2000, 2000, 2000), "wide_row": (19000, 3), "edge": (2421, 5)}


def _cases(batches):
    """(net, m) pairs the kernel takes: a width of 19000 only for one row."""
    return [(net, m) for net in NETS for m in batches if 3 * kb.row_block(m) * max(NETS[net]) * 4 <= MAX_SMEM]


def _slice(d, c, q):
    s = kb.slice_width(d, c)
    return q * s, max(0, min(s, d - q * s))


@pytest.mark.parametrize("net,m", _cases(BATCHES))
def test_mlp_plan_owns_every_output_once_and_sums_every_k_once(net, m):
    dims = NETS[net]
    p = kb.mlp_plan(m, dims)
    assert p.bm == (1 if m == 1 else 8)
    grid = p.n_clusters * p.cluster  # blocks; clusters of p.cluster blocks tile it
    assert 2 <= p.cluster <= 16 and grid % p.cluster == 0
    n_rb = -(-m // p.bm)
    assert 1 <= p.n_clusters <= min(n_rb, kb.CLUSTER_SLOTS[p.cluster])
    # persistent clusters: every row block walked by exactly one cluster
    walked = sorted(rb for cid in range(p.n_clusters) for rb in range(cid, n_rb, p.n_clusters))
    assert walked == list(range(n_rb))
    for l, (k, n) in enumerate(zip(dims[:-1], dims[1:])):
        outs, ks = np.zeros(n, np.int32), np.zeros(k, np.int32)
        for q in range(p.cluster):
            nlo, nq = _slice(n, p.cluster, q)
            outs[nlo:nlo + nq] += 1  # the block's output slice (finished there, split or not)
            klo, kn = _slice(k, p.cluster, q)
            if p.ksplit[l]:
                ks[klo:klo + kn] += 1  # K-split: each block sums its own input slice
            else:
                ks += 1 if q == 0 else 0  # column split: one block sums all of K per output
            assert kb.slice_width(k, p.cluster) % 4 == 0
        assert (outs == 1).all() and (ks == 1).all(), l
        assert p.ksplit[l] == (n <= kb.KSPLIT_MAX_N)


@pytest.mark.parametrize("net,m", _cases((1, 8, 128, 512)))
def test_mlp_plan_shared_memory_layout(net, m):
    dims = NETS[net]
    p = kb.mlp_plan(m, dims)
    assert p.smem + kb.STATIC_SMEM <= MAX_SMEM
    end = 0
    for l, (k, n) in enumerate(zip(dims[:-1], dims[1:])):
        if p.resident:
            assert p.w_off[l] >= end and p.w_off[l] % 32 == 0  # tensor boxes land 128-byte aligned
            end = p.w_off[l] + (kb.slice_width(k, p.cluster) * n if p.ksplit[l]
                                else -(-k // 256) * kb.tma_rows(k) * kb.slice_width(n, p.cluster))
            assert kb.tma_rows(k) <= 256 and kb.tma_rows(k) % 8 == 0 and -(-k // 256) * kb.tma_rows(k) >= k
    assert p.full_off >= end and p.kmax >= max(dims[:-1]) and p.kmax % 4 == 0
    assert p.act_off == p.full_off + p.nbuf * 2 * p.bm * p.kmax
    assert p.part_off == p.act_off + p.bm * p.smax and p.smem == 4 * (p.part_off + 2 * p.bm * p.pmax)
    assert p.smax >= max(kb.slice_width(d, p.cluster) for d in dims)


@pytest.mark.parametrize("net", ["actor", "critic", "tiny"])
def test_mlp_plan_adapts_the_cluster_width_to_the_batch(net):
    dims = NETS[net]
    one = kb.mlp_plan(1, dims)
    assert one.cluster == 8 and one.resident and one.n_clusters == 1  # a single row on 8 SMs
    wave = kb.CLUSTER_SLOTS[8] * 8
    assert kb.mlp_plan(wave, dims).cluster == 8 and kb.mlp_plan(wave + 1, dims).cluster == 4
    assert kb.mlp_plan(512, dims).n_clusters == kb.CLUSTER_SLOTS[4]
    assert kb.monitor_rows(512, dims) == kb.CLUSTER_SLOTS[4] and kb.monitor_rows(1, dims) == 1


@pytest.mark.parametrize("m,width,raises", [(1, 19370, False), (1, 19371, True), (2, 2421, False),
                                            (2, 2422, True), (512, 2421, False), (512, 2422, True)])
def test_mlp_plan_raises_for_the_widths_the_replaced_kernel_raised_for(m, width, raises):
    dims = (width, 3)
    if raises:
        with pytest.raises(ValueError, match="shared memory"):
            kb.mlp_plan(m, dims)
    else:
        p = kb.mlp_plan(m, dims)
        assert p.smem + kb.STATIC_SMEM <= MAX_SMEM


def test_mlp_plan_picks_the_larger_cluster_then_streaming_weights():
    assert kb.mlp_plan(8, NETS["wide16"]).cluster == 16
    stream = kb.mlp_plan(8, NETS["stream"])
    assert not stream.resident and stream.w_off == (0, 0)


# --------------------------------------------------------------------------
# kernels 4 and 5: the chain passes' plans (`step_plan`)
# --------------------------------------------------------------------------

STEP_NETS = {
    "paper": (ACTOR, CRITIC), "cpu": ((5, 24, 16, 2), (7, 24, 16, 1)), "one_layer": ((17, 6), (23, 1)),
    "narrow": ((5, 4, 3, 2), (7, 3, 5, 1)), "wide_action": ((11, 64, 12), (23, 64, 1)),
    "deep": ((17, 64, 64, 64, 6), (23, 64, 64, 64, 1)), "stream": ((40, 1000, 1000, 6), (46, 1000, 1000, 1)),
}
STEP_PASSES = ("target", "critic", "actor")


def _pass_nets(name, which):
    actor, critic = STEP_NETS[name]
    return [actor if n == "actor" else critic for n in kb.STEP_NETS[which]]


@pytest.mark.parametrize("which", STEP_PASSES)
@pytest.mark.parametrize("m", BATCHES)
@pytest.mark.parametrize("name", STEP_NETS)
def test_step_plan_owns_every_output_once_and_sums_every_k_once(name, m, which):
    p = kb.step_plan(m, *STEP_NETS[name], which)
    assert p.bm in kb.STEP_ROWS and 2 <= p.cluster <= 16
    n_rb = -(-m // p.bm)
    assert 1 <= p.n_clusters <= min(n_rb, kb.CLUSTER_SLOTS[p.cluster])
    walked = sorted(rb for cid in range(p.n_clusters) for rb in range(cid, n_rb, p.n_clusters))
    assert walked == list(range(n_rb))  # persistent clusters: every row block once
    for dims, ksplit in zip(_pass_nets(name, which), p.ksplit):
        for l, (k, n) in enumerate(zip(dims[:-1], dims[1:])):
            assert ksplit[l] == (n <= kb.KSPLIT_MAX_N)
            outs, ks = np.zeros(n, np.int32), np.zeros(k, np.int32)
            for q in range(p.cluster):
                nlo, nq = _slice(n, p.cluster, q)
                outs[nlo:nlo + nq] += 1  # G_l's columns: each stored by one block
                klo, kn = _slice(k, p.cluster, q)
                if ksplit[l]:
                    ks[klo:klo + kn] += 1  # K-split: each block sums its own input slice
                else:
                    ks += 1 if q == 0 else 0  # column split: one block sums all of K per output
            assert (outs == 1).all() and (ks == 1).all(), (l, k, n)
            if ksplit[l]:
                assert n <= p.pmax  # every block holds the whole output


def _dx_targets(dims_list, which):
    """(D, to_full) of every dx the chain delivers: a layer l > 0's input
    (to every block where layer l − 1 splits K), and kernel 5's da."""
    out = []
    for dims in dims_list:
        for l in range(1, len(dims) - 1):
            out.append((dims[l], dims[l] <= kb.KSPLIT_MAX_N))
    if which == "actor":
        actor = dims_list[0]
        out.append((actor[-1], actor[-1] <= kb.KSPLIT_MAX_N))
    return out


@pytest.mark.parametrize("which", ("critic", "actor"))
@pytest.mark.parametrize("m", (1, 9, 128, 241, 512))
@pytest.mark.parametrize("name", STEP_NETS)
def test_step_plan_reduce_scatter_gives_each_input_column_to_one_block(name, m, which):
    p = kb.step_plan(m, *STEP_NETS[name], which)
    for d, to_full in _dx_targets(_pass_nets(name, which), which):
        if to_full:
            assert d <= p.pmax <= p.rmax  # every block receives all d columns, one row each sender
            continue
        owned = np.zeros(d, np.int32)
        for q in range(p.cluster):
            lo, n = _slice(d, p.cluster, q)
            owned[lo:lo + n] += 1
            assert kb.slice_width(d, p.cluster) <= p.rmax  # a sender's float4 row fits the receive row
        assert (owned == 1).all()
        # a sender's four-column groups never straddle two owners
        sd = kb.slice_width(d, p.cluster)
        assert sd % 4 == 0 and all((j0 // sd) == ((j0 + 3) // sd) for j0 in range(0, d, 4))


def _step_regions(p, nets):
    """(offset, floats) of every region of a plan's layout, as the kernel's
    read_plan lists them."""
    regions = [(p.full_off, max(p.nbuf * 2 * p.bm * p.kmax, 2 * p.cluster * p.bm * p.rmax)),
               (p.part_off, 2 * p.bm * p.pmax), (p.g_off[0], p.bm * p.gmax), (p.g_off[1], p.bm * p.gmax)]
    for dims, ks, wo, xo, ho in zip(nets, p.ksplit, p.w_off, p.x_off, p.hf_off):
        regions += [(o, p.bm * kb.slice_width(d, p.cluster)) for o, d in zip(xo, dims)]
        regions += [(o, p.bm * p.pmax) for o, k in zip(ho, ks) if k]
        if p.resident:
            for (k, n), split, o in zip(zip(dims[:-1], dims[1:]), ks, wo):
                assert o % 32 == 0  # tensor boxes land 128-byte aligned
                regions.append((o, kb.slice_width(k, p.cluster) * n if split
                                else -(-k // 256) * kb.tma_rows(k) * kb.slice_width(n, p.cluster)))
    return regions


@pytest.mark.parametrize("which", STEP_PASSES)
@pytest.mark.parametrize("m", (1, 8, 128, 241, 512))
@pytest.mark.parametrize("name", STEP_NETS)
def test_step_plan_layout_fits_and_its_regions_are_disjoint(name, m, which):
    p = kb.step_plan(m, *STEP_NETS[name], which)
    nets = _pass_nets(name, which)
    assert p.smem + kb.STATIC_SMEM <= MAX_SMEM
    regions = [(o, n) for o, n in _step_regions(p, nets) if n > 0]
    for o, n in regions:
        assert o % 4 == 0 and 4 * (o + n) <= p.smem  # float4-aligned, inside the layout
    spans = sorted(regions)
    assert all(a[0] + a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    assert p.kmax >= max(d for dims in nets for d in dims[:-1]) and p.kmax % 4 == 0
    assert p.smax == max(kb.slice_width(d, p.cluster) for dims in nets for d in dims)
    assert p.rmax >= max(p.smax, p.pmax) and p.gmax >= max(p.smax, p.pmax)


@pytest.mark.parametrize("name", ["paper", "cpu", "one_layer"])
def test_step_plan_adapts_the_cluster_to_the_batch(name):
    nets = STEP_NETS[name]
    wave = kb.CLUSTER_SLOTS[8] * 8
    for which in STEP_PASSES:
        for m in (1, 8, wave):
            p = kb.step_plan(m, *nets, which)
            assert (p.bm, p.cluster, p.n_clusters) == (8, 8, -(-m // 8))  # 8-row blocks, one wave of 8
        assert kb.step_monitor_rows(wave, *nets, which) == kb.CLUSTER_SLOTS[8]
    if name == "paper":
        # past one wave of clusters of 8: the two-net passes take 16-row
        # blocks (their slices do not fit clusters of 4), the critic pass
        # clusters of 4
        for which, shape in (("target", (16, 8)), ("actor", (16, 8)), ("critic", (8, 4))):
            p = kb.step_plan(wave + 1, *nets, which)
            assert (p.bm, p.cluster) == shape and p.resident
            assert kb.step_monitor_rows(wave + 1, *nets, which) == p.n_clusters == -(-(wave + 1) // p.bm)
        assert kb.step_plan(241, *nets, "critic")[:2] == (16, 4)
    assert kb.step_plan(512, *nets, "critic").n_clusters <= kb.CLUSTER_SLOTS[kb.step_plan(512, *nets, "critic").cluster]


def test_step_plan_streams_the_weights_where_no_slice_fits():
    p = kb.step_plan(128, *STEP_NETS["stream"], "actor")
    assert not p.resident and (p.bm, p.cluster) == (8, 8) and p.w_off == ((0, 0, 0), (0, 0, 0))


@pytest.mark.parametrize("width,which,raises", [
    (1810, "actor", False), (1811, "actor", True), (1443, "critic", False), (1444, "critic", True),
    (1443, "target", False), (1444, "target", True)])
def test_step_plan_raises_exactly_where_the_kernel_without_clusters_refused(width, which, raises):
    # kernel 5 refused 8 · (23 + 2W + W + (W + 1)) floats past 232,448 bytes,
    # kernel 4 (both passes) 8 · (2·23 + 4W + (W + 1))
    nets = ((17, width, 6), (23, width, 1))
    if raises:
        with pytest.raises(ValueError, match="shared memory"):
            kb.step_plan(128, *nets, which)
    else:
        p = kb.step_plan(128, *nets, which)
        assert p.smem + kb.STATIC_SMEM <= MAX_SMEM


@pytest.mark.parametrize("m,actor,critic,which", [
    (0, ACTOR, CRITIC, "actor"), (8, (17, 8, 8, 8, 8, 6), (23, 8, 8, 8, 8, 1), "actor"),
    (8, ACTOR, (22, 400, 300, 1), "critic"), (8, ACTOR, (23, 400, 1), "target"), (8, ACTOR, CRITIC, "learner")])
def test_step_plan_rejects_what_the_kernels_do_not_take(m, actor, critic, which):
    with pytest.raises(ValueError):
        kb.step_plan(m, actor, critic, which)


# kernel 3 (`bwd_plan`): the paper's nets, the CPU tests' nets, eight layers,
# a narrow layer inside the net, and widths on both sides of the switch to
# the streamed-W instance (for two square hidden layers, past 768 columns)
BWD_NETS = {
    "actor": ACTOR, "critic": CRITIC, "cpu": (5, 16, 12, 3), "one_layer": (7, 4), "deep": (17,) + (64,) * 7 + (6,),
    "narrow_inside": (33, 300, 5, 129, 1), "resident_edge": (23, 768, 768, 1), "stream": (23, 772, 772, 1),
    "stream_deep": (3632,) * 9, "stream_mixed": (3632, 8, 3632, 5, 3632, 1, 3632, 3632, 3632),
}
BWD_BATCHES = (1, 7, 8, 9, 16, 17, 120, 121, 128, 241, 511)


def _bwd_regions(p, dims):
    """(offset, floats) of every region of a kernel-3 plan's layout, as the
    kernel's read_plan lists them."""
    regions = [(p.full_off, 2 * p.cluster * p.bm * p.rmax), (p.g_off[0], p.bm * p.gmax),
               (p.g_off[1], p.bm * p.gmax)]
    regions += [(o, p.bm * kb.slice_width(d, p.cluster)) for o, d in zip(p.x_off, dims)]
    regions += [(o, p.bm * p.pmax) for o, k in zip(p.hf_off, p.ksplit) if k]
    if p.resident:
        for (k, n), split, o in zip(zip(dims[:-1], dims[1:]), p.ksplit, p.w_off):
            assert o % 32 == 0  # tensor boxes land 128-byte aligned
            regions.append((o, kb.slice_width(k, p.cluster) * n if split
                            else -(-k // 256) * kb.tma_rows(k) * kb.slice_width(n, p.cluster)))
    return regions


@pytest.mark.parametrize("m", BWD_BATCHES)
@pytest.mark.parametrize("name", BWD_NETS)
def test_bwd_plan_layout_fits_and_its_regions_are_disjoint(name, m):
    dims = BWD_NETS[name]
    p = kb.bwd_plan(m, dims)
    assert p.bm in kb.BWD_ROWS[p.resident] and 2 <= p.cluster <= 16
    assert p.smem + kb.STATIC_SMEM <= MAX_SMEM
    regions = [(o, n) for o, n in _bwd_regions(p, dims) if n > 0]
    for o, n in regions:
        assert o % 4 == 0 and 4 * (o + n) <= p.smem  # float4-aligned, inside the layout
    spans = sorted(regions)
    assert all(a[0] + a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    assert p.smax == max(kb.slice_width(d, p.cluster) for d in dims)
    assert p.rmax >= max(p.smax, p.pmax) and p.gmax >= max(p.smax, p.pmax)
    assert p.rmax % 4 == 0 and p.gmax % 4 == 0 and p.pmax % 4 == 0


@pytest.mark.parametrize("m", BWD_BATCHES)
@pytest.mark.parametrize("name", BWD_NETS)
def test_bwd_plan_owns_every_output_and_input_column_once(name, m):
    dims = BWD_NETS[name]
    p = kb.bwd_plan(m, dims)
    n_rb = -(-m // p.bm)
    assert 1 <= p.n_clusters <= min(n_rb, kb.CLUSTER_SLOTS[p.cluster])
    walked = sorted(rb for cid in range(p.n_clusters) for rb in range(cid, n_rb, p.n_clusters))
    assert walked == list(range(n_rb))  # persistent clusters: every row block once
    for l, (k, n) in enumerate(zip(dims[:-1], dims[1:])):
        assert p.ksplit[l] == (n <= kb.KSPLIT_MAX_N)
        outs = np.zeros(n, np.int32)  # G_l's columns: each stored by one block
        ins = np.zeros(k, np.int32)  # dx's columns (layer 0) or the layer input's: each owned by one block
        for q in range(p.cluster):
            nlo, nq = _slice(n, p.cluster, q)
            outs[nlo:nlo + nq] += 1
            klo, kn = _slice(k, p.cluster, q)
            ins[klo:klo + kn] += 1
        assert (outs == 1).all() and (ins == 1).all(), (l, k, n)
        if p.ksplit[l]:
            assert n <= p.pmax  # every block holds the whole output
        # the reduce-scatter onto layer l's input: a sender's four-column
        # groups never straddle two owners, and a row fits the receive rows
        to_full = l > 0 and p.ksplit[l - 1]
        if to_full:
            assert k <= p.pmax <= p.rmax
        else:
            sd = kb.slice_width(k, p.cluster)
            assert sd <= p.rmax and sd % 4 == 0 and all((j0 // sd) == ((j0 + 3) // sd) for j0 in range(0, k, 4))


@pytest.mark.parametrize("name", ["actor", "critic"])
def test_bwd_plan_adapts_the_cluster_to_the_batch(name):
    dims = BWD_NETS[name]
    wave = kb.CLUSTER_SLOTS[8] * 8
    for m in (1, 7, 8, 9, 16, 17, 120):
        p = kb.bwd_plan(m, dims)  # one wave of 8-row blocks on clusters of 8
        assert (p.bm, p.cluster, p.n_clusters, p.resident) == (8, 8, -(-m // 8), True)
    for m in (wave + 1, 128, 240):
        p = kb.bwd_plan(m, dims)  # past one wave of clusters of 8: clusters of 4
        assert (p.bm, p.cluster, p.n_clusters, p.resident) == (8, 4, -(-m // 8), True)
    for m in (241, 480):
        p = kb.bwd_plan(m, dims)  # past one wave of clusters of 4: 16-row blocks
        assert (p.bm, p.cluster, p.n_clusters, p.resident) == (16, 4, -(-m // 16), True)
    p = kb.bwd_plan(511, dims)  # persistent clusters
    assert (p.bm, p.cluster, p.n_clusters) == (16, 4, kb.CLUSTER_SLOTS[4])


@pytest.mark.parametrize("name,resident", [("resident_edge", True), ("stream", False), ("stream_deep", False),
                                           ("stream_mixed", False)])
def test_bwd_plan_streams_the_weights_exactly_where_no_slice_fits(name, resident):
    dims = BWD_NETS[name]
    p = kb.bwd_plan(128, dims)
    assert p.resident == resident
    if not resident:
        assert p.cluster == 8 and set(p.w_off) == {0}
        assert all(kb._bwd_layout(bm, c, dims, True).smem + kb.STATIC_SMEM > MAX_SMEM
                   for bm in kb.BWD_ROWS[True] for c in (4, 8, 16))


@pytest.mark.parametrize("layers", range(1, kb.MAX_LAYERS + 1))
@pytest.mark.parametrize("width", (1, 8, 9, 400, 3632))
def test_bwd_plan_takes_every_depth_and_width_the_replaced_kernel_took(layers, width):
    # up to MAX_LAYERS layers of any width with 2 · 8 · max(dims) floats
    # in a block's shared memory
    for dims in ((width,) * (layers + 1), (17,) + (width,) * (layers - 1) + (1,)):
        for m in (1, 128, 511):
            p = kb.bwd_plan(m, dims)
            assert p.smem + kb.STATIC_SMEM <= MAX_SMEM


@pytest.mark.parametrize("width,raises", [(3632, False), (3633, True), (4096, True)])
def test_bwd_plan_raises_exactly_where_the_replaced_kernel_raised(width, raises):
    # the kernel without clusters refused 2 · 8 · max(dims) floats past 232,448 bytes
    for dims in ((17, width, 6), (width, 3, 2), (4, 4, 4, 4, 4, 4, 4, 4, width)):
        if raises:
            with pytest.raises(ValueError, match="shared memory"):
                kb.bwd_plan(128, dims)
        else:
            assert kb.bwd_plan(128, dims).smem + kb.STATIC_SMEM <= MAX_SMEM


@pytest.mark.parametrize("m,dims", [(0, ACTOR), (8, (17,)), (8, (17,) + (8,) * 9), (8, (17, 0, 6)), (-1, CRITIC)])
def test_bwd_plan_rejects_what_the_kernel_does_not_take(m, dims):
    with pytest.raises(ValueError):
        kb.bwd_plan(m, dims)
