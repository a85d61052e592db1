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
