"""The layouts the reference runs and the port once stopped on, run to the
end under fake tensors on a fake world (`launch.mesh.init_fake_world`,
`launch.dryrun.measure_cell`), as `tools/layout_sweep.py` runs every cell.

* gemma3-1b and recurrentgemma-2b have one kv head.  The rules put it on a
  "model" axis of 1 (1 % 1 == 0), and DTensor's views refused a `Shard`
  even on a mesh dim of size 1: pure data parallel, (8, 1), and the
  one-card (1, 1) mesh stopped at the first attention projection.  A mesh
  dim of size 1 now places `Replicate()` (`NamedSharding.placements`).
* rwkv6's smoke config has 4 heads of 16: on (1, 8) "model" divides d_model
  but not the heads, and the split of d into (heads, 16) stopped; the
  projections are laid out on whole heads first (`layers._whole_heads`).

Each mesh runs in a child process of its own (the tool's `run_mesh`: one
process, one process group), the three at once; values are held to the
unsharded run on 8 real ranks in `tests/test_torch_dist_cells.py`.
"""

import concurrent.futures
import importlib.util
import math
import pathlib

import pytest

pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401  (one intra-op thread a worker)

REPO = pathlib.Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("layout_sweep", REPO / "tools" / "layout_sweep.py")
sweep = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(sweep)

CELLS = {
    "8x1": [("gemma3_1b", "prefill"), ("recurrentgemma_2b", "prefill"), ("gemma3_1b", "train")],
    "1x8": [("rwkv6_1_6b", "prefill")],
    "1x1": [("gemma3_1b", "prefill"), ("recurrentgemma_2b", "prefill")],
}


@pytest.fixture(scope="module")
def rows():
    with concurrent.futures.ThreadPoolExecutor(len(CELLS)) as pool:
        futures = {m: pool.submit(sweep.run_mesh, m, cells, timeout=300.0) for m, cells in CELLS.items()}
        return {m: f.result() for m, f in futures.items()}


@pytest.mark.parametrize("mesh,arch,kind", [(m, a, k) for m, cells in CELLS.items() for a, k in cells])
def test_cell_runs_on_a_fake_world(rows, mesh, arch, kind):
    row = rows[mesh][(arch, kind)]
    assert row["status"] == "ok", row
    assert row["peak_bytes"] > 0


@pytest.mark.parametrize("text,want", [
    ("2x4", ((2, 4), ("data", "model"))),
    ("1x1", ((1, 1), ("data", "model"))),
    ("pod2x4x1", ((2, 4, 1), ("pod", "data", "model"))),
])
def test_parse_mesh(text, want):
    assert sweep.parse_mesh(text) == want


@pytest.mark.parametrize("text", ["2x4x1", "pod2x4", "0x8"])
def test_parse_mesh_refuses(text):
    with pytest.raises(ValueError):
        sweep.parse_mesh(text)


def test_default_meshes_are_the_seven():
    assert sweep.DEFAULT_MESHES == ("2x4", "4x2", "1x8", "8x1", "pod2x2x2", "pod2x4x1", "1x1")
    sizes = [sweep.parse_mesh(m)[0] for m in sweep.DEFAULT_MESHES]
    assert [math.prod(s) for s in sizes] == [8] * 6 + [1]
