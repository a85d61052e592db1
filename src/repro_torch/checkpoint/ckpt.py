"""Checkpoints with async writes (port of `repro.checkpoint.ckpt`).

Layout on disk (one directory per step), the reference's:

    <dir>/step_000100/
        manifest.json      step, treedef, extra, per-leaf file/shape/dtype, leaf_names
        leaf_00000.npy ... one file per leaf (copied to the host)

Leaves are numbered and named in the reference's pytree order
(`repro_torch.tree`: dataclass fields in declaration order, dict keys
sorted), and each keeps its dtype (the Adam and QAT step counters int32,
as the reference writes them).  So a checkpoint of a `DDPGState` written by
either package restores in the other, bitwise.

  * `save` writes into a temporary directory and renames it: a partial
    checkpoint is never visible;
  * `restore` fills a template's structure and puts every leaf on
    `device` (default: the device of the template's leaf; numpy template
    leaves stay numpy), or, given `shardings=` (a tree of
    `core.parallelism.NamedSharding`s, as `launch.specs` builds them),
    lays each leaf out as a DTensor on its mesh — the reference's elastic
    restore: a state saved from any number of ranks restores onto any
    other, since a checkpoint holds whole tensors;
  * a tree of DTensor leaves (a sharded run) is gathered whole on save,
    every rank taking part, and written once, by rank 0;
  * `AsyncCheckpointer` copies to the host on the caller's thread and
    writes on a writer thread, so training does not wait on the disk.

The saved `step` is what a restarted run resumes from
(`runtime/ft.DataSkipAhead`).
"""

from __future__ import annotations

import json
import pathlib
import queue
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import tree as tree_util
from repro_torch.core.parallelism import is_dtensor, place, sharding_leaves
from repro_torch.device import DeviceLike, resolve_device

PyTree = Any


def _host(leaf) -> np.ndarray:
    if is_dtensor(leaf):  # a collective: every rank of its mesh gathers
        leaf = leaf.full_tensor()
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _writer(tree: PyTree) -> bool:
    """Whether this process writes `tree`'s checkpoint: always, unless the
    tree is sharded (DTensor leaves) and this is not rank 0."""
    if not any(is_dtensor(leaf) for leaf in tree_util.leaves(tree)):
        return True
    import torch.distributed as dist

    return dist.get_rank() == 0


def save(directory: str | pathlib.Path, step: int, tree: PyTree, extra: Optional[dict] = None) -> pathlib.Path:
    """Synchronous checkpoint write.  Returns the step directory.  A
    sharded tree is gathered on every rank and written by rank 0; the
    ranks then wait for one another, so the checkpoint is visible to all
    when `save` returns."""
    directory = pathlib.Path(directory)
    final = directory / f"step_{step:08d}"
    if not _writer(tree):
        tree_util.tree_map(_host, tree)  # take part in the gathers
        import torch.distributed as dist

        dist.barrier()
        return final
    sharded = any(is_dtensor(leaf) for leaf in tree_util.leaves(tree))
    tmp = directory / f".tmp_step_{step:08d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)

    pairs = tree_util.flatten_with_path(tree)
    manifest = {
        "step": step,
        "treedef": f"{type(tree).__name__} ({len(pairs)} leaves, repro_torch.tree order)",
        "extra": extra or {},
        "leaves": [],
        "leaf_names": [name for name, _ in pairs],
    }
    for i, (_, leaf) in enumerate(pairs):
        arr = _host(leaf)
        fname = f"leaf_{i:05d}.npy"
        np.save(tmp / fname, arr)
        manifest["leaves"].append({"file": fname, "shape": list(arr.shape), "dtype": str(arr.dtype)})
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)  # atomic publish: partial checkpoints never visible
    if sharded:
        import torch.distributed as dist

        dist.barrier()
    return final


def latest_step(directory: str | pathlib.Path) -> Optional[int]:
    directory = pathlib.Path(directory)
    if not directory.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in directory.glob("step_*")]
    return max(steps) if steps else None


def restore(directory: str | pathlib.Path, template: PyTree, step: Optional[int] = None,
            device: DeviceLike = None, shardings: Optional[PyTree] = None) -> tuple[PyTree, int, dict]:
    """Restore into `template`'s structure (module docstring); returns
    (tree, step, extra).  `step=None` takes the latest.  With `shardings`
    (the same structure, `NamedSharding` leaves) every leaf becomes a
    DTensor laid out per its sharding, on the device its mesh runs on;
    each rank reads the whole file and keeps its shard (no collective)."""
    directory = pathlib.Path(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    d = directory / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())

    leaves = tree_util.leaves(template)
    if len(leaves) != len(manifest["leaves"]):
        raise ValueError(
            f"checkpoint has {len(manifest['leaves'])} leaves, template has {len(leaves)} — structure changed?")
    dev = None if device is None else resolve_device(device)
    sh_leaves = None if shardings is None else sharding_leaves(shardings)
    if sh_leaves is not None and len(sh_leaves) != len(leaves):
        raise ValueError(f"{len(sh_leaves)} shardings for a template of {len(leaves)} leaves")
    out_leaves = []
    for i, (meta, tmpl) in enumerate(zip(manifest["leaves"], leaves)):
        arr = np.load(d / meta["file"])
        shape = tuple(tmpl.shape) if hasattr(tmpl, "shape") else tuple(np.shape(tmpl))
        if tuple(arr.shape) != shape:
            raise ValueError(f"leaf {i} shape {arr.shape} != template {shape}")
        if sh_leaves is not None:
            out_leaves.append(place(torch.from_numpy(arr), sh_leaves[i], src_data_rank=None))
        elif dev is None and not isinstance(tmpl, torch.Tensor):
            out_leaves.append(arr)
        else:
            out_leaves.append(torch.from_numpy(arr).to(dev or tmpl.device))
    return tree_util.unflatten(template, out_leaves), step, manifest["extra"]


def prune(directory: str | pathlib.Path, keep: int = 3) -> None:
    directory = pathlib.Path(directory)
    steps = sorted(directory.glob("step_*"))
    for p in steps[:-keep]:
        shutil.rmtree(p)


class AsyncCheckpointer:
    """Background writer thread: save() enqueues host copies and returns."""

    def __init__(self, directory: str | pathlib.Path, keep: int = 3):
        self.directory = pathlib.Path(directory)
        self.keep = keep
        self._q: queue.Queue = queue.Queue(maxsize=2)
        self._err: Optional[Exception] = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            step, host_tree, extra = item
            try:
                save(self.directory, step, host_tree, extra)
                prune(self.directory, self.keep)
            except Exception as e:  # surfaced on the next save or close
                self._err = e

    def save(self, step: int, tree: PyTree, extra: Optional[dict] = None):
        if self._err is not None:
            raise RuntimeError("async checkpoint failed") from self._err
        # the copy to the host happens on the caller's thread (it waits for
        # the device; a sharded tree is gathered there, every rank taking
        # part), the file IO on the writer thread, of rank 0 only
        host = tree_util.tree_map(_host, tree)
        if _writer(tree):
            self._q.put((step, host, extra))

    def close(self):
        self._q.put(None)
        self._thread.join()
        if self._err is not None:
            raise RuntimeError("async checkpoint failed") from self._err


__all__ = ["save", "latest_step", "restore", "prune", "AsyncCheckpointer"]
