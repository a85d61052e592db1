"""Mesh builders (port of `repro.launch.mesh`).

Defined as functions, not module constants, so importing this module never
touches device state.  A mesh spans real devices when there are enough of
them and is a layout only (`Mesh.devices is None`) otherwise: the rules of
`core.parallelism` need only the axis sizes, so a layout is enough to ask
which tensor dims a production mesh would shard.
"""

from __future__ import annotations

import contextlib
import math
from typing import Iterator, Optional, Sequence

import torch

from repro_torch.core.parallelism import _AMBIENT, Mesh
from repro_torch.device import DeviceLike, resolve_device


def _cuda_devices(n: int) -> Optional[list[torch.device]]:
    """The first n CUDA devices, or None when fewer are visible."""
    if torch.cuda.is_available() and torch.cuda.device_count() >= n:
        return [torch.device("cuda", i) for i in range(n)]
    return None


def make_auto_mesh(shape: Sequence[int], axes: Sequence[str]) -> Mesh:
    """A mesh of `shape` over `axes`: on the first visible CUDA devices when
    there are enough, else a layout only."""
    return Mesh(shape, axes, _cuda_devices(math.prod(shape)))


@contextlib.contextmanager
def mesh_context(mesh: Mesh) -> Iterator[Mesh]:
    """Put `mesh` in scope for `core.parallelism.ambient_mesh` (and so for
    `constrain`) inside the `with` block; contexts nest."""
    token = _AMBIENT.set(mesh)
    try:
        yield mesh
    finally:
        _AMBIENT.reset(token)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production layout: a single TPU pod slice
    (data=16, model=16) = 256 chips, or two pods (pod=2, data=16,
    model=16) = 512 chips, `pod` composing with `data` for hierarchical
    data parallelism.  A layout, not hardware the port has: on anything
    short of that many CUDA devices it carries no devices, and serves to
    hold the rules' shardings to the reference's."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_auto_mesh(shape, axes)


def make_serve_mesh(n_data: Optional[int] = None, *, device: DeviceLike = None) -> Mesh:
    """Policy-serving mesh: one `data` axis over the visible devices.

    The DDPG policy net is tiny, so scale-out is pure data parallelism —
    `serve/policy` splits the micro-batch axis across this mesh and keeps
    the weights replicated.  On the card (`device=None`) it spans
    `n_data` CUDA devices, every visible one by default; with
    `device="cpu"` it spans `n_data` (default 1) CPU placements, which run
    the same split on the CPU.  One device makes the split a no-op, the
    same code path."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        n = 1 if n_data is None else int(n_data)
        return Mesh((n,), ("data",), [dev] * n)
    count = torch.cuda.device_count()
    n = count if n_data is None else int(n_data)
    if n > count:
        raise ValueError(f"a serve mesh of {n} devices, but {count} CUDA devices are visible")
    return Mesh((n,), ("data",), [torch.device("cuda", i) for i in range(n)])


def make_debug_mesh(n_data: int = 2, n_model: int = 4, *, multi_pod: bool = False) -> Mesh:
    """Small mesh for sharding tests: (data, model), or (pod=2, data,
    model) — a layout only unless that many CUDA devices are visible."""
    if multi_pod:
        shape, axes = (2, n_data, n_model), ("pod", "data", "model")
    else:
        shape, axes = (n_data, n_model), ("data", "model")
    return make_auto_mesh(shape, axes)


__all__ = ["make_auto_mesh", "mesh_context", "make_production_mesh", "make_serve_mesh", "make_debug_mesh"]
