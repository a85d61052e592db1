"""Mesh builders (port of `repro.launch.mesh`).

Defined as functions, not module constants, so importing this module never
touches device state.  When a process group is up (`init_distributed`),
`make_auto_mesh` and `make_debug_mesh` build a `torch.distributed`
`DeviceMesh` over its ranks, one device per rank, and the world must have
the mesh's size.  Without one, a mesh spans real devices when there are
enough of them and is a layout only (`Mesh.devices is None`) otherwise:
the rules of `core.parallelism` need only the axis sizes, so a layout is
enough to ask which tensor dims a production mesh would shard.  The
production layouts (256 and 512 devices) run only on a fake world
(`init_fake_world`): a "fake" process group of that many ranks in one
process, at rank 0, whose collectives move nothing — the counterpart of
the reference's forced host devices, for `launch.dryrun` under fake
tensors.  Without one they are layouts, and asked to run, they raise.

One process per rank, as `torch.distributed.run` starts them:

  PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 8 \
      -m repro_torch.launch.train --smoke --device cpu --mesh debug

Rank r computes on `cuda:(r % local world)` on the card (backend `nccl`)
and on the CPU under `device="cpu"` (backend `gloo`).  A mesh over the
group lies on the device the group was started for.
"""

from __future__ import annotations

import contextlib
import math
import os
from typing import Any, Iterator, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.core.parallelism import _AMBIENT, Mesh
from repro_torch.device import DeviceLike, resolve_device

# the device the live process group computes on (`init_distributed`,
# `init_fake_world`): a mesh over the group lies there
_GROUP_DEVICE: Optional[torch.device] = None


def _cuda_devices(n: int) -> Optional[list[torch.device]]:
    """The first n CUDA devices, or None when fewer are visible."""
    if torch.cuda.is_available() and torch.cuda.device_count() >= n:
        return [torch.device("cuda", i) for i in range(n)]
    return None


def init_distributed(device: DeviceLike = None, *, store: Any = None, rank: Optional[int] = None,
                     world_size: Optional[int] = None) -> torch.device:
    """Join this process to its process group and return the device it
    computes on.

    With `store` (a `torch.distributed.Store`: a `FileStore` in the tests, a
    `HashStore` for a world of one) `rank` and `world_size` are given;
    without one they come from the launcher's environment (`RANK`,
    `WORLD_SIZE`, `MASTER_ADDR`, `MASTER_PORT`, as `torch.distributed.run`
    sets them).  The backend is `nccl` on the card, rank r on
    `cuda:(r % local world)`, and `gloo` on the CPU.  A group already up is
    kept (its backend must match)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_WORLD_SIZE", torch.cuda.device_count()))
        r = rank if rank is not None else int(os.environ.get("RANK", 0))
        dev = torch.device("cuda", r % local)
        torch.cuda.set_device(dev)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    global _GROUP_DEVICE
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise RuntimeError(f"a {dist.get_backend()} process group is up; {dev} needs {backend}")
        _GROUP_DEVICE = dev
        return dev
    if store is not None:
        if rank is None or world_size is None:
            raise ValueError("a store needs rank= and world_size=")
        dist.init_process_group(backend, store=store, rank=rank, world_size=world_size)
    else:
        missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT") if k not in os.environ]
        if missing:
            raise RuntimeError(f"no process group to join: {', '.join(missing)} unset (start one process per "
                               "rank with python -m torch.distributed.run, or pass store=)")
        dist.init_process_group(backend, init_method="env://")
    _GROUP_DEVICE = dev
    return dev


def init_fake_world(world_size: int, device: DeviceLike = None) -> torch.device:
    """Start a "fake" process group of `world_size` ranks in this process,
    as rank 0, and return the device it computes on (`cuda:0` on the card,
    the CPU under `device="cpu"`).

    Every collective on it completes at once and moves nothing, so a
    sharded step runs rank 0's program alone; under fake tensors
    (`launch.dryrun`) that is the whole of a 256- or 512-rank run's shapes,
    collectives and memory, without data.  The group comes from
    `torch.testing._internal.distributed.fake_pg` (a torch-internal
    module, run on torch 2.11 and 2.13).  A fake group of this size
    already up is kept; any other group raises."""
    from torch.testing._internal.distributed.fake_pg import FakeStore  # registers the "fake" backend

    global _GROUP_DEVICE
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        if dist.get_backend() != "fake" or dist.get_world_size() != world_size:
            raise RuntimeError(f"a {dist.get_backend()} process group of {dist.get_world_size()} ranks is up; "
                               f"a fake world of {world_size} needs none")
    else:
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)
    _GROUP_DEVICE = dev
    return dev


def _device_mesh(shape: tuple, axes: tuple):
    """A `DeviceMesh` of `shape` over the live process group, or None when
    no group is up; raises when the world's size is not the mesh's, or
    when the group was not started here (`init_distributed`,
    `init_fake_world`), which leaves its device unknown."""
    if not (dist.is_available() and dist.is_initialized()):
        return None
    world = dist.get_world_size()
    if world != math.prod(shape):
        raise ValueError(f"a mesh of shape {shape} needs a world of {math.prod(shape)} ranks, got {world}")
    from torch.distributed.device_mesh import init_device_mesh

    if _GROUP_DEVICE is None:
        raise RuntimeError("the process group was not started by launch.mesh (init_distributed or "
                           "init_fake_world): its device is unknown")
    return init_device_mesh(_GROUP_DEVICE.type, shape, mesh_dim_names=axes)


def make_auto_mesh(shape: Sequence[int], axes: Sequence[str]) -> Mesh:
    """A mesh of `shape` over `axes`: over the process group's ranks when
    one is up (its world must have the mesh's size), else on the first
    visible CUDA devices when there are enough, else a layout only."""
    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    dm = _device_mesh(shape, axes)
    if dm is not None:
        return Mesh(shape, axes, [_rank_device(dm)] * math.prod(shape), device_mesh=dm)
    return Mesh(shape, axes, _cuda_devices(math.prod(shape)))


def _rank_device(dm) -> torch.device:
    if dm.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


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
    data parallelism.  Over the process group when one of its size is up
    (`init_fake_world`: `make_auto_mesh`); otherwise not hardware the port
    has: on anything short of that many CUDA devices it carries no
    devices, and serves to hold the rules' shardings to the reference's."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if dist.is_available() and dist.is_initialized() and dist.get_world_size() == math.prod(shape):
        return make_auto_mesh(shape, axes)
    return Mesh(shape, axes, _cuda_devices(math.prod(shape)))


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
    model) — over the process group when one is up (`make_auto_mesh`), else
    a layout only unless that many CUDA devices are visible."""
    if multi_pod:
        shape, axes = (2, n_data, n_model), ("pod", "data", "model")
    else:
        shape, axes = (n_data, n_model), ("data", "model")
    return make_auto_mesh(shape, axes)


__all__ = ["init_distributed", "init_fake_world", "make_auto_mesh", "mesh_context", "make_production_mesh",
           "make_serve_mesh", "make_debug_mesh"]
