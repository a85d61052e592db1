"""Adaptive parallelism — FIXAR §V-B as logical-axis rules on a mesh (port
of `repro.core.parallelism`).

The AAP core runs the *same* PE array under two dataflows:

  * inference  -> intra-layer parallelism (columns of W interleaved across
                  cores; one vector finishes N× faster),
  * training   -> intra-batch parallelism (each core owns whole MVMs for
                  different batch elements).

On a mesh of devices the analogue is a *phase-dependent logical-axis rule
set*: the same parameter tree gets different shardings depending on
whether the train step or the serve step runs.  Models annotate every
parameter and activation with logical axes (`Logical`) and never name mesh
axes; `ShardingRules` maps logical axes to mesh axes — swap the rules,
swap the parallelism.

A spec is a plain tuple with one entry per tensor dim: `None`
(replicated), a mesh-axis name, or a tuple of names — entry for entry what
`tuple(jax.sharding.PartitionSpec(...))` holds in the reference.  The mesh
is the port's own `Mesh` (axis names, sizes and optionally the devices),
so the production layouts (16, 16) and (2, 16, 16) are held to the
reference's rules with no devices at all.

Logical axes used across the framework
--------------------------------------
  batch      global batch
  seq        sequence (activations)
  kv_seq     KV-cache / recurrence sequence dimension
  embed      d_model
  q_heads    query heads
  kv_heads   KV heads
  head_dim   per-head dim
  mlp        FFN hidden
  vocab      vocabulary
  experts    MoE expert dimension
  layers     stacked-layer dimension (never sharded)
  state      recurrent state channels (rwkv/rg-lru)

What the port does with a rule on a real mesh: a `Mesh` built while a
process group of its size is up (`launch.mesh.init_distributed`) carries a
`torch.distributed` `DeviceMesh`, and a `NamedSharding` on it yields
DTensor placements (`NamedSharding.placements`): a spec entry of None is
`Replicate()`, a mesh axis that shards tensor dim d is `Shard(d)` on that
mesh dim, and an axis tuple such as ("pod", "data") is `Shard(d)` on each
of its mesh dims, pod-major as in JAX.  `constrain` redistributes a DTensor
to the placements of its logical axes — the counterpart of
`with_sharding_constraint` — and `distribute_tree` lays a whole tree out.
`constrain` is a no-op without rules, outside a mesh, on a plain tensor, or
on a one-device mesh without a process group (one card, nothing to
shard); a mesh of more than one device with no process group behind it (a
layout only, or CUDA devices without a group) raises when asked to run:
no sharded path quietly runs unsharded.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
from typing import Any, Callable, Optional, Sequence, Union

import torch

from repro_torch import tree as tree_util

MeshAxes = Union[None, str, tuple[str, ...]]
Spec = tuple  # one MeshAxes entry per tensor dim


class Mesh:
    """A named, n-dimensional arrangement of devices (the counterpart of a
    JAX mesh, abstract or physical).

    `shape` maps each axis name to its size, in axis order, as a JAX mesh's
    `.shape` does.  `devices` is the flat, row-major list of
    `torch.device`s the mesh spans, or None for a layout only (a mesh the
    rules can be asked about but nothing can run on).  `device_mesh` is
    the `torch.distributed` `DeviceMesh` of a mesh built over a live
    process group (`launch.mesh`), the one sharded code runs on."""

    def __init__(self, axis_sizes: Sequence[int], axis_names: Sequence[str],
                 devices: Optional[Sequence[torch.device]] = None, device_mesh: Any = None):
        axis_sizes, axis_names = tuple(int(n) for n in axis_sizes), tuple(axis_names)
        if len(axis_sizes) != len(axis_names):
            raise ValueError(f"{len(axis_sizes)} axis sizes for {len(axis_names)} axis names")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"repeated axis name in {axis_names}")
        if any(n < 1 for n in axis_sizes):
            raise ValueError(f"axis sizes must be positive, got {axis_sizes}")
        self.axis_names = axis_names
        self.axis_sizes = axis_sizes
        self.shape = dict(zip(axis_names, axis_sizes))
        self.size = math.prod(axis_sizes)
        if devices is not None:
            devices = tuple(torch.device(d) for d in devices)
            if len(devices) != self.size:
                raise ValueError(f"a mesh of shape {axis_sizes} needs {self.size} devices, got {len(devices)}")
        self.devices = devices
        if device_mesh is not None and tuple(device_mesh.mesh.shape) != axis_sizes:
            raise ValueError(f"a DeviceMesh of shape {tuple(device_mesh.mesh.shape)} for a mesh of shape {axis_sizes}")
        self.device_mesh = device_mesh

    @property
    def is_layout_only(self) -> bool:
        return self.devices is None

    def runnable(self) -> Any:
        """The `DeviceMesh` this mesh runs on; raises for a mesh that
        cannot run sharded code (no process group of its size behind it)."""
        if self.device_mesh is None:
            raise RuntimeError(
                f"{self!r} has no process group behind it: a sharded run needs "
                "launch.mesh.init_distributed with a world of its size")
        return self.device_mesh

    def __repr__(self) -> str:
        where = "layout only" if self.devices is None else ", ".join(str(d) for d in self.devices)
        if self.device_mesh is not None:
            where += ", process group"
        return f"Mesh({self.shape}; {where})"


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the counterpart of `jax.sharding.NamedSharding`)."""

    mesh: Mesh
    spec: Spec

    def placements(self) -> tuple:
        """DTensor placements, one per mesh dim: `Shard(d)` on each mesh
        axis of more than one device that shards tensor dim d (an axis
        tuple shards d on each of its axes, in order), `Replicate()`
        elsewhere.  A mesh dim of size 1 holds the whole dim whatever the
        spec says (the rules put one kv head on a "model" axis of 1, since
        1 % 1 == 0), and DTensor's view ops refuse to merge or split a dim
        that is `Shard` even there: so it is `Replicate()`, which holds
        the same data on the same rank.  The spec stays the reference's."""
        from torch.distributed.tensor import Replicate, Shard

        dim_of = {}
        for d, entry in enumerate(self.spec):
            for name in (() if entry is None else (entry,) if isinstance(entry, str) else entry):
                dim_of[name] = d
        return tuple(Shard(dim_of[n]) if n in dim_of and self.mesh.shape[n] > 1 else Replicate()
                     for n in self.mesh.axis_names)


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """logical axis name -> mesh axis (or axes, or None = replicated).

    A logical axis may map to one mesh axis or to an axis tuple like
    ("pod", "data")."""

    rules: dict[str, MeshAxes]
    phase: str  # "train" | "serve" — documentation + assertions only

    def mesh_axes(self, logical: Sequence[Optional[str]],
                  shape: Optional[Sequence[int]] = None,
                  mesh: Optional[Any] = None) -> Spec:
        """Build a spec; if `shape` and `mesh` are given, drop mesh axes
        that do not evenly divide the corresponding dimension (e.g. 4 query
        heads cannot shard over model=16 — replicate instead).  `mesh` may
        be anything with a `.shape[axis]` lookup."""
        used: list[str] = []
        out = []
        for i, ax in enumerate(logical):
            m = self.rules.get(ax) if ax is not None else None
            if m is not None:
                flat = (m,) if isinstance(m, str) else tuple(m)
                if any(f in used for f in flat):
                    m = None
                elif shape is not None and mesh is not None:
                    total = 1
                    for f in flat:
                        total *= mesh.shape[f]
                    if shape[i] % total != 0:
                        m = None
                if m is not None:
                    used.extend(flat)
            out.append(m)
        return tuple(out)

    def spec(self, *logical: Optional[str]) -> Spec:
        return self.mesh_axes(logical)

    def named(self, mesh: Mesh, *logical: Optional[str]) -> NamedSharding:
        return NamedSharding(mesh, self.mesh_axes(logical))

    def named_for(self, mesh: Mesh, shape: Sequence[int], *logical: Optional[str]) -> NamedSharding:
        return NamedSharding(mesh, self.mesh_axes(logical, shape, mesh))


# ---------------------------------------------------------------------------
# Phase presets — the FIXAR dataflow switch
# ---------------------------------------------------------------------------

# Batch axes: on the multi-pod mesh the pod axis composes with data for
# hierarchical data parallelism.


def _batch_axes(mesh: Mesh) -> MeshAxes:
    return ("pod", "data") if "pod" in mesh.axis_names else "data"


def train_rules(mesh: Mesh, *, shard_seq: bool = False) -> ShardingRules:
    """Intra-batch parallelism (FIXAR training dataflow) + Megatron TP.

    batch over (pod,)data; contracting/feature dims over model.  No
    head_dim fallback in training: sharding head_dim makes the attention
    score product contract over a sharded axis (a per-layer reduction of
    the score tensor); the fallback lives in `serve_rules`."""
    return ShardingRules(
        rules={
            "batch": _batch_axes(mesh),
            "seq": "model" if shard_seq else None,  # sequence-parallel option
            "kv_seq": None,
            "embed": None,
            "q_heads": "model",
            "kv_heads": "model",
            "head_dim": None,
            "mlp": "model",
            "vocab": "model",
            "experts": "model",
            "exp_cap": "data",       # expert capacity dim follows tokens
            "expert_ffn": "data",    # ZeRO-style: expert d_ff over data
            "layers": None,
            "state": "model",
            "heads_rwkv": "model",
        },
        phase="train",
    )


def serve_rules(mesh: Mesh, *, shard_kv_seq: bool = False,
                prefer_head_dim: bool = False,
                shard_expert_ffn: bool = True) -> ShardingRules:
    """Intra-layer parallelism (FIXAR inference dataflow).

    Model (feature) dims over `model`; batch over `data`; for single-request
    long-context decode the KV cache / recurrence dim is sharded over `data`
    instead (sequence-parallel decode).

    `prefer_head_dim`: set when the arch's kv_heads does not divide the
    model axis — the KV cache can only shard on head_dim then, and the q
    projections follow that layout.

    `shard_expert_ffn`: ZeRO-shard expert weights over `data` (when the
    experts do not fit at model-parallel only)."""
    head_axes = ({"q_heads": None, "kv_heads": None, "head_dim": "model"}
                 if prefer_head_dim else
                 {"q_heads": "model", "kv_heads": "model", "head_dim": "model"})
    return ShardingRules(
        rules={
            "batch": None if shard_kv_seq else _batch_axes(mesh),
            "seq": None,
            "kv_seq": "data" if shard_kv_seq else None,
            "embed": None,
            **head_axes,
            "mlp": "model",
            "vocab": "model",
            "experts": "model",
            "exp_cap": "data" if not shard_kv_seq else None,
            "expert_ffn": "data" if shard_expert_ffn else None,
            "layers": None,
            "state": "model",
            "heads_rwkv": "model",
        },
        phase="serve",
    )


def rules_for(mesh: Mesh, phase: str, **kw) -> ShardingRules:
    if phase == "train":
        return train_rules(mesh, **kw)
    if phase == "serve":
        return serve_rules(mesh, **kw)
    raise ValueError(f"unknown phase {phase!r}")


# ---------------------------------------------------------------------------
# Applying rules to annotated trees
# ---------------------------------------------------------------------------


class Logical:
    """A tree-leaf annotation: the logical axes of one tensor."""

    __slots__ = ("axes",)

    def __init__(self, *axes: Optional[str]):
        self.axes = axes

    def __repr__(self):
        return f"Logical{self.axes}"

    def __eq__(self, other):
        return isinstance(other, Logical) and other.axes == self.axes

    def __hash__(self):
        return hash(self.axes)


def map_logical(fn: Callable, spec_tree, *other_trees):
    """`fn(logical, *others)` at every `Logical` leaf of `spec_tree`
    (dicts, lists, tuples and dataclasses), the structure kept; `other_trees` are walked
    alongside it (same structure, any leaves).  None, an optional field left
    out (`TrainState.router_bias`), stays None."""
    if isinstance(spec_tree, Logical):
        return fn(spec_tree, *other_trees)
    if spec_tree is None:
        return None
    if isinstance(spec_tree, dict):
        return {k: map_logical(fn, v, *(t[k] for t in other_trees)) for k, v in spec_tree.items()}
    if isinstance(spec_tree, (list, tuple)):
        return type(spec_tree)(map_logical(fn, v, *(t[i] for t in other_trees))
                               for i, v in enumerate(spec_tree))
    if dataclasses.is_dataclass(spec_tree) and not isinstance(spec_tree, type):  # e.g. a RangeStat
        return dataclasses.replace(spec_tree, **{
            f.name: map_logical(fn, getattr(spec_tree, f.name), *(getattr(t, f.name) for t in other_trees))
            for f in dataclasses.fields(spec_tree)})
    raise TypeError(f"not a Logical tree node: {type(spec_tree).__name__}")


def tree_shardings(spec_tree, mesh: Mesh, rules: ShardingRules, shape_tree=None):
    """Map a tree of `Logical` annotations to `NamedSharding`s.

    If `shape_tree` (the same tree of tensors, or of anything with a
    `.shape`) is given, shardings are divisibility-checked per leaf."""
    if shape_tree is None:
        return map_logical(lambda lg: rules.named(mesh, *lg.axes), spec_tree)
    return map_logical(lambda lg, s: rules.named_for(mesh, tuple(s.shape), *lg.axes), spec_tree, shape_tree)


def tree_pspecs(spec_tree, rules: ShardingRules):
    return map_logical(lambda lg: rules.mesh_axes(lg.axes), spec_tree)


_AMBIENT: contextvars.ContextVar[Optional[Mesh]] = contextvars.ContextVar("repro_torch_mesh", default=None)


def ambient_mesh() -> Optional[Mesh]:
    """The mesh currently in scope (`launch.mesh.mesh_context`), or None."""
    return _AMBIENT.get()


def constrain(x: torch.Tensor, rules: Optional[ShardingRules], *logical: Optional[str]) -> torch.Tensor:
    """Lay `x` out along its logical axes on the ambient mesh: a DTensor is
    redistributed to the placements its shape-checked spec gives.

    Returns `x` unchanged when `rules` is None, when no mesh is in scope,
    when `x` is a plain tensor, or when the mesh has one device and no
    process group — the case of one card, where every spec places the
    whole tensor on it.  A mesh of more than one device with no process
    group behind it raises (`Mesh.runnable`)."""
    if rules is None:
        return x
    mesh = ambient_mesh()
    if mesh is None or (mesh.device_mesh is None and mesh.size <= 1):
        return x
    dm = mesh.runnable()
    if not is_dtensor(x):
        return x
    return x.redistribute(dm, placements_for(mesh, rules, tuple(x.shape), logical))


@contextlib.contextmanager
def sharded_scope():
    """The context a sharded run's ops execute in: under a mesh with a
    process group, DTensor's implicit replication — a plain tensor that
    meets a DTensor (a position `arange`, a mask, a constant: values every
    rank builds whole) counts as replicated; otherwise nothing.  Unlike
    `implicit_replication`, it nests (the flag is restored, not cleared,
    on exit); the flag is thread-local and carried into the autograd
    engine's threads with the rest of the thread-local state."""
    mesh = ambient_mesh()
    if mesh is None or mesh.device_mesh is None:
        yield
        return
    before = torch._C._get_dtensor_allow_implicit_replication()
    torch._C._set_dtensor_allow_implicit_replication(True)
    try:
        yield
    finally:
        torch._C._set_dtensor_allow_implicit_replication(before)


def placements_for(mesh: Mesh, rules: ShardingRules, shape: Sequence[int], logical: Sequence[Optional[str]]):
    """The placements of a tensor of `shape` with these logical axes."""
    return NamedSharding(mesh, rules.mesh_axes(tuple(logical), tuple(shape), mesh)).placements()


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def replicated(x: torch.Tensor, device_mesh):
    """`x` as a DTensor replicated on `device_mesh`: a plain tensor that
    holds the same whole value on every rank is wrapped with no collective;
    a DTensor is returned as it is."""
    if is_dtensor(x):
        return x
    from torch.distributed.tensor import DTensor, Replicate

    return DTensor.from_local(x, device_mesh, [Replicate()] * device_mesh.ndim, run_check=False)


def sharding_leaves(shardings) -> list:
    """The `NamedSharding`s of a shardings tree (`tree_shardings`' output)
    in `repro_torch.tree`'s leaf order (dict keys sorted, sequences and
    dataclass fields in order): the order of the tree they lay out.  None,
    an optional field left out, has none."""
    if isinstance(shardings, NamedSharding):
        return [shardings]
    if shardings is None:
        return []
    if isinstance(shardings, dict):
        return [s for k in sorted(shardings) for s in sharding_leaves(shardings[k])]
    if isinstance(shardings, (list, tuple)):
        return [s for v in shardings for s in sharding_leaves(v)]
    if dataclasses.is_dataclass(shardings) and not isinstance(shardings, type):
        return [s for f in dataclasses.fields(shardings) for s in sharding_leaves(getattr(shardings, f.name))]
    raise TypeError(f"not a shardings tree node: {type(shardings).__name__}")


def place(leaf: torch.Tensor, sh: NamedSharding, *, src_data_rank: Optional[int] = 0):
    """`leaf` as a DTensor laid out per `sh`: a DTensor is redistributed; a
    plain tensor, the same whole tensor on every rank, is cut into shards
    (rank 0's copy scattered, or with `src_data_rank=None` each rank's own
    copy cut with no collective)."""
    from torch.distributed.tensor import distribute_tensor

    dm = sh.mesh.runnable()
    if is_dtensor(leaf):
        return leaf.redistribute(dm, sh.placements())
    return distribute_tensor(leaf.to(sh.mesh.devices[0]), dm, sh.placements(), src_data_rank=src_data_rank)


def distribute_tree(tree, shardings):
    """Every tensor leaf of `tree` laid out per the `NamedSharding` at the
    same place of `shardings` (`tree_shardings`' output), as a DTensor on
    the sharding's mesh.  Every rank passes the same full tensors."""
    return tree_util.unflatten(tree, [place(leaf, sh) for leaf, sh in
                                      zip(tree_util.leaves(tree), sharding_leaves(shardings), strict=True)])


def gather_tree(tree):
    """Every DTensor leaf of `tree` as the full plain tensor (a collective:
    every rank calls it); other leaves as they are."""
    return tree_util.tree_map(lambda leaf: leaf.full_tensor() if is_dtensor(leaf) else leaf, tree)


__all__ = ["Mesh", "NamedSharding", "ShardingRules", "Logical", "train_rules", "serve_rules",
           "rules_for", "map_logical", "tree_shardings", "tree_pspecs", "constrain", "placements_for",
           "sharded_scope", "is_dtensor", "replicated", "sharding_leaves", "place", "distribute_tree", "gather_tree",
           "ambient_mesh"]
