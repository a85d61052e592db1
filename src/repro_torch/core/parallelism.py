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

What the port does with a rule on a real mesh: `constrain` is a no-op
without rules, outside a mesh or on a one-device mesh (one H100 shards
nothing), and raises `NotImplementedError` on a mesh of more than one
device — moving a tensor across cards is the multi-card step (ROADMAP
queue 1), never silently skipped.
"""

from __future__ import annotations

import contextvars
import dataclasses
import math
from typing import Any, Callable, Optional, Sequence, Union

import torch

MeshAxes = Union[None, str, tuple[str, ...]]
Spec = tuple  # one MeshAxes entry per tensor dim


class Mesh:
    """A named, n-dimensional arrangement of devices (the counterpart of a
    JAX mesh, abstract or physical).

    `shape` maps each axis name to its size, in axis order, as a JAX mesh's
    `.shape` does.  `devices` is the flat, row-major list of
    `torch.device`s the mesh spans, or None for a layout only (a mesh the
    rules can be asked about but nothing can run on)."""

    def __init__(self, axis_sizes: Sequence[int], axis_names: Sequence[str],
                 devices: Optional[Sequence[torch.device]] = None):
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

    @property
    def is_layout_only(self) -> bool:
        return self.devices is None

    def __repr__(self) -> str:
        where = "layout only" if self.devices is None else ", ".join(str(d) for d in self.devices)
        return f"Mesh({self.shape}; {where})"


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the counterpart of `jax.sharding.NamedSharding`)."""

    mesh: Mesh
    spec: Spec


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
    alongside it (same structure, any leaves)."""
    if isinstance(spec_tree, Logical):
        return fn(spec_tree, *other_trees)
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
    """Lay `x` out along its logical axes on the ambient mesh.

    Returns `x` unchanged when `rules` is None, when no mesh is in scope, or
    when the mesh has one device — the case of one card, where every spec
    places the whole tensor on it.  On a mesh of more than one device the
    tensor would have to move across devices: that is the multi-card step
    (ROADMAP queue 1), so it raises rather than ignore the mesh."""
    if rules is None:
        return x
    mesh = ambient_mesh()
    if mesh is None or mesh.size <= 1:
        return x
    spec = rules.mesh_axes(logical, tuple(x.shape), mesh)
    raise NotImplementedError(
        f"constrain to {spec} on {mesh!r}: laying a tensor out across more than one device is not "
        "ported (ROADMAP queue 1, multi-card DTensor)")


__all__ = ["Mesh", "NamedSharding", "ShardingRules", "Logical", "train_rules", "serve_rules",
           "rules_for", "map_logical", "tree_shardings", "tree_pspecs", "constrain", "ambient_mesh"]
