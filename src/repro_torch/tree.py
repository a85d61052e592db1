"""The port's state trees, walked in the reference's pytree order.

A state tree is what the port's engines and checkpoints hold: nested
dicts, lists, tuples and dataclasses (`rl.ddpg.DDPGState`,
`optim.adam.AdamState`, `core.qat.QATState`, `core.ranges.RangeStat`)
over tensors and numpy arrays.  `flatten_with_path` walks one in the order
`jax.tree_util.tree_flatten` walks the reference's registered dataclasses:
dataclass fields in declaration order, dict keys sorted, sequences in
order (a NamedTuple by field name).  Its leaves are tensors and numpy
arrays (numpy scalars included); `None`, Python scalars and strings are
static, as the reference's config fields (`QATConfig`, `FrozenQuant`'s
flags) are.  Paths are written as
`jax.tree_util.keystr` writes them (``.actor['l0']['b']``), so a
checkpoint of a port state names and orders its leaves as the reference's
checkpoint of the same state does.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterator

import numpy as np
import torch


def _is_leaf(x) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray, np.generic))


def _children(x) -> Iterator[tuple[str, Any]]:
    """(path suffix, child) of a container node, in pytree order."""
    if isinstance(x, dict):
        for k in sorted(x):
            yield f"[{k!r}]", x[k]
    elif isinstance(x, tuple) and hasattr(x, "_fields"):  # a NamedTuple
        for name, v in zip(x._fields, x):
            yield f".{name}", v
    elif isinstance(x, (list, tuple)):
        for i, v in enumerate(x):
            yield f"[{i}]", v
    elif dataclasses.is_dataclass(x) and not isinstance(x, type):
        for f in dataclasses.fields(x):
            yield f".{f.name}", getattr(x, f.name)


def flatten_with_path(tree, prefix: str = "") -> list[tuple[str, Any]]:
    """Every leaf of `tree` with its key path, in pytree order."""
    if _is_leaf(tree):
        return [(prefix, tree)]
    return [pair for suffix, child in _children(tree) for pair in flatten_with_path(child, prefix + suffix)]


def leaves(tree) -> list:
    """The leaves of `tree`, in pytree order."""
    return [leaf for _, leaf in flatten_with_path(tree)]


def unflatten(template, new_leaves) -> Any:
    """`template` with its leaves replaced, in pytree order, by
    `new_leaves`; raises when the counts differ."""
    it = iter(new_leaves)

    def build(x):
        if _is_leaf(x):
            try:
                return next(it)
            except StopIteration:
                raise ValueError("fewer leaves than the template has") from None
        if isinstance(x, dict):
            built = {k: build(x[k]) for k in sorted(x)}  # leaves in sorted order,
            return {k: built[k] for k in x}  # the keys in the template's
        if isinstance(x, (list, tuple)):
            out = [build(v) for v in x]
            return type(x)(*out) if hasattr(x, "_fields") else type(x)(out)
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            return dataclasses.replace(x, **{f.name: build(getattr(x, f.name)) for f in dataclasses.fields(x)})
        return x

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template has")
    return out


def tree_map(fn, tree) -> Any:
    """`fn` over every leaf of `tree`, the structure kept."""
    return unflatten(tree, [fn(leaf) for leaf in leaves(tree)])


__all__ = ["flatten_with_path", "leaves", "unflatten", "tree_map"]
