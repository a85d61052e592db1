"""Profiler spans over a region of the model, forward and backward.

`spanned(name, fn, *xs)` runs `fn(*xs)` inside
`torch.profiler.record_function(name)`, and places two identity autograd
nodes around it: the one on the region's outputs opens a range of the same
name in the backward when their gradients arrive, the one on its inputs
closes it when the inputs' gradients leave.  So the device work that the
region's forward and backward launch lies inside ranges called `name`, on
the thread that launches it (the backward runs on autograd's own thread).
A range nested in another is its own: a reader attributes a kernel to the
innermost range around its launch.

Spans cost nothing when no profiler records: `spanned` is then `fn(*xs)`.
The span names the LM training path opens (`models.layers`,
`models.moe`): "lm.mla.attend", "lm.moe.route", "lm.moe.dispatch",
"lm.moe.experts", "lm.qat.site".
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


class _Open(torch.autograd.Function):
    """Identity on the region's inputs; its backward closes the range."""

    @staticmethod
    def forward(ctx, box, *xs):
        ctx.box = box
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        if ctx.box["handle"] is not None:
            torch.ops.profiler._record_function_exit._RecordFunction(ctx.box["handle"])
            ctx.box["handle"] = None
        return (None, *grads)


class _Close(torch.autograd.Function):
    """Identity on the region's outputs; its backward opens the range."""

    @staticmethod
    def forward(ctx, box, *ys):
        ctx.box = box
        return tuple(y.view_as(y) for y in ys)

    @staticmethod
    def backward(ctx, *grads):
        if ctx.box["handle"] is None:
            ctx.box["handle"] = torch.ops.profiler._record_function_enter_new(ctx.box["name"], None)
        return (None, *grads)


def recording() -> bool:
    return torch.autograd._profiler_enabled()


def spanned(name: str, fn, *xs: Tensor):
    """`fn(*xs)` inside a range `name`, its backward too (module
    docstring).  `xs` are tensors; `fn` returns a tensor or a tuple of
    tensors.  The backward range is placed only when every input takes a
    gradient, so that the node that closes it runs."""
    if not recording():
        return fn(*xs)
    grad = torch.is_grad_enabled() and all(x.requires_grad for x in xs)
    box = {"name": name, "handle": None}
    if grad:
        xs = _Open.apply(box, *xs)
    with torch.profiler.record_function(name):
        out = fn(*xs)
    single = isinstance(out, Tensor)
    outs = [out] if single else list(out)
    diff = [i for i, y in enumerate(outs) if grad and y.requires_grad]
    if diff:
        for i, y in zip(diff, _Close.apply(box, *(outs[i] for i in diff))):
            outs[i] = y
    return outs[0] if single else tuple(outs)


__all__ = ["spanned", "recording"]
