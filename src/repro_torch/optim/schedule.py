"""LR schedules as step -> multiplier callables (port of
`repro.optim.schedule`; compose with `AdamConfig.schedule`).

Each returns a 0-d float32 tensor on the step's own device and reads
nothing on the host, so a schedule can run inside a captured CUDA graph.
Constants are device fills and divisors are tensors: PyTorch's CUDA
division by a Python number multiplies by its rounded reciprocal, which is
not the reference's IEEE quotient.
"""

from __future__ import annotations

import math

import torch

from repro_torch.numerics import sqrt_rn

Tensor = torch.Tensor


def _f32(step) -> Tensor:
    return torch.as_tensor(step).to(torch.float32)


def _const(v: float, like: Tensor) -> Tensor:
    return torch.full((), v, dtype=torch.float32, device=like.device)


def constant():
    return lambda step: _const(1.0, _f32(step))


def linear_warmup(warmup_steps: int):
    def f(step):
        s = _f32(step)
        return torch.minimum(_const(1.0, s), s / _const(max(1, warmup_steps), s))

    return f


def warmup_cosine(warmup_steps: int, total_steps: int, final_frac: float = 0.1):
    def f(step):
        s = _f32(step)
        warm = torch.minimum(_const(1.0, s), s / _const(max(1, warmup_steps), s))
        progress = (s - warmup_steps) / _const(max(1, total_steps - warmup_steps), s)
        progress = torch.minimum(torch.maximum(progress, _const(0.0, s)), _const(1.0, s))
        # the reference folds (1 - final_frac) * 0.5 in Python double first
        cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * progress))
        return warm * cos

    return f


def warmup_rsqrt(warmup_steps: int):
    def f(step):
        s = _f32(step)
        s = torch.maximum(s, _const(1.0, s))
        return torch.minimum(s / _const(max(1, warmup_steps), s), sqrt_rn(_const(warmup_steps, s)) / sqrt_rn(s))

    return f


__all__ = ["constant", "linear_warmup", "warmup_cosine", "warmup_rsqrt"]
