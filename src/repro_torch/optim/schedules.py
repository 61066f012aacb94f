"""Learning-rate schedules (counterpart of ``repro/optim/schedules.py``):
functions of the step counter returning an fp32 0-d tensor on the
counter's device, computed in fp32 as the reference computes them.  The
optimizer keeps its counter on the params' device, so a training step reads
no host value and can be captured as a CUDA graph."""

from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def constant_schedule(lr: float):
    return lambda step: torch.full((), lr, dtype=torch.float32,
                                   device=torch.as_tensor(step).device)


def linear_schedule(lr: float, total_steps: int, warmup: int = 0,
                    lr_end: float = 0.0):
    def fn(step):
        step = _f32(step)
        warm = lr * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total_steps - warmup, 1), 0, 1)
        decay = lr + (lr_end - lr) * frac
        return torch.where(step < warmup, warm, decay)
    return fn


def cosine_schedule(lr: float, total_steps: int, warmup: int = 0,
                    lr_min: float = 0.0):
    def fn(step):
        step = _f32(step)
        warm = lr * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total_steps - warmup, 1), 0, 1)
        decay = lr_min + 0.5 * (lr - lr_min) * (1 + torch.cos(math.pi * frac))
        return torch.where(step < warmup, warm, decay)
    return fn
