"""LR schedules, ported from ``repro.optim.schedule``: pure functions of
the step, computed in f32 as the reference computes them."""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import OptimizerConfig


def warmup_cosine(oc: OptimizerConfig):
    """lr(step): linear warmup over ``warmup_steps`` (reaching the peak at
    step warmup_steps - 1), then a cosine decay to ``min_lr_ratio`` of the
    peak at ``total_steps``. ``step`` is an int or an integer tensor (the
    optimizer's on-device counter, so reading it needs no host sync); the
    result is an f32 tensor on the step's device."""
    def lr(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = torch.clamp((step + 1) / max(1, oc.warmup_steps), max=1.0)
        t = torch.clamp((step - oc.warmup_steps)
                        / max(1, oc.total_steps - oc.warmup_steps), 0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * t))
        frac = oc.min_lr_ratio + (1.0 - oc.min_lr_ratio) * cos
        return oc.lr * warm * frac
    return lr
