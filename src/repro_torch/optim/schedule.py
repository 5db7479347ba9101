"""LR schedules (warmup + cosine / rsqrt), port of `repro.optim.schedule`.

Each takes the step as an int or a 0-d tensor and returns a 0-d float32
tensor on the step's device, computed in float32 in the reference's
order of operations (no host sync when the step lives on the card).
"""
from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def warmup_cosine(step, *, peak_lr: float, warmup: int, total: int,
                  floor: float = 0.1) -> torch.Tensor:
    step = _f32(step)
    warm = peak_lr * step / max(1.0, warmup)
    prog = torch.clamp((step - warmup) / max(1.0, total - warmup), 0, 1)
    cos = peak_lr * (floor + (1 - floor) * 0.5
                     * (1 + torch.cos(math.pi * prog)))
    return torch.where(step < warmup, warm, cos)


def warmup_rsqrt(step, *, peak_lr: float, warmup: int) -> torch.Tensor:
    step = _f32(step)
    warm = peak_lr * step / max(1.0, warmup)
    decay = peak_lr * torch.sqrt(warmup / torch.clamp(step, min=warmup))
    return torch.where(step < warmup, warm, decay)
