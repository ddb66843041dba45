"""Learning-rate schedules (callables step → lr) — the port of
``repro.optim.schedules``. ``step`` is a tensor of step counts (one per
agent in the trainers); the result is an fp32 tensor of its shape."""
from __future__ import annotations

import math

import torch


def constant_schedule(lr: float):
    def fn(step):
        return torch.full_like(step, lr, dtype=torch.float32)
    return fn


def cosine_schedule(peak: float, total_steps: int, floor: float = 0.0):
    def fn(step):
        frac = torch.clamp(step.to(torch.float32) / total_steps, 0.0, 1.0)
        return floor + 0.5 * (peak - floor) * (1 + torch.cos(math.pi * frac))
    return fn


def warmup_cosine(peak: float, warmup: int, total_steps: int,
                  floor: float = 0.0):
    def fn(step):
        s = step.to(torch.float32)
        warm = peak * s / max(warmup, 1)
        frac = torch.clamp((s - warmup) / max(total_steps - warmup, 1),
                           0.0, 1.0)
        cos = floor + 0.5 * (peak - floor) * (1 + torch.cos(math.pi * frac))
        return torch.where(s < warmup, warm, cos)
    return fn
