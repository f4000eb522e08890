"""Learning-rate schedules (functions of the step count, a python number or
a tensor), counterpart of ``repro/optim/schedules.py``."""
from __future__ import annotations

import math

import torch


def constant(lr):
    return lambda step: torch.as_tensor(lr, dtype=torch.float32)


def cosine_warmup(peak_lr, warmup_steps, total_steps, min_ratio=0.1):
    def fn(step):
        s = torch.as_tensor(step).float()
        warm = peak_lr * torch.clamp((s + 1) / max(warmup_steps, 1), max=1.0)
        frac = torch.clamp((s - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0, 1)
        cos = peak_lr * (min_ratio + (1 - min_ratio) * 0.5
                         * (1 + torch.cos(math.pi * frac)))
        return torch.where(s < warmup_steps, warm, cos)
    return fn
