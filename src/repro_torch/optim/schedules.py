"""LR schedules (pure functions of the step), counterpart of
``repro.optim.schedules``: the same values, in fp32 torch scalars."""
from __future__ import annotations

import math

import torch


def warmup_cosine(step, *, base_lr=1.0, warmup=100, total=1000, min_frac=0.1):
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = torch.clamp(step / max(warmup, 1), max=1.0)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
    return base_lr * warm * cos


def constant(step, *, base_lr=1.0):
    return torch.as_tensor(base_lr, dtype=torch.float32)


SCHEDULES = {"warmup_cosine": warmup_cosine, "constant": constant}
