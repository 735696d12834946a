"""LR schedules as step → multiplier functions (port of
``repro.optim.schedules``): each takes an int step tensor and returns a
float32 tensor, with the reference's float32 operations in its order."""

from __future__ import annotations

import math

import torch

__all__ = ["linear_warmup", "cosine_schedule"]


def linear_warmup(warmup_steps: int):
    def f(step: torch.Tensor) -> torch.Tensor:
        return torch.clamp(step.float() / max(warmup_steps, 1), max=1.0)
    return f


def cosine_schedule(warmup_steps: int, total_steps: int, final_frac: float = 0.1):
    def f(step: torch.Tensor) -> torch.Tensor:
        s = step.float()
        warm = torch.clamp(s / max(warmup_steps, 1), max=1.0)
        prog = torch.clamp((s - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = final_frac + (1.0 - final_frac) * 0.5 * (1.0 + torch.cos(math.pi * prog))
        return warm * cos
    return f
