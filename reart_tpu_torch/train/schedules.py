"""Temperature schedules (reart_tpu/train/schedules.py)."""

from __future__ import annotations

import math

import torch


def tau_cosine(cur_iter, max_iter: int, end_temp: float,
               start_temp: float) -> torch.Tensor:
    """Cosine Gumbel-softmax temperature, start -> end over max_iter, in
    float32 as the reference computes it (called with cur_iter = i + 1)."""
    frac = torch.as_tensor(cur_iter, dtype=torch.float32) / max_iter
    return end_temp + (start_temp - end_temp) * (
        torch.cos(math.pi * frac) + 1.0) * 0.5
