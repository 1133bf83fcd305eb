"""LR schedules, pure functions of the step counter
(``repro.optim.schedules``), float32 tensors as in the reference."""

from __future__ import annotations

import math

import torch

F32 = torch.float32


def warmup_cosine(step, *, peak_lr: float, warmup_steps: int,
                  total_steps: int, min_ratio: float = 0.1) -> torch.Tensor:
    """Linear warm-up to ``peak_lr``, then a cosine down to ``min_ratio``
    of it at ``total_steps``.  ``step`` is an int or a tensor; the result
    is a float32 scalar tensor on its device."""
    step = torch.as_tensor(step).to(F32)
    warm = peak_lr * step / max(warmup_steps, 1)
    progress = torch.clamp(
        (step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = peak_lr * (min_ratio + (1 - min_ratio) * 0.5 *
                     (1 + torch.cos(math.pi * progress)))
    return torch.where(step < warmup_steps, warm, cos)


def constant(step, *, peak_lr: float, **_) -> torch.Tensor:
    step = torch.as_tensor(step)
    return torch.tensor(peak_lr, dtype=F32, device=step.device)
