"""Surrogate-gradient spike nonlinearity (port of ``repro.snn.surrogate``).

Forward: Heaviside ``x > 0`` (exact 0/1 spikes, as the hardware emits).
Backward: the SuperSpike surrogate ``g / (1 + beta |x|)^2`` [Zenke &
Ganguli 2018], so training backpropagates through the time loop.
"""

from __future__ import annotations

import torch

SURROGATE_BETA = 10.0


def surrogate_scale(x: torch.Tensor) -> torch.Tensor:
    """``1 / (1 + beta |x|)^2``, the surrogate's derivative at ``x``."""
    return 1.0 / (1.0 + SURROGATE_BETA * torch.abs(x)) ** 2


class SpikeSurrogate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return (x > 0).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * surrogate_scale(x)


def spike_surrogate(x: torch.Tensor) -> torch.Tensor:
    return SpikeSurrogate.apply(x)
