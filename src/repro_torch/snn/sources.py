"""Spike sources (port of ``repro.snn.sources``): Poisson background
generators and regular spike trains, as HICANN-X's on-chip background
generators feed source populations."""

from __future__ import annotations

import torch

F32 = torch.float32


def poisson_spikes(generator: torch.Generator, rate, shape: tuple[int, ...],
                   *, device=None) -> torch.Tensor:
    """Bernoulli approximation of Poisson spiking at ``rate`` per step,
    drawn from ``generator`` (on the generator's device)."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    spikes = (u < torch.as_tensor(rate, device=u.device)).to(F32)
    return spikes if device is None else spikes.to(device)


def regular_spikes(t, period: int, shape: tuple[int, ...], phase: int = 0,
                   *, device=None) -> torch.Tensor:
    """Deterministic spike train with a fixed inter-spike interval."""
    fire = (torch.as_tensor(t, device=device) + phase) % period == 0
    return fire.to(F32).broadcast_to(shape).clone()


def step_current(t, onset: int, amplitude: float, shape: tuple[int, ...],
                 *, device=None) -> torch.Tensor:
    on = torch.as_tensor(t, device=device) >= onset
    return torch.where(on, amplitude, 0.0) * torch.ones(shape, dtype=F32,
                                                        device=device)
