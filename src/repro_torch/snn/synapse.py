"""Synapse crossbar (port of ``repro.snn.synapse``): the HICANN-X
256-row x 512-column array.  The delay ring yields a per-step input
spike-count vector and the crossbar is a matrix product with the
``[n_inputs, n_neurons]`` weights (batched over chips).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Crossbar(NamedTuple):
    """w : f32[..., n_inputs, n_neurons] signed synaptic weights."""

    w: torch.Tensor

    @property
    def n_inputs(self) -> int:
        return self.w.shape[-2]

    @property
    def n_neurons(self) -> int:
        return self.w.shape[-1]


def init_crossbar(generator: torch.Generator, n_inputs: int, n_neurons: int,
                  *, scale: float = 0.3, batch_shape: tuple[int, ...] = (),
                  device=None) -> Crossbar:
    """Normal weights with standard deviation ``scale``, drawn from a CPU
    ``generator``."""
    w = scale * torch.randn(batch_shape + (n_inputs, n_neurons),
                            generator=generator)
    return Crossbar(w=w.to(device))


def currents(crossbar: Crossbar, input_spikes: torch.Tensor) -> torch.Tensor:
    """Spike counts ``[..., n_inputs]`` -> currents ``[..., n_neurons]``."""
    x = input_spikes.to(crossbar.w.dtype).unsqueeze(-2)
    return torch.matmul(x, crossbar.w).squeeze(-2)
