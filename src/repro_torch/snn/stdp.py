"""Pair-based STDP on the synapse crossbar (port of ``repro.snn.stdp``):
BSS-2's correlation sensors and PPU weight update as exponential traces
and two outer products per step, batched over leading (chip) axes::

    x_pre  <- x_pre  * exp(-1/tau_plus)  + pre_spikes
    x_post <- x_post * exp(-1/tau_minus) + post_spikes
    dW = a_plus * outer(x_pre, post) - a_minus * outer(pre, x_post_past)

Weights clip to ``[w_min, w_max]``.  The outer products are plain torch,
as the reference leaves them to XLA.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class STDPConfig:
    tau_plus: float = 10.0
    tau_minus: float = 10.0
    a_plus: float = 0.01
    a_minus: float = 0.012     # slight depression bias (stability)
    w_min: float = -1.0
    w_max: float = 1.0


class STDPState(NamedTuple):
    x_pre: torch.Tensor     # [..., n_inputs] eligibility trace of input rows
    x_post: torch.Tensor    # [..., n_neurons] trace of output columns


def init(n_inputs: int, n_neurons: int, *, batch_shape: tuple[int, ...] = (),
         device=None) -> STDPState:
    return STDPState(
        x_pre=torch.zeros(batch_shape + (n_inputs,), dtype=F32,
                          device=device),
        x_post=torch.zeros(batch_shape + (n_neurons,), dtype=F32,
                           device=device))


def _decay(tau: float) -> float:
    """``exp(-1 / tau)`` rounded to float32 as the reference rounds it,
    computed on the host (so every device multiplies by the same
    factor)."""
    return float(torch.exp(torch.tensor(-1.0 / tau, dtype=F32)))


def step(cfg: STDPConfig, state: STDPState, pre_spikes: torch.Tensor,
         post_spikes: torch.Tensor, w: torch.Tensor
         ) -> tuple[STDPState, torch.Tensor]:
    """``pre_spikes [..., n_inputs]``, ``post_spikes [..., n_neurons]``,
    ``w [..., n_inputs, n_neurons]``.  A same-step pre and post pair counts
    as pre-before-post: the potentiation trace includes the current pre,
    the depression trace excludes the current post."""
    pre = pre_spikes.to(F32)
    post = post_spikes.to(F32)
    x_pre = state.x_pre * _decay(cfg.tau_plus) + pre
    x_post_past = state.x_post * _decay(cfg.tau_minus)
    dw = (cfg.a_plus * (x_pre[..., :, None] * post[..., None, :])
          - cfg.a_minus * (pre[..., :, None] * x_post_past[..., None, :]))
    w_new = torch.clamp(w + dw, cfg.w_min, cfg.w_max)
    return STDPState(x_pre=x_pre, x_post=x_post_past + post), w_new
