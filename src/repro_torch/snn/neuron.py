"""Neuron dynamics, forward only (port of ``repro.snn.neuron``): LIF and
the AdEx model of the HICANN-X neuron circuit.  Parameters are per-neuron
tensors (leading chip axis in the network); spikes are f32 0/1 from the
Heaviside of ``v - threshold``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

F32 = torch.float32
I32 = torch.int32


class LIFParams(NamedTuple):
    tau_m: torch.Tensor
    v_th: torch.Tensor
    v_reset: torch.Tensor
    v_rest: torch.Tensor
    refrac: torch.Tensor   # int32


class LIFState(NamedTuple):
    v: torch.Tensor
    refrac: torch.Tensor   # int32


def _spike(x: torch.Tensor) -> torch.Tensor:
    return (x > 0).to(x.dtype)


def lif_params(n: int, *, tau_m=10.0, v_th=1.0, v_reset=0.0, v_rest=0.0,
               refrac=2, device=None) -> LIFParams:
    f = lambda x: torch.full((n,), x, dtype=F32, device=device)
    return LIFParams(tau_m=f(tau_m), v_th=f(v_th), v_reset=f(v_reset),
                     v_rest=f(v_rest),
                     refrac=torch.full((n,), refrac, dtype=I32,
                                       device=device))


def lif_init(params: LIFParams) -> LIFState:
    return LIFState(v=params.v_rest * torch.ones_like(params.tau_m),
                    refrac=torch.zeros(params.tau_m.shape, dtype=I32,
                                       device=params.tau_m.device))


def lif_step(state: LIFState, current: torch.Tensor, params: LIFParams
             ) -> tuple[LIFState, torch.Tensor]:
    """One Euler step; returns ``(state, spikes)``."""
    decay = torch.exp(-1.0 / params.tau_m)
    active = state.refrac <= 0
    v = torch.where(active,
                    params.v_rest + decay * (state.v - params.v_rest)
                    + current, state.v)
    spikes = _spike(v - params.v_th) * active.to(v.dtype)
    spiked = spikes > 0.5
    v_new = torch.where(spiked, params.v_reset, v)
    refrac = torch.where(spiked, params.refrac,
                         torch.clamp(state.refrac - 1, min=0))
    return LIFState(v=v_new, refrac=refrac), spikes


class AdExParams(NamedTuple):
    g_l: torch.Tensor
    e_l: torch.Tensor
    delta_t: torch.Tensor
    v_t: torch.Tensor
    v_peak: torch.Tensor
    v_reset: torch.Tensor
    tau_w: torch.Tensor
    a: torch.Tensor
    b: torch.Tensor
    c_m: torch.Tensor
    refrac: torch.Tensor   # int32


class AdExState(NamedTuple):
    v: torch.Tensor
    w: torch.Tensor
    refrac: torch.Tensor   # int32


def adex_params(n: int, *, g_l=0.1, e_l=0.0, delta_t=0.2, v_t=0.8,
                v_peak=1.2, v_reset=0.0, tau_w=50.0, a=0.02, b=0.05,
                c_m=1.0, refrac=2, device=None) -> AdExParams:
    f = lambda x: torch.full((n,), x, dtype=F32, device=device)
    return AdExParams(
        g_l=f(g_l), e_l=f(e_l), delta_t=f(delta_t), v_t=f(v_t),
        v_peak=f(v_peak), v_reset=f(v_reset), tau_w=f(tau_w), a=f(a),
        b=f(b), c_m=f(c_m),
        refrac=torch.full((n,), refrac, dtype=I32, device=device))


def adex_init(params: AdExParams) -> AdExState:
    return AdExState(v=params.e_l * torch.ones_like(params.g_l),
                     w=torch.zeros_like(params.g_l),
                     refrac=torch.zeros(params.g_l.shape, dtype=I32,
                                        device=params.g_l.device))


def adex_step(state: AdExState, current: torch.Tensor, params: AdExParams
              ) -> tuple[AdExState, torch.Tensor]:
    """One Euler step of AdEx, the exponential term clamped as in the
    reference; returns ``(state, spikes)``."""
    p = params
    active = state.refrac <= 0
    exp_term = p.g_l * p.delta_t * torch.exp(
        torch.clamp((state.v - p.v_t) / p.delta_t, -20.0, 10.0))
    dv = (-p.g_l * (state.v - p.e_l) + exp_term - state.w + current) / p.c_m
    dw = (p.a * (state.v - p.e_l) - state.w) / p.tau_w
    v = torch.where(active, state.v + dv, state.v)
    w = state.w + dw
    spikes = _spike(v - p.v_peak) * active.to(v.dtype)
    spiked = spikes > 0.5
    v_new = torch.where(spiked, p.v_reset, torch.minimum(v, p.v_peak + 1.0))
    w_new = torch.where(spiked, w + p.b, w)
    refrac = torch.where(spiked, p.refrac,
                         torch.clamp(state.refrac - 1, min=0))
    return AdExState(v=v_new, w=w_new, refrac=refrac), spikes
