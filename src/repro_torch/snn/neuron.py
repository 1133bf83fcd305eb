"""Neuron dynamics (port of ``repro.snn.neuron``): LIF and the AdEx model
of the HICANN-X neuron circuit.  Parameters are per-neuron tensors
(leading chip axis in the network); spikes are f32 0/1 from the Heaviside
of ``v - threshold``, with the surrogate gradient of
:mod:`repro_torch.snn.surrogate` for training.

:func:`lif_step` runs the ``lif_step`` kernel on CUDA tensors and its
plain version on CPU tensors, inside one ``torch.autograd.Function``
whose backward is the reference's VJP under the surrogate, written as
plain elementwise torch (the reference has no backward kernel).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels.lif_step import ops as lif_ops
from repro_torch.snn.surrogate import spike_surrogate, surrogate_scale

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


class _LIFStep(torch.autograd.Function):
    """Forward: the ``lif_step`` kernel (or its plain version on the CPU).
    Backward: the VJP of the reference's ``neuron.lif_step`` with
    respect to ``v``, ``current``, ``tau_m``, ``v_th``, ``v_reset`` and
    ``v_rest``, the spike's derivative taken from the surrogate."""

    @staticmethod
    def forward(ctx, v, refrac, current, tau_m, v_th, v_reset, v_rest,
                refrac_period):
        v_new, refrac_new, spikes = lif_ops.lif_step(
            v, refrac, current, tau_m, v_th, v_reset, v_rest, refrac_period)
        ctx.mark_non_differentiable(refrac_new)
        ctx.save_for_backward(v, refrac, current, tau_m, v_th, v_rest,
                              spikes)
        return v_new, refrac_new, spikes

    @staticmethod
    def backward(ctx, g_v, _g_refrac, g_s):
        v, refrac, current, tau_m, v_th, v_rest, spikes = ctx.saved_tensors
        decay = torch.exp(-1.0 / tau_m)
        active = refrac <= 0
        d = v - v_rest
        v_int = torch.where(active, v_rest + decay * d + current, v)
        spiked = spikes > 0.5
        gx = g_s * active.to(g_s.dtype) * surrogate_scale(v_int - v_th)
        g_reset = torch.where(spiked, g_v, 0.0)
        g_int = torch.where(spiked, 0.0, g_v) + gx
        g_a = torch.where(active, g_int, 0.0)
        g_in = torch.where(active, 0.0, g_int) + g_a * decay
        g_tau = g_a * d * decay / (tau_m * tau_m)
        return (g_in, None, g_a, g_tau, -gx, g_reset, g_a - g_a * decay,
                None)


def lif_step(state: LIFState, current: torch.Tensor, params: LIFParams
             ) -> tuple[LIFState, torch.Tensor]:
    """One Euler step; returns ``(state, spikes)``."""
    shape = torch.broadcast_shapes(state.v.shape, current.shape)
    v, refrac, spikes = _LIFStep.apply(*(
        x.broadcast_to(shape) for x in (
            state.v, state.refrac, current, params.tau_m, params.v_th,
            params.v_reset, params.v_rest, params.refrac)))
    return LIFState(v=v, refrac=refrac), spikes


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
    spikes = spike_surrogate(v - p.v_peak) * active.to(v.dtype)
    spiked = spikes > 0.5
    v_new = torch.where(spiked, p.v_reset, torch.minimum(v, p.v_peak + 1.0))
    w_new = torch.where(spiked, w + p.b, w)
    refrac = torch.where(spiked, p.refrac,
                         torch.clamp(state.refrac - 1, min=0))
    return AdExState(v=v_new, w=w_new, refrac=refrac), spikes
