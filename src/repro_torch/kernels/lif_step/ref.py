"""Plain PyTorch version of the LIF step (``repro.kernels.lif_step.ref.
lif_step_ref``): forward semantics of ``snn.neuron.lif_step``, every
operation rounded on its own."""

from __future__ import annotations

import torch


def lif_step_ref(v, refrac, current, tau_m, v_th, v_reset, v_rest,
                 refrac_period):
    """Returns ``(v, refrac int32, spikes f32 0/1)``."""
    decay = torch.exp(-1.0 / tau_m)
    active = refrac <= 0
    v_int = torch.where(active, v_rest + decay * (v - v_rest) + current, v)
    spiked = (v_int > v_th) & active
    v_new = torch.where(spiked, v_reset, v_int)
    refrac_new = torch.where(spiked, refrac_period,
                             torch.clamp(refrac - 1, min=0))
    return v_new, refrac_new.to(torch.int32), spiked.to(v.dtype)
