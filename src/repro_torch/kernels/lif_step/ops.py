"""Wrapper of the LIF step kernel (``csrc/lif_step.cu``).

On CUDA tensors it launches the kernel, one thread per neuron; on CPU
tensors it runs :func:`repro_torch.kernels.lif_step.ref.lif_step_ref`.
Every argument broadcasts to the shape of ``v``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import common as kc
from repro_torch.kernels.lif_step.ref import lif_step_ref

NAME = "lif_step"
F32, I32 = torch.float32, torch.int32
_ARGTYPES = [kc.P] * 8 + [kc.LL] + [kc.P] * 4
_DTYPES = (F32, I32, F32, F32, F32, F32, F32, I32)


def lif_step(v, refrac, current, tau_m, v_th, v_reset, v_rest,
             refrac_period):
    """One LIF step; returns ``(v, refrac int32, spikes f32 0/1)`` of the
    shape of ``v``."""
    shape = v.shape
    args = [torch.as_tensor(x, device=v.device).broadcast_to(shape).to(dt)
            for x, dt in zip((v, refrac, current, tau_m, v_th, v_reset,
                              v_rest, refrac_period), _DTYPES)]
    if not v.is_cuda:
        return lif_step_ref(*args)
    args = [x.contiguous() for x in args]
    v_out = torch.empty(shape, dtype=F32, device=v.device)
    refrac_out = torch.empty(shape, dtype=I32, device=v.device)
    spikes = torch.empty(shape, dtype=F32, device=v.device)
    names = ("v", "refrac", "current", "tau_m", "v_th", "v_reset", "v_rest",
             "refrac_period")
    fn = kc.kernel_fn(NAME, "lif_step_launch", _ARGTYPES)
    kc.launch(NAME, fn,
              *(kc.check(x, name, dt, shape)
                for x, name, dt in zip(args, names, _DTYPES)),
              v_out.numel(), v_out.data_ptr(), refrac_out.data_ptr(),
              spikes.data_ptr())
    return v_out, refrac_out, spikes
