"""Wrapper of the LIF step kernel (``csrc/lif_step.cu``).

On CUDA tensors it launches the kernel, one thread per neuron; on CPU
tensors it runs :func:`repro_torch.kernels.lif_step.ref.lif_step_ref`.
Every argument broadcasts to the shape of ``v``.  Arguments that are already CUDA tensors
of ``v``'s shape and type, contiguous (the network's call), go to the
launch as they are.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import common as kc
from repro_torch.kernels.lif_step.ref import lif_step_ref

NAME = "lif_step"
F32, I32 = torch.float32, torch.int32
_ARGTYPES = [kc.P] * 8 + [kc.LL] + [kc.P] * 4
_DTYPES = (F32, I32, F32, F32, F32, F32, F32, I32)
_NAMES = ("v", "refrac", "current", "tau_m", "v_th", "v_reset", "v_rest",
          "refrac_period")


def _ready(args, device, shape) -> bool:
    """Whether every argument can go to the kernel as it is."""
    for x, dt in zip(args, _DTYPES):
        if not (isinstance(x, torch.Tensor) and x.dtype == dt
                and x.device == device and x.shape == shape
                and x.is_contiguous()):
            return False
    return True


def lif_step(v, refrac, current, tau_m, v_th, v_reset, v_rest,
             refrac_period):
    """One LIF step; returns ``(v, refrac int32, spikes f32 0/1)`` of the
    shape of ``v``."""
    args = (v, refrac, current, tau_m, v_th, v_reset, v_rest, refrac_period)
    shape = v.shape
    if not v.is_cuda or not _ready(args, v.device, shape):
        args = [torch.as_tensor(x, device=v.device).broadcast_to(shape).to(dt)
                for x, dt in zip(args, _DTYPES)]
        if not v.is_cuda:
            return lif_step_ref(*args)
        args = [x.contiguous() for x in args]
        for x, name, dt in zip(args, _NAMES, _DTYPES):
            kc.check(x, name, dt, shape)
    v_out = torch.empty(shape, dtype=F32, device=v.device)
    refrac_out = torch.empty(shape, dtype=I32, device=v.device)
    spikes = torch.empty(shape, dtype=F32, device=v.device)
    kc.launch(NAME, kc.kernel_fn(NAME, "lif_step_launch", _ARGTYPES),
              *(x.data_ptr() for x in args), v_out.numel(),
              v_out.data_ptr(), refrac_out.data_ptr(), spikes.data_ptr())
    return v_out, refrac_out, spikes
