"""Wrapper of the selective-SSM scan kernel (``csrc/ssm_scan.cu``).

On CUDA tensors it launches the kernel, whatever the sizes; on CPU
tensors it runs :func:`repro_torch.kernels.ssm_scan.ref.ssm_scan_ref`.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import common as kc
from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref

NAME = "ssm_scan"
F32 = torch.float32
_ARGTYPES = [kc.P] * 6 + [kc.I] * 4 + [kc.P] * 3
MAX_STATE = 16 * 32


def ssm_scan(x, dt, A, Bm, Cm, D):
    """x/dt [B, T, di], A [di, N], Bm/Cm [B, T, N], D [di] (any float
    type; float32 inside) -> ``(y [B, T, di], h_final [B, di, N])``, both
    float32, from a zero initial state."""
    b, t, di = x.shape
    n = A.shape[1]
    if not x.is_cuda:
        return ssm_scan_ref(x, dt, A, Bm, Cm, D)
    if n > MAX_STATE:
        raise ValueError(f"ssm_scan takes at most {MAX_STATE} states, not "
                         f"{n}")
    args = [z.to(F32).contiguous() for z in (x, dt, A, Bm, Cm, D)]
    shapes = ((b, t, di), (b, t, di), (di, n), (b, t, n), (b, t, n), (di,))
    names = ("x", "dt", "A", "Bm", "Cm", "D")
    y = torch.empty((b, t, di), dtype=F32, device=x.device)
    h = torch.empty((b, di, n), dtype=F32, device=x.device)
    fn = kc.kernel_fn(NAME, "ssm_scan_launch", _ARGTYPES)
    kc.launch(NAME, fn,
              *(kc.check(z, nm, F32, sh)
                for z, nm, sh in zip(args, names, shapes)),
              b, t, di, n, y.data_ptr(), h.data_ptr())
    return y, h
