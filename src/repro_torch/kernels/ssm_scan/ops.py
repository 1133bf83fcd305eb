"""Wrapper of the selective-SSM scan kernel (``csrc/ssm_scan.cu``).

On CUDA tensors it launches the kernel, whatever the sizes; on CPU
tensors it runs :func:`repro_torch.kernels.ssm_scan.ref.ssm_scan_ref`.
The kernel reads x in its own type where that is float32 or bfloat16
(it is not converted; bf16 to f32 is exact, so the result is the same
x's in f32), and the other inputs in float32.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import common as kc
from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref

NAME = "ssm_scan"
F32 = torch.float32
X_TYPES = (torch.float32, torch.bfloat16)
_ARGTYPES = [kc.P] * 6 + [kc.I] * 5 + [kc.P] * 3
MAX_STATE = 16 * 32


def ssm_scan(x, dt, A, Bm, Cm, D):
    """x/dt [B, T, di], A [di, N], Bm/Cm [B, T, N], D [di] (any float
    type; x float32 or bfloat16 as given, the rest float32 inside) ->
    ``(y [B, T, di], h_final [B, di, N])``, both float32, from a zero
    initial state."""
    b, t, di = x.shape
    n = A.shape[1]
    if not x.is_cuda:
        return ssm_scan_ref(x, dt, A, Bm, Cm, D)
    if n > MAX_STATE:
        raise ValueError(f"ssm_scan takes at most {MAX_STATE} states, not "
                         f"{n}")
    x = (x if x.dtype in X_TYPES else x.to(F32)).contiguous()
    args = [x] + [z.to(F32).contiguous() for z in (dt, A, Bm, Cm, D)]
    shapes = ((b, t, di), (b, t, di), (di, n), (b, t, n), (b, t, n), (di,))
    names = ("x", "dt", "A", "Bm", "Cm", "D")
    types = (x.dtype,) + (F32,) * 5
    y = torch.empty((b, t, di), dtype=F32, device=x.device)
    h = torch.empty((b, di, n), dtype=F32, device=x.device)
    fn = kc.kernel_fn(NAME, "ssm_scan_launch", _ARGTYPES)
    kc.launch(NAME, fn,
              *(kc.check(z, nm, ty, sh)
                for z, nm, ty, sh in zip(args, names, types, shapes)),
              b, t, di, n, int(x.dtype == torch.bfloat16), y.data_ptr(),
              h.data_ptr())
    return y, h
