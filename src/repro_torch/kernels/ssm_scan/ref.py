"""Plain PyTorch version of the selective-SSM scan
(``repro.kernels.ssm_scan.ref.ssm_scan_ref``, plus the final state that
``repro.models.ssm.scan_chunked`` returns):

    h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) B_t,   h_0 = 0
    y_t = C_t . h_t + D * x_t

Shapes: x/dt [B, T, di], A [di, N], Bm/Cm [B, T, N], D [di].  Everything
is float32 inside; y and h come back in float32.
"""

from __future__ import annotations

import torch

F32 = torch.float32


def ssm_scan_ref(x, dt, A, Bm, Cm, D):
    """Returns ``(y [B, T, di], h_final [B, di, N])``, float32."""
    x, dt, A, Bm, Cm, D = (z.to(F32) for z in (x, dt, A, Bm, Cm, D))
    b, t, di = x.shape
    h = torch.zeros((b, di, A.shape[1]), dtype=F32, device=x.device)
    ys = []
    for i in range(t):
        decay = torch.exp(dt[:, i, :, None] * A)                 # [B, di, N]
        h = decay * h + (dt[:, i] * x[:, i])[:, :, None] * Bm[:, i, None, :]
        ys.append((h * Cm[:, i, None, :]).sum(-1) + D * x[:, i])
    y = torch.stack(ys, dim=1) if ys else x.new_zeros((b, 0, di))
    return y, h
