"""Plain PyTorch versions of the selective-SSM scan and its backward
(``repro.kernels.ssm_scan.ref.ssm_scan_ref``, plus the final state that
``repro.models.ssm.scan_chunked`` returns, and the gradient that XLA's
autodiff of ``scan_chunked`` gives):

    h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) B_t,   h_0 = 0
    y_t = C_t . h_t + D * x_t

Shapes: x/dt [B, T, di], A [di, N], Bm/Cm [B, T, N], D [di].  Everything
is float32 inside; y and h come back in float32.  The forward can also
return the state at the start of every ``chunk`` steps (``h_chunks``),
from which the backward recomputes the states it needs.
"""

from __future__ import annotations

import torch

F32 = torch.float32
CHUNK = 64   # steps per state checkpoint (csrc/ssm_scan.cuh: kChunk)


def _f32(*xs):
    return tuple(z.to(F32) for z in xs)


def _step(h, x_t, dt_t, A, b_t):
    """h_t from h_{t-1}: exp(dt A) h + (dt x) B, as ``ssm_scan_ref``."""
    decay = torch.exp(dt_t[:, :, None] * A)                     # [B, di, N]
    return decay * h + (dt_t * x_t)[:, :, None] * b_t[:, None, :]


def ssm_scan_ref(x, dt, A, Bm, Cm, D):
    """Returns ``(y [B, T, di], h_final [B, di, N])``, float32."""
    y, h, _ = ssm_scan_with_states_ref(x, dt, A, Bm, Cm, D, chunk=0)
    return y, h


def ssm_scan_with_states_ref(x, dt, A, Bm, Cm, D, chunk: int = CHUNK):
    """Returns ``(y [B, T, di], h_final [B, di, N], h_chunks [B,
    ceil(T / chunk), di, N])``, float32: ``h_chunks[:, c]`` is the state
    before step ``c * chunk`` (so the first is 0).  ``chunk`` 0 keeps
    none (``h_chunks`` is then None)."""
    x, dt, A, Bm, Cm, D = _f32(x, dt, A, Bm, Cm, D)
    b, t, di = x.shape
    h = torch.zeros((b, di, A.shape[1]), dtype=F32, device=x.device)
    ys, hs = [], []
    for i in range(t):
        if chunk and i % chunk == 0:
            hs.append(h)
        h = _step(h, x[:, i], dt[:, i], A, Bm[:, i])
        ys.append((h * Cm[:, i, None, :]).sum(-1) + D * x[:, i])
    y = torch.stack(ys, dim=1) if ys else x.new_zeros((b, 0, di))
    if not chunk:
        return y, h, None
    h_chunks = (torch.stack(hs, dim=1) if hs
                else h.new_zeros((b, 0) + tuple(h.shape[1:])))
    return y, h, h_chunks


def ssm_scan_bwd_ref(x, dt, A, Bm, Cm, D, h_chunks, dy, dh_final=None):
    """The gradient of :func:`ssm_scan_ref` by an explicit reverse-time
    loop (not autograd): ``(dx, ddt, dA, dBm, dCm, dD)`` from the forward's
    inputs, its checkpoints ``h_chunks`` (every ``CHUNK`` steps, from
    :func:`ssm_scan_with_states_ref`), dy [B, T, di] and dh_final [B, di,
    N] (None: 0).  dx comes back in x's type, the rest in float32.

    With e_t = exp(dt_t A) and u_t = dt_t x_t, walking t from the last
    step to the first with g = dL/dh_t:

        g_T = dh_final (0 if None), and at each step g_t = C_t dy_t
              + e_{t+1} * g_{t+1}  (the first of them adds to dh_final)
        dC_t[n]  = sum_d dy_t[d] h_t[d, n]
        dB_t[n]  = sum_d u_t[d] g_t[d, n]
        du_t[d]  = sum_n g_t[d, n] B_t[n]
        q_t      = g_t * h_{t-1} * e_t
        ddt_t[d] = du_t[d] x_t[d] + sum_n q_t[d, n] A[d, n]
        dx_t[d]  = du_t[d] dt_t[d] + dy_t[d] D[d]
        dA[d, n] = sum_{b,t} q_t[d, n] dt_t[d]
        dD[d]    = sum_{b,t} dy_t[d] x_t[d]

    h_{t-1} and h_t are recomputed forward from the chunk's checkpoint
    (never by dividing by e, which underflows where dt A is very
    negative)."""
    x_type = x.dtype
    x, dt, A, Bm, Cm, D, dy = _f32(x, dt, A, Bm, Cm, D, dy)
    b, t, di = x.shape
    n = A.shape[1]
    g = (torch.zeros((b, di, n), dtype=F32, device=x.device)
         if dh_final is None else dh_final.to(F32).clone())
    e_next = torch.ones((), dtype=F32, device=x.device)
    dx, ddt = torch.empty_like(x), torch.empty_like(x)
    dB, dC = torch.empty_like(Bm), torch.empty_like(Cm)
    dA = torch.zeros_like(A)
    for c in reversed(range(-(-t // CHUNK))):
        t0, t1 = c * CHUNK, min(t, (c + 1) * CHUNK)
        hs = [h_chunks[:, c].to(F32)]   # hs[k]: after step t0 + k - 1
        for i in range(t0, t1 - 1):
            hs.append(_step(hs[-1], x[:, i], dt[:, i], A, Bm[:, i]))
        h_cur = _step(hs[-1], x[:, t1 - 1], dt[:, t1 - 1], A, Bm[:, t1 - 1])
        for i in reversed(range(t0, t1)):
            h_prev = hs[i - t0]
            dy_i, x_i, dt_i = dy[:, i], x[:, i], dt[:, i]
            e = torch.exp(dt_i[:, :, None] * A)
            g = Cm[:, i, None, :] * dy_i[:, :, None] + e_next * g
            dC[:, i] = torch.einsum("bdn,bd->bn", h_cur, dy_i)
            dB[:, i] = torch.einsum("bdn,bd->bn", g, dt_i * x_i)
            du = torch.einsum("bdn,bn->bd", g, Bm[:, i])
            q = g * h_prev * e
            ddt[:, i] = du * x_i + (q * A).sum(-1)
            dx[:, i] = du * dt_i + dy_i * D
            dA += torch.einsum("bdn,bd->dn", q, dt_i)
            e_next, h_cur = e, h_prev
    dD = (dy * x).sum((0, 1))
    return dx.to(x_type), ddt, dA, dB, dC, dD
