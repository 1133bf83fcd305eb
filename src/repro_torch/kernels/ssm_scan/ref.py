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


def heads_to_channels(dt_h, a_h, p: int, n: int):
    """(dt [B, T, H p], A [H p, n]) float32 from the per-head dt_h [B, T,
    H] and a_h [H]: each head's value repeated over its ``p`` channels
    (``jnp.repeat(dt_h, p)``, ``jnp.repeat(a_h, p)[:, None] * ones``)."""
    dt = dt_h.to(F32).repeat_interleave(p, dim=-1)
    a = a_h.to(F32).repeat_interleave(p)[:, None] * torch.ones(
        (1, n), dtype=F32, device=a_h.device)
    return dt, a


def ssm_scan_heads_bwd_ref(x, dt_h, a_h, Bm, Cm, D, h_chunks, dy,
                           dh_final=None):
    """The gradient of the scan for Mamba-2's per-head decay, in the
    chunked (SSD) form, looping only over chunks of ``CHUNK`` steps:
    ``(dx, ddt_h, da_h, dBm, dCm, dD)`` from x [B, T, H P], dt_h [B, T,
    H], a_h [H], Bm/Cm [B, T, N], D [H P], the forward's checkpoints
    ``h_chunks`` [B, ceil(T / CHUNK), H P, N], dy [B, T, H P] and
    dh_final [B, H P, N] (None: 0).  dx comes back in x's type, the rest
    in float32.  It is the gradient that :func:`ssm_scan_bwd_ref` gives
    through :func:`heads_to_channels`, ddt and dA summed over each head's
    channels (and states).

    Per chunk and head, with steps t, s of the chunk (a ragged last chunk
    padded with dt 0, the identity, and x, B, C, dy 0), h0 the chunk's
    checkpoint [P, N] and G the gradient of its end state [P, N]:

        cum_t = sum_{k <= t} dt_k a,  L[t, s] = exp(cum_t - cum_s) (t >= s,
        else 0),  w_s = exp(cum_Q - cum_s) (cum_Q the chunk's last),
        u = dt x,  CB = C B^T,  M = CB o L
        du   = M^T dy + diag(w) B G^T
        dM~  = (dy u^T) o L
        dC   = dM~ B + diag(exp cum) dy h0         (summed over heads)
        dB   = dM~^T C + diag(w) u G               (summed over heads)
        ds_t = d loss / d s_t (s = dt a) = sum_{t' >= t > s} Z[t', s]
               + sum_{t' >= t} exp(cum_t') C_t' . (dy h0)_t'
               + sum_{s < t} w_s u_s . (G B_s) + exp(cum_Q) <G, h0>,
               Z = dM~ o CB
        ddt_h = a ds + sum_p du x,   da_h = sum ds dt
        dx   = du dt + dy D,   dD = sum dy x
        G of the chunk before = exp(cum_Q) G + dy^T diag(exp cum) C

    ds is the reverse cumulative sum of d loss / d cum (the kernel sums
    it so: rows of Z less its columns, then the other terms), taken here
    without the cancellation of Z's row and column sums: Z's entries on
    both sides of t cancel.  Every exponent is of a non-positive
    difference within the chunk; no state is got by dividing by a
    decay."""
    x_type = x.dtype
    x, dt_h, a_h, Bm, Cm, D, dy = _f32(x, dt_h, a_h, Bm, Cm, D, dy)
    b, t, di = x.shape
    nh, n = a_h.shape[0], Bm.shape[-1]
    p = di // nh
    nc = -(-t // CHUNK)
    pad = nc * CHUNK - t

    def chunks(z, *tail):
        z = torch.nn.functional.pad(z, (0, 0, 0, pad))
        return z.view(b, nc, CHUNK, *tail)

    xs, dys = chunks(x, nh, p), chunks(dy, nh, p)
    dts, bs, cs = chunks(dt_h, nh), chunks(Bm, n), chunks(Cm, n)
    h0s = h_chunks.to(F32).view(b, nc, nh, p, n)
    d_hp = D.view(nh, p)
    g = (torch.zeros((b, nh, p, n), dtype=F32, device=x.device)
         if dh_final is None else dh_final.to(F32).view(b, nh, p, n))
    tri = torch.ones((CHUNK, CHUNK), dtype=torch.bool,
                     device=x.device).tril()[None, :, :, None]
    below = tri & ~torch.eye(CHUNK, dtype=torch.bool,
                             device=x.device)[None, :, :, None]
    dx, ddt = torch.empty_like(xs), torch.empty_like(dts)
    dB, dC = torch.empty_like(bs), torch.empty_like(cs)
    da = torch.zeros_like(a_h)
    for c in reversed(range(nc)):
        xc, dyc, dt, bk, ck, h0 = (xs[:, c], dys[:, c], dts[:, c], bs[:, c],
                                   cs[:, c], h0s[:, c])
        cum = torch.cumsum(dt * a_h, dim=1)                     # [b, Q, H]
        last = cum[:, -1:]
        ell = torch.exp((cum[:, :, None] - cum[:, None]).masked_fill(
            ~tri, float("-inf")))                           # [b, t, s, H]
        ecum, w = torch.exp(cum), torch.exp(last - cum)
        u = dt[..., None] * xc                                # [b, Q, H, P]
        cb = torch.einsum("btn,bsn->bts", ck, bk)[..., None]
        f = torch.einsum("bsn,bhpn->bshp", bk, g) * w[..., None]
        du = torch.einsum("btsh,bthp->bshp", cb * ell, dyc) + f
        dmt = torch.einsum("bthp,bshp->btsh", dyc, u) * ell
        z = dmt * cb
        e = torch.einsum("bthp,bhpn->bthn", dyc, h0) * ecum[..., None]
        dC[:, c] = (torch.einsum("btsh,bsn->btn", dmt, bk)
                    + e.sum(2))
        dB[:, c] = (torch.einsum("btsh,btn->bsn", dmt, ck)
                    + torch.einsum("bshp,bhpn->bsn", u * w[..., None], g))
        rr = (u * f).sum(-1)                                    # [b, Q, H]
        ec = torch.einsum("bthn,btn->bth", e, ck)
        ds = (z.flip(1).cumsum(1).flip(1) * below).sum(2) + (
            ec.flip(1).cumsum(1).flip(1) + rr.cumsum(1) - rr
            + (torch.exp(last[:, 0]) * torch.einsum("bhpn,bhpn->bh", g,
                                                    h0))[:, None])
        ddt[:, c] = ds * a_h + (du * xc).sum(-1)
        da += (ds * dt).sum((0, 1))
        dx[:, c] = du * dt[..., None] + dyc * d_hp
        g = (torch.exp(last[:, 0])[..., None, None] * g
             + torch.einsum("bthp,bth,btn->bhpn", dyc, ecum, ck))
    dD = (dy * x).sum((0, 1))
    unpad = lambda z: z.reshape(b, nc * CHUNK, -1)[:, :t]  # noqa: E731
    return (unpad(dx).to(x_type), unpad(ddt), da, unpad(dB), unpad(dC), dD)
