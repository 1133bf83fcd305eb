"""Plain PyTorch version of the chunk-parallel SSD scan
(``repro.models.ssm.ssd_chunked``), step by step:

    l = min(chunk, T); the time axis padded with dt = 0 (the identity)
    and zeros to a multiple of l; per chunk and head, with s = dt a_h and
    cum its cumulative sum over the chunk,
        decay[t, s] = exp(cum_t - cum_s) for t >= s, else exp(-inf) = 0
        cb[t, s]    = C_t . B_s
        dtx[s]      = dt_s x_s
        y_intra[t]  = sum_s decay[t, s] cb[t, s] dtx[s]
        y_inter[t]  = exp(cum_t) C_t . h
        h          <- exp(cum_last) h + sum_s x_s B_s^T w_s,
                      w_s = exp(cum_last - cum_s) dt_s
    y = y_intra + y_inter, then + x D.

Types as in the reference: ``op_in`` (x's type where that is bfloat16,
else float32) for x, B, C and D; ``op_dt`` (the same) for the decay
matrix, cb, dtx, w and y; cum, the exponentials and the carried state
[B, H, P, N] in float32.  The three-operand products sum exact float32
products of their operands (the product of two or three bfloat16 values
is exact in float32), float32 sums.  Every decay is exp of a
non-positive difference within a chunk (never an inverse product).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

F32 = torch.float32


def op_type(x: torch.Tensor) -> torch.dtype:
    """The reference's ``op_in`` and ``op_dt``: bfloat16 for a bfloat16 x,
    else float32."""
    return torch.bfloat16 if x.dtype == torch.bfloat16 else F32


def ssd_chunked_ref(x, dt_h, a_h, bm, cm, dvec, h0=None, *,
                    chunk: int = 128):
    """x [B, T, H P], dt_h [B, T, H], a_h [H] (negative), bm/cm [B, T,
    N], dvec [H P], h0 [B, H P, N] (None: zeros) -> ``(y [B, T, H P] in
    op_dt, h_final [B, H P, N] float32)``."""
    b, t, di = x.shape
    n = bm.shape[-1]
    nh = a_h.shape[0]
    p = di // nh
    op = op_type(x)
    l = min(chunk, t)
    pad = (-t) % l
    nc = (t + pad) // l

    def chunks(z, dtype, *tail):
        z = F.pad(z.to(dtype), (0, 0, 0, pad))
        return z.view(b, nc, l, *tail)

    xs = chunks(x, op, nh, p)
    dts = chunks(dt_h, F32, nh)
    bs, cs = chunks(bm, op, n), chunks(cm, op, n)
    a = a_h.to(F32)
    tri = torch.ones((l, l), dtype=torch.bool, device=x.device).tril()
    hs = (torch.zeros((b, nh, p, n), dtype=F32, device=x.device)
          if h0 is None else h0.to(F32).reshape(b, nh, p, n))
    ys = []
    for c in range(nc):
        xc, dtc, bc, cc = xs[:, c], dts[:, c], bs[:, c], cs[:, c]
        cum = torch.cumsum(dtc * a, dim=1)                      # [b, l, H]
        decay = torch.exp((cum[:, :, None] - cum[:, None]).masked_fill(
            ~tri[None, :, :, None], float("-inf"))).to(op)     # [b, t, s, H]
        cb = torch.einsum("btn,bsn->bts", cc.to(F32), bc.to(F32)).to(op)
        dtx = (dtc[..., None] * xc.to(F32)).to(op)             # [b, s, H, P]
        m = decay.to(F32) * cb.to(F32)[..., None]
        y_intra = torch.einsum("btsh,bshp->bthp", m, dtx.to(F32))
        y_inter = torch.einsum("btn,bhpn->bthp", cc.to(F32),
                               hs) * torch.exp(cum)[..., None]
        w = (torch.exp(cum[:, -1:] - cum) * dtc).to(op)         # [b, s, H]
        xw = xc.to(F32) * w.to(F32)[..., None]
        hs = (torch.exp(cum[:, -1])[:, :, None, None] * hs
              + torch.einsum("bshp,bsn->bhpn", xw, bc.to(F32)))
        ys.append((y_intra + y_inter).to(op))
    y = torch.stack(ys, dim=1).reshape(b, nc * l, di)[:, :t]
    y = y + x.to(op) * dvec.to(op)
    return y, hs.reshape(b, di, n)
