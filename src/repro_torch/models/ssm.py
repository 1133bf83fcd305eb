"""Selective-SSM (Mamba-2) blocks of the zamba2 backbone
(``repro.models.ssm``, ``ssm_version=2``, ``ssm_impl="scan"``).

* prefill — ``ssm_apply``: the whole sequence through the ``ssm_scan``
  kernel (``kernels.ssm_scan.ssm_scan_heads``: the CUDA kernel on the
  card, its plain version on the CPU, with the per-head dt_h and a_h
  broadcast over each head's channels), where the JAX model runs
  ``scan_chunked``; the
  kernel returns y in float32 and the final state for the decode cache,
  as ``scan_chunked`` does.
* decode — ``ssm_decode``: one recurrence step on an explicit
  :class:`SSMState` (h and the depthwise-conv tail), plain torch.

Mamba-2 is the same recurrence with a per-head scalar decay (A[d, :] =
a_head), broadcast to a [di, N] A.  Mamba-1 (``ssm_version=1``,
falcon-mamba) and the chunk-parallel ``ssm_impl="ssd"`` path are not
ported yet.

Training: where a gradient is asked, ``ssm_apply``'s scan goes through
the ``SSMScanHeads`` autograd Function (``kernels.ssm_scan``): on the
card the forward kernel also writes a state checkpoint every 64 steps and
the chunked backward kernel (``csrc/ssm_scan_bwd_chunked.cu``) works from
them per (chunk, head) on tensor cores, returning the gradients of dt_h
and a_h directly; on the CPU the plain forward and the chunked plain
backward (``ssm_scan_heads_bwd_ref``) do the same.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.ssm_scan import ops as scan_ops
from repro_torch.models.spec import ParamSpec

F32 = torch.float32


class SSMState(NamedTuple):
    h: torch.Tensor     # [B, d_inner, N] f32
    conv: torch.Tensor  # [B, K-1, d_inner]


def _check(cfg: ArchConfig) -> None:
    if cfg.ssm_version != 2:
        raise NotImplementedError(
            "Mamba-1 (ssm_version 1, falcon-mamba) is not ported yet "
            "(ROADMAP section 1, item 9)")
    if cfg.ssm_impl != "scan":
        raise NotImplementedError(
            f"ssm_impl={cfg.ssm_impl!r} is not ported yet; the port runs "
            f"the 'scan' path through the ssm_scan kernel")


def ssm_spec(cfg: ArchConfig) -> dict:
    _check(cfg)
    d, di, n, kk = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
    h = cfg.n_ssm_heads
    return {
        "w_in_x": ParamSpec((d, di), (None, "d_inner")),
        "w_in_z": ParamSpec((d, di), (None, "d_inner")),
        "conv_w": ParamSpec((kk, di), (None, "d_inner"), init="small_normal"),
        "conv_b": ParamSpec((di,), ("d_inner",), init="zeros"),
        "out_proj": ParamSpec((di, d), ("d_inner", None)),
        "D": ParamSpec((di,), ("d_inner",), init="ones"),
        "w_dt": ParamSpec((d, h), (None, "ssm_heads")),
        "dt_bias": ParamSpec((h,), ("ssm_heads",), init="zeros"),
        "w_B": ParamSpec((d, n), (None, None)),
        "w_C": ParamSpec((d, n), (None, None)),
        "A_log": ParamSpec((h,), ("ssm_heads",), init="zeros"),
        "norm_scale": ParamSpec((di,), ("d_inner",), init="ones"),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + e^x) as ``logaddexp(x, 0)`` (torch's
    ``F.softplus`` returns x itself above its threshold of 20)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _conv1d(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Causal depthwise conv along time, x [B, T, di]: four shifted
    products summed in float32 (no cuDNN, so no TF32), then the bias in
    x's type."""
    kk = p["conv_w"].shape[0]
    t = x.shape[1]
    w = p["conv_w"].to(x.dtype).to(F32)
    xp = F.pad(x.to(F32), (0, 0, kk - 1, 0))
    y = sum(xp[:, j:j + t] * w[j] for j in range(kk))
    return y.to(x.dtype) + p["conv_b"].to(x.dtype)


def _dt_bc(cfg: ArchConfig, p: dict, x_res: torch.Tensor):
    """(dt_h [B,T,H], B [B,T,N], C [B,T,N], a_h [H]) of Mamba-2, float32:
    the per-head dt and (negative) decay, as the reference's ``_dt_bc``
    returns them; ``scan_ops.heads_to_channels`` repeats them over each
    head's channels."""
    xf = x_res.to(F32)
    dt_h = softplus(torch.matmul(xf, p["w_dt"].to(F32))
                    + p["dt_bias"].to(F32))
    bm = torch.matmul(xf, p["w_B"].to(F32))
    cm = torch.matmul(xf, p["w_C"].to(F32))
    a_h = -torch.exp(p["A_log"].to(F32))
    return dt_h, bm, cm, a_h


def _gated_norm(cfg: ArchConfig, p: dict, y, z):
    """zamba2's gated RMSNorm: norm(y * silu(z)) * scale."""
    g = y * F.silu(z)
    gf = g.to(F32)
    ms = torch.mean(gf ** 2, dim=-1, keepdim=True)
    return (gf * torch.rsqrt(ms + cfg.norm_eps)
            * p["norm_scale"].to(F32)).to(y.dtype)


def ssm_apply(cfg: ArchConfig, p: dict, x: torch.Tensor, *,
              return_state: bool = False):
    """Full-sequence Mamba-2 block from a zero state. x: [B, T, d] ->
    [B, T, d] (and the :class:`SSMState` after the last token).
    Differentiable on the card and on the CPU alike (the scan through
    ``SSMScanHeads`` where a gradient is asked)."""
    _check(cfg)
    t = x.shape[1]
    dt_ = x.dtype
    xh = torch.matmul(x, p["w_in_x"].to(dt_))
    z = torch.matmul(x, p["w_in_z"].to(dt_))
    xc = F.silu(_conv1d(p, xh))
    dt_h, bm, cm, a_h = _dt_bc(cfg, p, x)
    y, h_final = scan_ops.ssm_scan_heads(xc, dt_h, a_h, bm, cm,
                                         p["D"].to(F32))
    y = _gated_norm(cfg, p, y.to(dt_), z)
    out = torch.matmul(y, p["out_proj"].to(dt_))
    if return_state:
        kk = cfg.ssm_conv
        tail = (xh[:, -(kk - 1):, :] if t >= kk - 1
                else F.pad(xh, (0, 0, kk - 1 - t, 0)))
        return out, SSMState(h=h_final, conv=tail.contiguous())
    return out


def init_ssm_state(cfg: ArchConfig, batch: int, dtype, device) -> SSMState:
    return SSMState(
        h=torch.zeros((batch, cfg.d_inner, cfg.ssm_state), dtype=F32,
                      device=device),
        conv=torch.zeros((batch, cfg.ssm_conv - 1, cfg.d_inner),
                         dtype=dtype, device=device))


def ssm_decode(cfg: ArchConfig, p: dict, x: torch.Tensor,
               state: SSMState) -> tuple[torch.Tensor, SSMState]:
    """One-token step. x: [B, 1, d] -> ([B, 1, d], state)."""
    _check(cfg)
    dt_ = x.dtype
    xh = torch.matmul(x, p["w_in_x"].to(dt_))                    # [B,1,di]
    z = torch.matmul(x, p["w_in_z"].to(dt_))
    conv_in = torch.cat([state.conv, xh], dim=1)                 # [B,K,di]
    w = p["conv_w"].to(dt_)                                      # [K, di]
    xc = torch.einsum("bkd,kd->bd", conv_in, w) + p["conv_b"].to(dt_)
    xc = F.silu(xc)[:, None, :]                                  # [B,1,di]
    dt_h, bm, cm, a_h = _dt_bc(cfg, p, x)
    dt, a = scan_ops.heads_to_channels(dt_h, a_h, cfg.d_inner // a_h.shape[0],
                                       cfg.ssm_state)
    xcf = xc[:, 0].to(F32)
    decay = torch.exp(dt[:, 0, :, None] * a)                     # [B,di,N]
    h = decay * state.h + (dt[:, 0] * xcf)[:, :, None] * bm[:, 0, None, :]
    y = torch.einsum("bdn,bn->bd", h, cm[:, 0]) + xcf * p["D"].to(F32)
    y = _gated_norm(cfg, p, y.to(dt_)[:, None, :], z)
    out = torch.matmul(y, p["out_proj"].to(dt_))
    return out, SSMState(h=h, conv=conv_in[:, 1:, :])
