"""Selective-SSM (Mamba) blocks (``repro.models.ssm``): Mamba-1
(``ssm_version=1``, falcon-mamba) and Mamba-2 (``ssm_version=2``, the
zamba2 backbone) on both of the reference's paths, ``ssm_impl="scan"``
and ``"ssd"``.

* prefill — ``ssm_apply``: the whole sequence through a kernel (the
  CUDA kernel on the card, its plain version on the CPU), which returns
  the final state for the decode cache.  ``"scan"``, where the JAX model
  runs ``scan_chunked``: the ``ssm_scan`` kernel, y in float32.  Mamba-1
  calls ``kernels.ssm_scan.ssm_scan`` with its own dt [B, T, di] and A =
  -exp(A_log) [di, N], whose rows are not constant; Mamba-2 calls
  ``ssm_scan_heads`` with the per-head dt_h and a_h, which it broadcasts
  over each head's channels.  ``"ssd"`` (Mamba-2 only), where the JAX
  model runs ``ssd_chunked``: the ``ssd_chunked`` kernel with chunks of
  ``cfg.ssd_chunk`` steps, y in x's type where that is bfloat16, with the
  reference's roundings (``kernels.ssd``); serving only, a gradient
  through it raises.
* decode — ``ssm_decode``: one recurrence step on an explicit
  :class:`SSMState` (h and the depthwise-conv tail), plain torch.

The two versions differ where the reference's do: Mamba-1 takes dt
through a rank-``dt_rank`` pair of products (the first in x_conv's type,
the second in float32) and B and C from x_conv, and gates with ``y *
silu(z)``; Mamba-2 takes dt, B and C from the residual stream and gates
through an RMSNorm.  As in the reference, ``ssm_impl`` applies to Mamba-2
only.

Training (``"scan"``): where a gradient is asked, the scan goes through an
autograd Function of ``kernels.ssm_scan``: on the card the forward kernel also
writes a state checkpoint every 64 steps, from which the backward kernel
works.  Mamba-1's ``SSMScan`` runs the per-channel backward
(``csrc/ssm_scan_bwd.cu``), Mamba-2's ``SSMScanHeads`` the chunked one
(``csrc/ssm_scan_bwd_chunked.cu``) per (chunk, head) on tensor cores,
returning the gradients of dt_h and a_h directly; on the CPU their plain
versions (``ssm_scan_bwd_ref``, ``ssm_scan_heads_bwd_ref``) do the same.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssm_scan import ops as scan_ops
from repro_torch.models.sharding import shard
from repro_torch.models.spec import ParamSpec

F32 = torch.float32


class SSMState(NamedTuple):
    h: torch.Tensor     # [B, d_inner, N] f32
    conv: torch.Tensor  # [B, K-1, d_inner]


def _check(cfg: ArchConfig) -> None:
    """The reference takes ``ssm_impl`` only for Mamba-2 (Mamba-1 always
    scans): "scan" (the ``ssm_scan`` kernel) or "ssd" (the
    ``ssd_chunked`` kernel, serving only)."""
    if cfg.ssm_version == 2 and cfg.ssm_impl not in ("scan", "ssd"):
        raise ValueError(f"ssm_impl={cfg.ssm_impl!r}: Mamba-2 takes 'scan' "
                         f"or 'ssd'")


def uses_ssd(cfg: ArchConfig) -> bool:
    """Whether ``ssm_apply`` takes the chunk-parallel "ssd" route."""
    return cfg.ssm_version == 2 and cfg.ssm_impl == "ssd"


def dt_rank(cfg: ArchConfig) -> int:
    """Mamba-1's rank of the dt projection: ceil(d_model / 16)."""
    return -(-cfg.d_model // 16)


def ssm_spec(cfg: ArchConfig) -> dict:
    _check(cfg)
    d, di, n, kk = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
    spec = {
        "w_in_x": ParamSpec((d, di), (None, "d_inner")),
        "w_in_z": ParamSpec((d, di), (None, "d_inner")),
        "conv_w": ParamSpec((kk, di), (None, "d_inner"), init="small_normal"),
        "conv_b": ParamSpec((di,), ("d_inner",), init="zeros"),
        "out_proj": ParamSpec((di, d), ("d_inner", None)),
        "D": ParamSpec((di,), ("d_inner",), init="ones"),
    }
    if cfg.ssm_version == 1:
        r = dt_rank(cfg)
        spec.update({
            "w_dt_low": ParamSpec((di, r), ("d_inner", None)),
            "w_dt": ParamSpec((r, di), (None, "d_inner")),
            "dt_bias": ParamSpec((di,), ("d_inner",), init="zeros"),
            "w_B": ParamSpec((di, n), ("d_inner", None)),
            "w_C": ParamSpec((di, n), ("d_inner", None)),
            "A_log": ParamSpec((di, n), ("d_inner", None), init="zeros"),
        })
    else:  # Mamba-2: per-head scalar decay, B/C from the residual stream
        h = cfg.n_ssm_heads
        spec.update({
            "w_dt": ParamSpec((d, h), (None, "ssm_heads")),
            "dt_bias": ParamSpec((h,), ("ssm_heads",), init="zeros"),
            "w_B": ParamSpec((d, n), (None, None)),
            "w_C": ParamSpec((d, n), (None, None)),
            "A_log": ParamSpec((h,), ("ssm_heads",), init="zeros"),
            "norm_scale": ParamSpec((di,), ("d_inner",), init="ones"),
        })
    return spec


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


def _dt_bc(cfg: ArchConfig, p: dict, x_res: torch.Tensor,
           x_conv: torch.Tensor):
    """(dt, B [B,T,N], C [B,T,N], a), float32, as the reference's
    ``_dt_bc`` computes them.  Mamba-1: dt [B,T,di] through the low-rank
    pair (the first product in x_conv's type), B and C from x_conv, A
    [di,N].  Mamba-2: the per-head dt_h [B,T,H] and a_h [H], B and C from
    the residual stream; ``scan_ops.heads_to_channels`` repeats dt_h and
    a_h over each head's channels."""
    if cfg.ssm_version == 1:
        low = torch.matmul(x_conv, p["w_dt_low"].to(x_conv.dtype))
        dt = softplus(torch.matmul(low.to(F32), p["w_dt"].to(F32))
                      + p["dt_bias"].to(F32))
        xf = x_conv.to(F32)
    else:
        xf = x_res.to(F32)
        dt = softplus(torch.matmul(xf, p["w_dt"].to(F32))
                      + p["dt_bias"].to(F32))
    bm = torch.matmul(xf, p["w_B"].to(F32))
    cm = torch.matmul(xf, p["w_C"].to(F32))
    return dt, bm, cm, -torch.exp(p["A_log"].to(F32))


def _gate(cfg: ArchConfig, p: dict, y, z):
    """Mamba-1's ``y * silu(z)``; zamba2's gated RMSNorm, norm(y *
    silu(z)) * scale."""
    g = y * F.silu(z)
    if cfg.ssm_version == 1:
        return g
    gf = g.to(F32)
    ms = torch.mean(gf ** 2, dim=-1, keepdim=True)
    return (gf * torch.rsqrt(ms + cfg.norm_eps)
            * p["norm_scale"].to(F32)).to(y.dtype)


def ssm_apply(cfg: ArchConfig, p: dict, x: torch.Tensor, *,
              return_state: bool = False, rules=None):
    """Full-sequence Mamba block from a zero state. x: [B, T, d] ->
    [B, T, d] (and the :class:`SSMState` after the last token).
    ``"scan"`` is differentiable on the card and on the CPU alike (the
    scan through ``SSMScan``, Mamba-1, or ``SSMScanHeads``, Mamba-2,
    where a gradient is asked); ``"ssd"`` raises under a gradient."""
    _check(cfg)
    t = x.shape[1]
    dt_ = x.dtype
    xh = shard(torch.matmul(x, p["w_in_x"].to(dt_)), rules, "batch", None,
               "d_inner")
    z = shard(torch.matmul(x, p["w_in_z"].to(dt_)), rules, "batch", None,
              "d_inner")
    xc = F.silu(_conv1d(p, xh))
    dt, bm, cm, a = _dt_bc(cfg, p, x, xc)
    if uses_ssd(cfg):
        y, h_final = ssd_ops.ssd_chunked(xc, dt, a, bm, cm, p["D"].to(F32),
                                         chunk=cfg.ssd_chunk)
    else:
        scan = scan_ops.ssm_scan if cfg.ssm_version == 1 else \
            scan_ops.ssm_scan_heads
        y, h_final = scan(xc, dt, a, bm, cm, p["D"].to(F32))
    y = _gate(cfg, p, y.to(dt_), z)
    out = shard(torch.matmul(y, p["out_proj"].to(dt_)), rules, "batch", None,
                None)
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


def ssm_state_spec(cfg: ArchConfig, batch: int, dtype) -> SSMState:
    """The state's shapes and types as ``meta`` tensors."""
    return SSMState(
        h=torch.empty((batch, cfg.d_inner, cfg.ssm_state), dtype=F32,
                      device="meta"),
        conv=torch.empty((batch, cfg.ssm_conv - 1, cfg.d_inner), dtype=dtype,
                         device="meta"))


def ssm_state_axes() -> SSMState:
    return SSMState(h=("batch", "d_inner", None),
                    conv=("batch", None, "d_inner"))


def ssm_decode(cfg: ArchConfig, p: dict, x: torch.Tensor,
               state: SSMState, *,
               rules=None) -> tuple[torch.Tensor, SSMState]:
    """One-token step. x: [B, 1, d] -> ([B, 1, d], state)."""
    _check(cfg)
    dt_ = x.dtype
    xh = torch.matmul(x, p["w_in_x"].to(dt_))                    # [B,1,di]
    z = torch.matmul(x, p["w_in_z"].to(dt_))
    conv_in = torch.cat([state.conv, xh], dim=1)                 # [B,K,di]
    w = p["conv_w"].to(dt_)                                      # [K, di]
    xc = torch.einsum("bkd,kd->bd", conv_in, w) + p["conv_b"].to(dt_)
    xc = F.silu(xc)[:, None, :]                                  # [B,1,di]
    dt, bm, cm, a = _dt_bc(cfg, p, x, xc)
    if cfg.ssm_version != 1:
        dt, a = scan_ops.heads_to_channels(dt, a, cfg.d_inner // a.shape[0],
                                           cfg.ssm_state)
    xcf = xc[:, 0].to(F32)
    decay = torch.exp(dt[:, 0, :, None] * a)                     # [B,di,N]
    h = decay * state.h + (dt[:, 0] * xcf)[:, :, None] * bm[:, 0, None, :]
    y = torch.einsum("bdn,bn->bd", h, cm[:, 0]) + xcf * p["D"].to(F32)
    y = _gate(cfg, p, y.to(dt_)[:, None, :], z)
    out = torch.matmul(y, p["out_proj"].to(dt_))
    return shard(out, rules, "batch", None, None), SSMState(
        h=h, conv=conv_in[:, 1:, :])
