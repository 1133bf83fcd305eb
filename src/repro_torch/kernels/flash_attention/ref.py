"""Plain PyTorch version of the flash-attention kernel: exact softmax
attention with GQA head grouping and a causal mask with ``q_offset``
(``repro.kernels.flash_attention.ref.attention_ref``), f32 inside.

A row with no valid key gives 0, as the kernel's ``l == 0`` guard does
(the JAX oracle would average such a row uniformly; neither the causal
nor the full mask ever leaves a row empty when ``q_offset >= 0`` and
``Skv > 0``)."""

from __future__ import annotations

import torch

F32 = torch.float32
NEG_INF = torch.finfo(torch.float32).min


def attention_ref(q, k, v, *, causal: bool = True, scale: float | None = None,
                  q_offset: int = 0) -> torch.Tensor:
    """q [B, Hq, Sq, D], k/v [B, Hkv, Skv, D] -> [B, Hq, Sq, D] in q's
    type."""
    _, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    group = hq // hkv
    if scale is None:
        scale = float(1.0 / (d ** 0.5))
    kr = k.to(F32).repeat_interleave(group, dim=1)
    vr = v.to(F32).repeat_interleave(group, dim=1)
    s = torch.matmul(q.to(F32), kr.transpose(-1, -2)) * scale
    col = torch.arange(skv, device=q.device)
    row = torch.arange(sq, device=q.device)[:, None] + q_offset
    mask = row >= col[None, :] if causal else torch.ones(
        (sq, skv), dtype=torch.bool, device=q.device)
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.matmul(p, vr) / torch.where(l == 0, 1.0, l)
    return out.to(q.dtype)
