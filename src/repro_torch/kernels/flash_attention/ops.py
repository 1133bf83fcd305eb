"""Wrappers of the flash-attention kernels (``csrc/flash_attention.cu``,
forward; ``csrc/flash_attention_bwd.cu``, backward) and the autograd
Function that joins them.

On CUDA tensors the forward launches a kernel, whatever the sizes (there
is no small-shape shortcut on the card), both on tensor cores: bfloat16
inputs ``wgmma`` on TMA-fed tiles, float32 inputs 3xTF32 on ``mma.sync``
(each operand split into two TF32 values and each product summed from
three, which keeps float32's accuracy); the type alone decides
(:func:`design`).  The backward launches its two kernels (dQ, then dK
and dV) through one C call, both types on tensor cores with P and dS in
registers: bfloat16 on ``mma.sync`` m16n8k16, float32 in 3xTF32 on
``mma.sync`` m16n8k8 (the forward's split, all five products); neither
uses atomics, so two calls on the same inputs give the same bits.  On
CPU tensors both run the plain versions of
:mod:`repro_torch.kernels.flash_attention.ref`.

:func:`flash_attention` goes through :class:`FlashAttention` where an
input requires grad under grad mode: the forward then also writes each
row's log-sum-exp, which the Function saves with q, k, v and the output
for the backward.  Any other call is the single forward launch, with no
lse.  ``window`` > 0 (query position i sees key j only where i - j <
window) is taken by the forward alone: each q tile starts its key loop at
the first tile that meets its window; the backward kernels have no
window, so a windowed call where a gradient is asked raises.
"""

from __future__ import annotations


import torch

from repro_torch.kernels import common as kc
from repro_torch.kernels.flash_attention.ref import (
    attention_bwd_ref, attention_ref, attention_with_lse_ref)

NAME = "flash_attention"
BWD_NAME = "flash_attention_bwd"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_DESIGNS = {torch.float32: "mma_tf32x3", torch.bfloat16: "wgmma"}
_BWD_DESIGNS = {torch.float32: "mma_tf32x3", torch.bfloat16: "mma_bf16"}
_ARGTYPES = [kc.P] * 5 + [kc.I] * 8 + [kc.F, kc.I, kc.I, kc.P]
_BWD_ARGTYPES = [kc.P] * 10 + [kc.I] * 8 + [kc.F, kc.I, kc.P]
# TMA (bf16) and the 16-byte cp.async copies (float32) read a tensor from
# a 16-byte aligned base address; so do the backward's 16-byte loads.
TMA_ALIGN = 16
F32 = torch.float32
NO_WINDOW_GRAD = ("training with a sliding window is not ported: the "
                  "flash-attention backward kernels have no window "
                  "(ROADMAP.md section 1, item 9)")


def design(dtype: torch.dtype, *, backward: bool = False) -> str:
    """The kernel that serves ``dtype`` on the card.  Forward: ``"wgmma"``
    (bf16, ``wgmma``) or ``"mma_tf32x3"`` (float32, 3xTF32 on
    ``mma.sync``); backward: ``"mma_bf16"`` (bf16 ``mma.sync``) or
    ``"mma_tf32x3"`` (float32, 3xTF32 on ``mma.sync``)."""
    if dtype not in _DESIGNS:
        raise ValueError(f"flash_attention takes float32 or bfloat16, not "
                         f"{dtype}")
    return (_BWD_DESIGNS if backward else _DESIGNS)[dtype]


def tma_ready(x: torch.Tensor) -> torch.Tensor:
    """``x`` contiguous with a 16-byte aligned data pointer: ``x`` itself
    where it already is, else a copy (a view whose storage offset is not
    a multiple of 16 bytes)."""
    x = x.contiguous()
    return x if x.data_ptr() % TMA_ALIGN == 0 else x.clone()


def _shapes(q, k, scale):
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    if hq % hkv:
        raise ValueError(f"Hq={hq} not a multiple of Hkv={hkv}")
    if scale is None:
        scale = float(1.0 / (d ** 0.5))
    return (b, hq, hkv, sq, skv, d), scale


def _card_check(q, d):
    design(q.dtype)
    if d % 8 or d > 256:
        raise ValueError(f"head size {d} must be a multiple of 8, at most "
                         f"256")


def flash_attention_fwd(q, k, v, *, causal: bool = True,
                        scale: float | None = None, q_offset: int = 0,
                        with_lse: bool = False, window: int = 0):
    """The forward: out [B, Hq, Sq, D] in q's type, and with ``with_lse``
    also lse [B, Hq, Sq] float32 (natural log; ``finfo(float32).min`` on
    a row with no valid key) as ``(out, lse)``.  ``window`` > 0 keeps
    only keys j with q_offset + i - j < window for query row i.  Inputs
    that are not contiguous, or not 16-byte aligned, are copied first."""
    (b, hq, hkv, sq, skv, d), scale = _shapes(q, k, scale)
    if window < 0:
        raise ValueError(f"window must be 0 (none) or positive, not {window}")
    if not q.is_cuda:
        if with_lse:
            return attention_with_lse_ref(q, k, v, causal=causal, scale=scale,
                                          q_offset=q_offset, window=window)
        return attention_ref(q, k, v, causal=causal, scale=scale,
                             q_offset=q_offset, window=window)
    _card_check(q, d)
    q, k, v = tma_ready(q), tma_ready(k), tma_ready(v)
    out = torch.empty_like(q)
    lse = (torch.empty((b, hq, sq), dtype=F32, device=q.device) if with_lse
           else None)
    fn = kc.kernel_fn(NAME, "flash_attention_launch", _ARGTYPES)
    kc.launch(NAME, fn,
              kc.check(q, "q", q.dtype, (b, hq, sq, d)),
              kc.check(k, "k", q.dtype, (b, hkv, skv, d)),
              kc.check(v, "v", q.dtype, (b, hkv, skv, d)),
              out.data_ptr(), None if lse is None else lse.data_ptr(), b, hq,
              hkv, sq, skv, d, q_offset, int(causal), scale,
              _DTYPES[q.dtype], int(window))
    return (out, lse) if with_lse else out


def flash_attention_bwd(q, k, v, out, lse, dout, *, causal: bool = True,
                        scale: float | None = None, q_offset: int = 0):
    """The backward: (dq, dk, dv) in q's, k's and v's types from the
    forward's inputs, its output ``out`` and ``lse`` and the output's
    gradient ``dout``.  On the card one C call launches the dQ kernel
    (which also computes delta = rowsum(dout * out) into a scratch
    buffer) and then the dK/dV kernel, of the route ``design(q.dtype,
    backward=True)`` names."""
    (b, hq, hkv, sq, skv, d), scale = _shapes(q, k, scale)
    if not q.is_cuda:
        return attention_bwd_ref(q, k, v, out, lse, dout, causal=causal,
                                 scale=scale, q_offset=q_offset)
    _card_check(q, d)
    q, k, v, out, dout = (tma_ready(x) for x in (q, k, v, out, dout))
    lse = lse.contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((b, hq, sq), dtype=F32, device=q.device)
    qs, ks = (b, hq, sq, d), (b, hkv, skv, d)
    fn = kc.kernel_fn(BWD_NAME, "flash_attention_bwd_launch", _BWD_ARGTYPES)
    kc.launch(BWD_NAME, fn,
              kc.check(q, "q", q.dtype, qs), kc.check(k, "k", q.dtype, ks),
              kc.check(v, "v", q.dtype, ks),
              kc.check(out, "out", q.dtype, qs),
              kc.check(dout, "dout", q.dtype, qs),
              kc.check(lse, "lse", F32, (b, hq, sq)), delta.data_ptr(),
              dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, hq, hkv, sq,
              skv, d, q_offset, int(causal), scale, _DTYPES[q.dtype])
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Attention with its gradient from the backward kernels: the forward
    saves q, k, v, the output and lse; the backward launches
    :func:`flash_attention_bwd` (its plain version on the CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, q_offset):
        if q.is_cuda:   # saved as the kernel reads them: no copy again
            q, k, v = tma_ready(q), tma_ready(k), tma_ready(v)
        out, lse = flash_attention_fwd(q, k, v, causal=causal, scale=scale,
                                       q_offset=q_offset, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.attrs = (causal, scale, q_offset)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, scale, q_offset = ctx.attrs
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout,
                                         causal=causal, scale=scale,
                                         q_offset=q_offset)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: float | None = None,
                    q_offset: int = 0, window: int = 0) -> torch.Tensor:
    """q [B, Hq, Sq, D], k/v [B, Hkv, Skv, D] (Hq a multiple of Hkv) ->
    [B, Hq, Sq, D] in q's type.  ``scale`` defaults to 1/sqrt(D); query
    row i sits at position ``q_offset + i`` for the causal mask and the
    sliding window (``window`` > 0: keys j with position - j < window).
    Differentiable without a window: where an input requires grad under
    grad mode the call goes through :class:`FlashAttention`; with a
    window it raises there."""
    _, scale = _shapes(q, k, scale)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        if window:
            raise NotImplementedError(NO_WINDOW_GRAD)
        return FlashAttention.apply(q, k, v, causal, scale, q_offset)
    return flash_attention_fwd(q, k, v, causal=causal, scale=scale,
                               q_offset=q_offset, window=window)
