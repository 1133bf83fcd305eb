"""Wrapper of the flash-attention kernels (``csrc/flash_attention.cu``).

On CUDA tensors it launches a kernel, whatever the sizes (there is no
small-shape shortcut on the card), both on tensor cores: bfloat16 inputs
``wgmma`` on TMA-fed tiles, float32 inputs 3xTF32 on ``mma.sync`` (each
operand split into two TF32 values and each product summed from three,
which keeps float32's accuracy); the type alone decides (:func:`design`).
On CPU tensors it runs
:func:`repro_torch.kernels.flash_attention.ref.attention_ref`.
"""

from __future__ import annotations


import torch

from repro_torch.kernels import common as kc
from repro_torch.kernels.flash_attention.ref import attention_ref

NAME = "flash_attention"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_DESIGNS = {torch.float32: "mma_tf32x3", torch.bfloat16: "wgmma"}
_ARGTYPES = [kc.P] * 4 + [kc.I] * 8 + [kc.F, kc.I, kc.P]
# TMA (bf16) and the 16-byte cp.async copies (float32) read a tensor from
# a 16-byte aligned base address.
TMA_ALIGN = 16


def design(dtype: torch.dtype) -> str:
    """The kernel that serves ``dtype`` on the card: ``"wgmma"`` (bf16,
    ``wgmma``) or ``"mma_tf32x3"`` (float32, 3xTF32 on ``mma.sync``)."""
    if dtype not in _DESIGNS:
        raise ValueError(f"flash_attention takes float32 or bfloat16, not "
                         f"{dtype}")
    return _DESIGNS[dtype]


def tma_ready(x: torch.Tensor) -> torch.Tensor:
    """``x`` contiguous with a 16-byte aligned data pointer: ``x`` itself
    where it already is, else a copy (a view whose storage offset is not
    a multiple of 16 bytes)."""
    x = x.contiguous()
    return x if x.data_ptr() % TMA_ALIGN == 0 else x.clone()


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: float | None = None,
                    q_offset: int = 0) -> torch.Tensor:
    """q [B, Hq, Sq, D], k/v [B, Hkv, Skv, D] (Hq a multiple of Hkv) ->
    [B, Hq, Sq, D] in q's type.  ``scale`` defaults to 1/sqrt(D); query
    row i sits at position ``q_offset + i`` for the causal mask.  Inputs
    that are not contiguous, or not 16-byte aligned, are copied first."""
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    if hq % hkv:
        raise ValueError(f"Hq={hq} not a multiple of Hkv={hkv}")
    if scale is None:
        scale = float(1.0 / (d ** 0.5))
    if not q.is_cuda:
        return attention_ref(q, k, v, causal=causal, scale=scale,
                             q_offset=q_offset)
    design(q.dtype)
    if d % 8 or d > 256:
        raise ValueError(f"head size {d} must be a multiple of 8, at most "
                         f"256")
    q, k, v = tma_ready(q), tma_ready(k), tma_ready(v)
    out = torch.empty_like(q)
    fn = kc.kernel_fn(NAME, "flash_attention_launch", _ARGTYPES)
    kc.launch(NAME, fn,
              kc.check(q, "q", q.dtype, (b, hq, sq, d)),
              kc.check(k, "k", q.dtype, (b, hkv, skv, d)),
              kc.check(v, "v", q.dtype, (b, hkv, skv, d)),
              out.data_ptr(), b, hq, hkv, sq, skv, d, q_offset, int(causal),
              scale, _DTYPES[q.dtype])
    return out
