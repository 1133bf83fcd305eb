"""GQA attention: projections, RoPE, prefill attention through the
flash-attention kernel, and single-token decode against a KV cache
(``repro.models.attention``).

The JAX package states one semantics across three paths: its pure-XLA
``chunked_attention`` (with a ``custom_vjp`` backward that recomputes p
from q, k and lse), the Pallas kernel (selected on a TPU) and
``decode_attention``.  The port's training and prefill run the
flash-attention kernels (``kernels.flash_attention``: the CUDA kernels
on the card, their plain versions on the CPU) where the JAX model runs
``chunked_attention``; the gradient comes from the backward kernels
through the ``FlashAttention`` autograd Function, with
``chunked_attention``'s roundings.  The forwards differ only by rounding
(the plain version multiplies f32 probabilities by v in f32, where
``chunked_attention`` and the bf16 kernel first cast them to v's type).
Decode stays plain torch, as in JAX.  A sliding window (``window`` > 0:
query position i sees keys j with i - j < window, zamba2's long-context
path) runs in the forward kernel, which skips the key tiles outside
every row's window; ``decode_attention`` masks the cache slots before
``cache_len - window``.  Training with a window is not ported: the
backward kernels have no window, and a windowed call under a gradient
raises.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models.layers import apply_rope
from repro_torch.models.sharding import shard
from repro_torch.models.spec import ParamSpec

F32 = torch.float32
NEG_INF = torch.finfo(torch.float32).min


def attn_spec(cfg: ArchConfig, *, cross: bool = False) -> dict:
    """The projections of one attention: self-attention, or with
    ``cross`` an encoder-decoder's cross-attention, whose leaves are the
    same (queries from the decoder, keys and values from the encoder's
    output), as in the reference."""
    del cross
    d, hq, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    if cfg.head_pad:
        if cfg.head_pad % hkv:
            raise ValueError("head_pad must be a multiple of n_kv_heads")
        hq = cfg.head_pad
    return {
        "wq": ParamSpec((d, hq, dh), (None, "heads", None)),
        "wk": ParamSpec((d, hkv, dh), (None, "kv_heads", None)),
        "wv": ParamSpec((d, hkv, dh), (None, "kv_heads", None)),
        "wo": ParamSpec((hq, dh, d), ("heads", None, None),
                        fan_in_dims=(0, 1)),
    }


class KVCache(NamedTuple):
    k: torch.Tensor   # [B, Hkv, S_max, Dh] (stacked: [R, B, Hkv, S_max, Dh])
    v: torch.Tensor


def project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhe->bhse") as one matmul."""
    d, h, e = w.shape
    y = torch.matmul(x, w.to(x.dtype).reshape(d, h * e))
    return y.reshape(*x.shape[:2], h, e).transpose(1, 2)


def project_qkv(cfg: ArchConfig, p: dict, x_q: torch.Tensor,
                x_kv: torch.Tensor, positions, kv_positions, *,
                use_rope: bool, rules=None):
    q = shard(project(x_q, p["wq"]), rules, "batch", "heads", None, None)
    k = shard(project(x_kv, p["wk"]), rules, "batch", "kv_heads", None, None)
    v = shard(project(x_kv, p["wv"]), rules, "batch", "kv_heads", None, None)
    if use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, kv_positions, cfg.rope_theta)
    return q, k, v


def output_proj(p: dict, o: torch.Tensor, *, rules=None) -> torch.Tensor:
    """einsum("bhse,hed->bsd")."""
    b, h, s, e = o.shape
    w = p["wo"].to(o.dtype).reshape(h * e, -1)
    y = torch.matmul(o.transpose(1, 2).reshape(b, s, h * e), w)
    return shard(y, rules, "batch", None, None)


def prefill_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """Full-sequence attention of training and prefill: the flash-attention
    kernel, differentiable through its backward kernels where ``window``
    is 0; a windowed call is the forward alone (under a gradient it
    raises)."""
    return fa_ops.flash_attention(q, k, v, causal=causal, window=window)


def decode_attention(q: torch.Tensor, cache: KVCache, cache_len: int, *,
                     window: int = 0) -> torch.Tensor:
    """q [B, Hq, 1, D] against the first ``cache_len`` slots of the
    cache, with ``window`` only slots ``cache_len - window`` onwards (in a
    ring of ``window`` slots that have all been written, every slot).
    Scores and the product with v in f32 from the cache's values, the
    probabilities rounded to the cache's type first, as in JAX."""
    b, hq, _, d = q.shape
    hkv = cache.k.shape[1]
    g = hq // hkv
    scale = 1.0 / (d ** 0.5)
    s_max = cache.k.shape[2]
    qg = q.reshape(b, hkv, g, d)
    s = torch.matmul(qg.to(F32), cache.k.to(F32).transpose(-1, -2)) * scale
    idx = torch.arange(s_max, device=q.device)
    mask = idx < cache_len
    if window:
        mask = mask & (idx >= cache_len - window)
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.matmul(p.to(cache.v.dtype).to(F32), cache.v.to(F32))
    return o.reshape(b, hq, 1, d).to(q.dtype)


def cache_update(cache: KVCache, k_new: torch.Tensor, v_new: torch.Tensor,
                 pos: int) -> KVCache:
    """Write [B, Hkv, 1, D] at slot ``pos`` of the S axis, in place (the
    JAX version returns an updated copy; a copy of a serving cache per
    token and layer is what the port avoids)."""
    cache.k[:, :, pos] = k_new[:, :, 0].to(cache.k.dtype)
    cache.v[:, :, pos] = v_new[:, :, 0].to(cache.v.dtype)
    return cache


def init_cache(cfg: ArchConfig, batch: int, s_max: int, dtype,
               device) -> KVCache:
    shape = (batch, cfg.n_kv_heads, s_max, cfg.d_head)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))


def cache_spec(cfg: ArchConfig, batch: int, s_max: int, dtype) -> KVCache:
    """The cache's shapes and type as ``meta`` tensors (the reference's
    ``ShapeDtypeStruct`` stand-ins)."""
    x = torch.empty((batch, cfg.n_kv_heads, s_max, cfg.d_head), dtype=dtype,
                    device="meta")
    return KVCache(k=x, v=x)


def cache_axes() -> KVCache:
    return KVCache(k=("batch", "kv_heads", None, None),
                   v=("batch", "kv_heads", None, None))
