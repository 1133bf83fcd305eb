"""Shared layer primitives: norms, RoPE, embeddings
(``repro.models.layers``)."""

from __future__ import annotations

import torch

from repro_torch.models.sharding import shard
from repro_torch.models.spec import ParamSpec

F32 = torch.float32


def norm_spec(d: int, kind: str) -> dict:
    if kind == "rmsnorm":
        return {"scale": ParamSpec((d,), (None,), init="ones")}
    return {
        "scale": ParamSpec((d,), (None,), init="ones"),
        "bias": ParamSpec((d,), (None,), init="zeros"),
    }


def apply_norm(p: dict, x: torch.Tensor, *, kind: str,
               eps: float) -> torch.Tensor:
    xf = x.to(F32)
    if kind == "rmsnorm":
        ms = torch.mean(xf * xf, dim=-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * p["scale"].to(F32)
    else:
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * p["scale"].to(F32) + p["bias"].to(F32)
    return y.to(x.dtype)


def rope_frequencies(d_head: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, d_head, 2, dtype=F32,
                                         device=device) / d_head))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [B, H, S, D]; positions: [B, S] (int).  Rotates the two halves
    of the head (not interleaved pairs)."""
    d = x.shape[-1]
    freqs = rope_frequencies(d, theta, x.device)                  # [D/2]
    angles = positions[:, None, :, None].to(F32) * freqs          # [B,1,S,D/2]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.to(F32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(seq: int, d: int, device=None) -> torch.Tensor:
    """Whisper's fixed sinusoid table [seq, d] in float32: the sines of
    position x 10000^(-i / (d/2 - 1)) in the first half, their cosines in
    the second."""
    pos = torch.arange(seq, dtype=F32, device=device)[:, None]
    return sinusoid(pos, d)


def sinusoid(pos: torch.Tensor, d: int) -> torch.Tensor:
    """The sinusoid rows of the float32 positions ``pos`` [..., 1]:
    [..., d]."""
    dim = torch.arange(d // 2, dtype=F32, device=pos.device)
    # The rate in float32 throughout, as the reference computes it.
    rate = torch.log(torch.tensor(10000.0, dtype=F32)) / max(d // 2 - 1, 1)
    inv = torch.exp(-dim * rate.to(pos.device))
    ang = pos * inv
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def embed_spec(vocab: int, d: int) -> dict:
    return {"tokens": ParamSpec((vocab, d), ("vocab", None),
                                init="small_normal")}


def embed(p: dict, tokens: torch.Tensor, *, rules=None) -> torch.Tensor:
    """[B, S] int -> [B, S, d]."""
    return shard(p["tokens"][tokens.long()], rules, "batch", None, None)


def unembed_spec(d: int, vocab: int) -> dict:
    return {"w": ParamSpec((d, vocab), (None, "vocab"))}


def logits(p_unembed: dict | None, p_embed: dict, x: torch.Tensor, *,
           tied: bool, rules=None) -> torch.Tensor:
    w = p_embed["tokens"].T if tied else p_unembed["w"]
    return shard(torch.matmul(x, w.to(x.dtype)), rules, "batch", None,
                 "vocab")
