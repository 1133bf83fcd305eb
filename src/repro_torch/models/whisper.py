"""Whisper-style encoder-decoder, the whisper-medium config
(``repro.models.whisper``).

The conv1d audio frontend is a stub, as in the reference: the model takes
precomputed frame embeddings [B, S_enc, d_model].  Both stacks add
sinusoidal positions; the embeddings are tied.  The encoder's
self-attention and the decoder's cross-attention run the flash-attention
kernel without the causal mask (``prefill_attention(..., causal=False)``),
the cross-attention with Sq (decoder tokens) apart from Skv (frames); the
decoder's self-attention is causal.  A Python loop over each stack's
stacked layers takes the place of the reference's ``lax.scan``; with
``remat`` each block is recomputed whole in the backward
(``torch.utils.checkpoint``, non-reentrant), as ``jax.checkpoint(body)``
does; ``cfg.remat_policy`` does not apply, as in the reference.

Decode takes one token against the decoder's self cache (updated in
place at ``pos % s_max``) and the cross cache that prefill projected from
the encoder's output, read over its whole length.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch
from torch.utils import checkpoint as tcp

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models import layers as ly
from repro_torch.models import mlp as mlpm
from repro_torch.models.spec import stack_specs, unstack
from repro_torch.models.transformer import dtype_of


def _enc_block_spec(cfg: ArchConfig) -> dict:
    d = cfg.d_model
    return {
        "attn_norm": ly.norm_spec(d, cfg.norm),
        "attn": attn.attn_spec(cfg),
        "ffn_norm": ly.norm_spec(d, cfg.norm),
        "mlp": mlpm.mlp_spec(cfg),
    }


def _dec_block_spec(cfg: ArchConfig) -> dict:
    d = cfg.d_model
    return {
        "self_norm": ly.norm_spec(d, cfg.norm),
        "self_attn": attn.attn_spec(cfg),
        "cross_norm": ly.norm_spec(d, cfg.norm),
        "cross_attn": attn.attn_spec(cfg, cross=True),
        "ffn_norm": ly.norm_spec(d, cfg.norm),
        "mlp": mlpm.mlp_spec(cfg),
    }


def encdec_spec(cfg: ArchConfig) -> dict:
    return {
        "embed": ly.embed_spec(cfg.vocab_size, cfg.d_model),
        "enc_blocks": stack_specs({"blk": _enc_block_spec(cfg)},
                                  cfg.encoder_layers),
        "enc_final_norm": ly.norm_spec(cfg.d_model, cfg.norm),
        "dec_blocks": stack_specs({"blk": _dec_block_spec(cfg)},
                                  cfg.n_layers),
        "final_norm": ly.norm_spec(cfg.d_model, cfg.norm),
    }


def _norm(cfg, p, x):
    return ly.apply_norm(p, x, kind=cfg.norm, eps=cfg.norm_eps)


def _run(body, x, blocks: list, remat: bool) -> tuple[torch.Tensor, list]:
    """``body(x, blk) -> (x, out)`` over the stacked layers in turn, each
    recomputed whole in the backward with ``remat``; returns (x, the
    outputs)."""
    outs = []
    for blk in blocks:
        if remat:
            x, out = tcp.checkpoint(body, x, blk, use_reentrant=False)
        else:
            x, out = body(x, blk)
        outs.append(out)
    return x, outs


def encode(cfg: ArchConfig, params: dict, frames: torch.Tensor, *,
           remat: bool = False, rules=None) -> torch.Tensor:
    """frames [B, S_enc, d_model] (the frontend stub's embeddings) -> the
    encoder's output [B, S_enc, d_model] in the model's type."""
    s = frames.shape[1]
    x = frames.to(dtype_of(cfg))
    x = x + ly.sinusoidal_positions(s, cfg.d_model, frames.device).to(x.dtype)

    def body(x, blk):
        bp = blk["blk"]
        h = _norm(cfg, bp["attn_norm"], x)
        q, k, v = attn.project_qkv(cfg, bp["attn"], h, h, None, None,
                                   use_rope=False, rules=rules)
        o = attn.prefill_attention(q, k, v, causal=False)
        x = x + attn.output_proj(bp["attn"], o, rules=rules)
        h = _norm(cfg, bp["ffn_norm"], x)
        return x + mlpm.mlp_apply(cfg, bp["mlp"], h, rules=rules), None

    x, _ = _run(body, x, unstack(params["enc_blocks"], cfg.encoder_layers),
                remat)
    return _norm(cfg, params["enc_final_norm"], x)


class EncDecOutput(NamedTuple):
    logits: torch.Tensor
    metrics: dict       # empty: the model reports no metrics
    cache: Any          # {"self": KVCache, "cross": KVCache} stacked, or None


def _stack(caches: list) -> attn.KVCache:
    return attn.KVCache(k=torch.stack([c.k for c in caches]),
                        v=torch.stack([c.v for c in caches]))


def forward(cfg: ArchConfig, params: dict, frames: torch.Tensor,
            tokens: torch.Tensor, *, emit_cache: bool = False,
            remat: bool = False, rules=None) -> EncDecOutput:
    """frames [B, S_enc, d_model], tokens [B, S] -> logits [B, S, V] (and,
    with ``emit_cache``, the decoder's self caches of S slots and its
    cross caches of S_enc, each stacked over the layers)."""
    enc_out = encode(cfg, params, frames, remat=remat, rules=rules)
    s = tokens.shape[1]
    y = ly.embed(params["embed"], tokens, rules=rules).to(dtype_of(cfg))
    y = y + ly.sinusoidal_positions(s, cfg.d_model, tokens.device).to(y.dtype)

    def body(y, blk):
        bp = blk["blk"]
        h = _norm(cfg, bp["self_norm"], y)
        q, k, v = attn.project_qkv(cfg, bp["self_attn"], h, h, None, None,
                                   use_rope=False, rules=rules)
        o = attn.prefill_attention(q, k, v, causal=True)
        y = y + attn.output_proj(bp["self_attn"], o, rules=rules)
        h = _norm(cfg, bp["cross_norm"], y)
        qc, kc, vc = attn.project_qkv(cfg, bp["cross_attn"], h, enc_out,
                                      None, None, use_rope=False, rules=rules)
        oc = attn.prefill_attention(qc, kc, vc, causal=False)
        y = y + attn.output_proj(bp["cross_attn"], oc, rules=rules)
        h = _norm(cfg, bp["ffn_norm"], y)
        y = y + mlpm.mlp_apply(cfg, bp["mlp"], h, rules=rules)
        caches = None
        if emit_cache:
            caches = (attn.KVCache(k=k, v=v), attn.KVCache(k=kc, v=vc))
        return y, caches

    y, caches = _run(body, y, unstack(params["dec_blocks"], cfg.n_layers),
                     remat)
    y = _norm(cfg, params["final_norm"], y)
    lg = ly.logits(None, params["embed"], y, tied=True, rules=rules)
    cache = None
    if emit_cache:
        cache = {"self": _stack([c[0] for c in caches]),
                 "cross": _stack([c[1] for c in caches])}
    return EncDecOutput(logits=lg, metrics={}, cache=cache)


def decode_step(cfg: ArchConfig, params: dict, token: torch.Tensor, cache,
                pos: int, *, rules=None):
    """token [B] at position ``pos`` -> (logits [B, V], cache).  The self
    cache [L, B, H, s_max, D] is written in place at ``pos % s_max`` and
    read over ``min(pos + 1, s_max)`` slots; the cross cache [L, B, H,
    S_enc, D] is read over its whole length."""
    pos = int(pos)
    y = ly.embed(params["embed"], token[:, None],
                 rules=rules).to(dtype_of(cfg))
    # The absolute position's sinusoid.
    row = ly.sinusoid(torch.full((1,), float(pos), device=token.device),
                      cfg.d_model)
    y = y + row[None, None, :].to(y.dtype)
    self_c, cross_c = cache["self"], cache["cross"]
    s_max = self_c.k.shape[3]
    for r, blk in enumerate(unstack(params["dec_blocks"], cfg.n_layers)):
        bp = blk["blk"]
        h = _norm(cfg, bp["self_norm"], y)
        q, k, v = attn.project_qkv(cfg, bp["self_attn"], h, h, None, None,
                                   use_rope=False, rules=rules)
        kv = attn.cache_update(attn.KVCache(k=self_c.k[r], v=self_c.v[r]),
                               k, v, pos % s_max)
        o = attn.decode_attention(q, kv, min(pos + 1, s_max))
        y = y + attn.output_proj(bp["self_attn"], o, rules=rules)

        h = _norm(cfg, bp["cross_norm"], y)
        qc = attn.project(h, bp["cross_attn"]["wq"])
        cross = attn.KVCache(k=cross_c.k[r], v=cross_c.v[r])
        oc = attn.decode_attention(qc, cross, cross.k.shape[2])
        y = y + attn.output_proj(bp["cross_attn"], oc, rules=rules)

        h = _norm(cfg, bp["ffn_norm"], y)
        y = y + mlpm.mlp_apply(cfg, bp["mlp"], h, rules=rules)
    y = _norm(cfg, params["final_norm"], y)
    lg = ly.logits(None, params["embed"], y, tied=True, rules=rules)
    return lg[:, 0, :], cache


def make_cache(cfg: ArchConfig, batch: int, s_max: int, enc_s: int, *,
               device) -> dict:
    """Zero caches: the decoder's self cache of ``s_max`` slots and the
    cross cache of ``enc_s`` frames, each [L, B, H, S, D] (on the
    ``meta`` device, their shapes and types alone)."""
    dtype = dtype_of(cfg)

    def stacked(s):
        one = attn.init_cache(cfg, batch, s, dtype, device)
        return attn.KVCache(*(x.expand((cfg.n_layers,) + x.shape).clone()
                              for x in one))

    return {"self": stacked(s_max), "cross": stacked(enc_s)}
