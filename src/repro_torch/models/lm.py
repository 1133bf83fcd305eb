"""Model API (``repro.models.lm``): every arch resolves to the same
entry points, ``model_spec``, ``init``, the training loss
(``cross_entropy``, ``loss_fn``), and the serving entry points
``prefill``, ``decode``, ``make_cache`` and ``pad_cache``; the
encoder-decoder (whisper, ``cfg.is_encdec``) through
:mod:`repro_torch.models.whisper`, the others through
:mod:`repro_torch.models.transformer`.

The sharding half: ``param_shapes`` and ``input_specs`` (``meta``
tensors for every parameter and every model input of an (arch x shape)
cell), ``param_pspecs`` and ``batch_pspecs`` (their ``PartitionSpec``
trees under :class:`repro_torch.models.sharding.Rules`), and the
keyword ``rules`` of ``loss_fn``, ``prefill`` and ``decode``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.kernels import common as kc
from repro_torch.models import attention as attn_m
from repro_torch.models import spec as sp
from repro_torch.models import transformer as tfm
from repro_torch.models import whisper as wsp


def model_spec(cfg: ArchConfig) -> dict:
    if cfg.is_encdec:
        return wsp.encdec_spec(cfg)
    return tfm.decoder_spec(cfg)


def init(gen: torch.Generator, cfg: ArchConfig, *, device="cuda") -> dict:
    """Random parameters drawn from ``gen`` (on its own device) a block
    at a time, straight into their one copy on ``device``
    (:func:`repro_torch.models.spec.init_tree`)."""
    device = kc.resolve_device(device)
    return sp.init_tree(gen, model_spec(cfg), tfm.dtype_of(cfg), device)


def param_shapes(cfg: ArchConfig) -> dict:
    """Every parameter as a ``meta`` tensor of its shape and type."""
    return sp.shape_tree(model_spec(cfg), tfm.dtype_of(cfg))


def param_pspecs(cfg: ArchConfig, rules) -> dict:
    return sp.pspec_tree(model_spec(cfg), rules)


MOE_AUX_WEIGHT = 0.01


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy, in float32: logits [..., V],
    targets [...] (int)."""
    lf = logits.to(torch.float32)
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, targets.long()[..., None])[..., 0]
    return torch.mean(lse - gold)


def loss_fn(cfg: ArchConfig, params: dict, batch: dict, *,
            rules=None, remat: bool = True):
    """batch {"tokens": [B, S], "targets": [B, S]} (and "frames" [B,
    S_enc, d_model] for an encoder-decoder) -> (loss, metrics): the
    cross-entropy, plus the MoE auxiliary loss where the model reports
    one; metrics hold ``ce_loss`` and ``loss`` (and the model's own).
    With ``remat``, ``cfg.remat_policy`` chooses what the backward
    recomputes (:func:`repro_torch.models.transformer.forward`; whisper
    recomputes each block whole)."""
    if cfg.is_encdec:
        out = wsp.forward(cfg, params, batch["frames"], batch["tokens"],
                          remat=remat, rules=rules)
    else:
        out = tfm.forward(cfg, params, batch["tokens"], remat=remat,
                          rules=rules)
    loss = cross_entropy(out.logits, batch["targets"])
    metrics = dict(out.metrics)
    metrics["ce_loss"] = loss
    if "aux_loss" in metrics:
        loss = loss + MOE_AUX_WEIGHT * metrics["aux_loss"]
    metrics["loss"] = loss
    return loss, metrics


def prefill(cfg: ArchConfig, params: dict, batch: dict, *, window: int = 0,
            rules=None):
    """batch {"tokens": [B, S]} (and "frames" for an encoder-decoder) ->
    (last-token logits [B, V], stacked caches of S slots; whisper's cross
    caches hold the S_enc frames)."""
    if cfg.is_encdec:
        out = wsp.forward(cfg, params, batch["frames"], batch["tokens"],
                          emit_cache=True, rules=rules)
    else:
        out = tfm.forward(cfg, params, batch["tokens"], emit_cache=True,
                          window=window, rules=rules)
    return out.logits[:, -1, :], out.cache


def decode(cfg: ArchConfig, params: dict, token: torch.Tensor, cache,
           pos: int, *, window: int = 0, rules=None):
    """One token per sequence at position ``pos``; the cache is updated
    in place and returned.  ``window`` (decoder-only models) masks the
    cache slots outside the sliding window, as the windowed prefill
    does."""
    if cfg.is_encdec:
        if window:
            raise ValueError("the encoder-decoder takes no window")
        return wsp.decode_step(cfg, params, token, cache, pos, rules=rules)
    return tfm.decode_step(cfg, params, token, cache, pos, window=window,
                           rules=rules)


def make_cache(cfg: ArchConfig, batch: int, s_max: int, *, enc_s: int = 0,
               device="cuda"):
    """Zero decode caches of ``s_max`` slots (an encoder-decoder's cross
    cache of ``enc_s`` frames, ``s_max`` where 0); on the ``meta`` device
    their shapes and types alone (the reference's ``build="spec"``)."""
    device = kc.resolve_device(device)
    if cfg.is_encdec:
        return wsp.make_cache(cfg, batch, s_max, enc_s or s_max,
                              device=device)
    return tfm.make_cache(cfg, batch, s_max, device=device)


def pad_cache(cfg: ArchConfig, cache, s_max: int):
    """Grow prefill KV caches ([R, B, H, S, D]) to ``s_max`` decode
    slots.  As in the reference, every KV cache shorter than ``s_max``
    grows, an encoder-decoder's cross cache too: decode then attends
    over its zero keys as well."""

    def one(entry):
        if isinstance(entry, attn_m.KVCache) and entry.k.shape[-2] < s_max:
            pad = (0, 0, 0, s_max - entry.k.shape[-2])
            return attn_m.KVCache(k=F.pad(entry.k, pad),
                                  v=F.pad(entry.v, pad))
        return entry

    return sp.tree_map(one, cache)


# ---------------------------------------------------------------------------
# Input contracts per (arch x shape) cell
# ---------------------------------------------------------------------------

def cache_len_for(cfg: ArchConfig, shape: ShapeConfig) -> int:
    """Decode-cache length: sliding-window archs cap the KV ring at
    ``cfg.window`` for the long_500k cell (decode then runs with
    ``window=cfg.window``: ``transformer.decode_step`` writes slot ``pos %
    window``)."""
    if shape.kind == "long_decode" and cfg.long_context == "native" \
            and cfg.attn_layers > 0:
        return cfg.window
    if cfg.is_encdec:
        return cfg.max_target_len
    return shape.seq_len


def input_specs(cfg: ArchConfig, shape: ShapeConfig) -> dict:
    """Every model input of this cell as a ``meta`` tensor (the
    reference's ``ShapeDtypeStruct`` stand-ins)."""
    gb, s = shape.global_batch, shape.seq_len

    def tok(*sh):
        return torch.empty(sh, dtype=torch.int32, device="meta")

    def frames():
        return torch.empty((gb, s, cfg.d_model), dtype=tfm.dtype_of(cfg),
                           device="meta")

    if shape.kind == "train":
        if cfg.is_encdec:
            return {"frames": frames(), "tokens": tok(gb, cfg.max_target_len),
                    "targets": tok(gb, cfg.max_target_len)}
        return {"tokens": tok(gb, s), "targets": tok(gb, s)}
    if shape.kind == "prefill":
        if cfg.is_encdec:
            return {"frames": frames(), "tokens": tok(gb, cfg.max_target_len)}
        return {"tokens": tok(gb, s)}
    # decode / long_decode: one new token against a cache
    cache = make_cache(cfg, gb, cache_len_for(cfg, shape), enc_s=s,
                       device="meta")
    return {"token": tok(gb), "cache": cache, "pos": tok()}


def batch_pspecs(cfg: ArchConfig, shape: ShapeConfig, rules) -> dict:
    """PartitionSpecs matching :func:`input_specs` leaf for leaf."""
    specs = input_specs(cfg, shape)
    gb = shape.global_batch
    if shape.kind in ("train", "prefill"):
        return {name: rules.pspec(("batch",) + (None,) * (leaf.ndim - 1),
                                  tuple(leaf.shape))
                for name, leaf in specs.items()}
    if cfg.is_encdec:
        def kv(e):
            p = rules.pspec((None, "batch", "kv_heads", None, None),
                            tuple(e.k.shape))
            return attn_m.KVCache(k=p, v=p)
        cache_p = sp.tree_map(kv, specs["cache"])
    else:
        cache_p = tfm.cache_pspecs(specs["cache"], rules)
    return {"token": rules.pspec(("batch",), (gb,)), "cache": cache_p,
            "pos": rules.pspec(())}
