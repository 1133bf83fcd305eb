"""Model API of the serving path (``repro.models.lm``): ``init``,
``prefill``, ``decode``, ``make_cache`` and ``pad_cache`` for the
decoder-only architectures.  The encoder-decoder (whisper) and the
training loss come with later slices.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import common as kc
from repro_torch.models import attention as attn_m
from repro_torch.models import spec as sp
from repro_torch.models import transformer as tfm


def _decoder_only(cfg: ArchConfig) -> None:
    if cfg.is_encdec:
        raise NotImplementedError(
            "the encoder-decoder (whisper) is not ported yet (ROADMAP "
            "section 1, item 9)")


def model_spec(cfg: ArchConfig) -> dict:
    _decoder_only(cfg)
    return tfm.decoder_spec(cfg)


def init(gen: torch.Generator, cfg: ArchConfig, *, device="cuda") -> dict:
    """Random parameters drawn from ``gen`` (on its own device), on
    ``device``."""
    device = kc.resolve_device(device)
    params = sp.init_tree(gen, model_spec(cfg), tfm.dtype_of(cfg),
                          gen.device)
    return sp.tree_map(lambda x: x.to(device), params)


def loss_fn(*args, **kwargs):
    raise NotImplementedError("training (the loss, the flash backward and "
                              "the optimizer) is not ported yet (ROADMAP "
                              "section 1, item 9)")


def prefill(cfg: ArchConfig, params: dict, batch: dict, *, window: int = 0):
    """batch {"tokens": [B, S]} -> (last-token logits [B, V], stacked
    caches of S slots)."""
    _decoder_only(cfg)
    out = tfm.forward(cfg, params, batch["tokens"], emit_cache=True,
                      window=window)
    return out.logits[:, -1, :], out.cache


def decode(cfg: ArchConfig, params: dict, token: torch.Tensor, cache,
           pos: int):
    """One token per sequence at position ``pos``; the cache is updated
    in place and returned."""
    _decoder_only(cfg)
    return tfm.decode_step(cfg, params, token, cache, pos)


def make_cache(cfg: ArchConfig, batch: int, s_max: int, *, device="cuda"):
    _decoder_only(cfg)
    return tfm.make_cache(cfg, batch, s_max,
                          device=kc.resolve_device(device))


def pad_cache(cfg: ArchConfig, cache, s_max: int):
    """Grow prefill KV caches ([R, B, H, S, D]) to ``s_max`` decode
    slots."""

    def one(entry):
        if isinstance(entry, attn_m.KVCache) and entry.k.shape[-2] < s_max:
            pad = (0, 0, 0, s_max - entry.k.shape[-2])
            return attn_m.KVCache(k=F.pad(entry.k, pad),
                                  v=F.pad(entry.v, pad))
        return entry

    return sp.tree_map(one, cache)
