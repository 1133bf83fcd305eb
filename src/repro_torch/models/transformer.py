"""Decoder-only transformer assembly for the dense, MoE, hybrid and ssm
families (``repro.models.transformer``).

Layers are grouped into a repeating pattern of length
``cfg.pattern_period()`` (dense: 1 [attn_mlp]; granite-moe: 1
[attn_moe]; llama4: 2 [attn_mlp, attn_moe]; zamba2: 6 [5 x ssm, shared
attention+MLP then ssm]; falcon-mamba: 1 [ssm], no attention and no KV
cache); each pattern position's parameters are
stacked over the repeats, and a Python loop over the stacked axis takes
the place of the JAX package's ``lax.scan``.  The same block functions
serve training and prefill (``forward``; with ``emit_cache`` it returns
stacked per-repeat KV and SSM caches) and decode (one token against
those caches, updated in place).  ``forward(..., remat=)`` recomputes
each repeat's activations in the backward as ``jax.checkpoint`` does
around the scan body.  An MoE block reports its routing metrics
(``aux_loss``, ``drop_fraction``, ``bucket_utilization``), which
``forward`` sums over the pattern positions of a repeat and averages over
the repeats, as the reference does.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch
from torch.utils import checkpoint as tcp

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models import layers as ly
from repro_torch.models import mlp as mlpm
from repro_torch.models import moe as moem
from repro_torch.models import ssm as ssmm
from repro_torch.models.sharding import shard
from repro_torch.models.spec import stack_specs, tree_map, unstack


def block_kinds(cfg: ArchConfig) -> list[str]:
    """Block kind per pattern position: attn_mlp | attn_moe | ssm |
    shared_ssm."""
    period = cfg.pattern_period()
    kinds = []
    for pos in range(period):
        if cfg.family == "ssm":
            kinds.append("ssm")
        elif cfg.family == "hybrid":
            kinds.append("shared_ssm" if pos == period - 1 else "ssm")
        elif cfg.n_experts and ((pos + 1) % cfg.moe_every == 0):
            kinds.append("attn_moe")
        else:
            kinds.append("attn_mlp")
    return kinds


def n_repeats(cfg: ArchConfig) -> int:
    return cfg.n_layers // cfg.pattern_period()


def _block_spec(cfg: ArchConfig, kind: str) -> dict:
    d = cfg.d_model
    if kind in ("ssm", "shared_ssm"):
        return {"norm": ly.norm_spec(d, cfg.norm), "ssm": ssmm.ssm_spec(cfg)}
    spec = shared_attn_spec(cfg)
    if kind == "attn_moe":
        del spec["mlp"]
        spec["moe"] = moem.moe_spec(cfg)
    return spec


def shared_attn_spec(cfg: ArchConfig) -> dict:
    """An attention+MLP block (zamba2's shared block has one weight
    copy)."""
    d = cfg.d_model
    return {
        "attn_norm": ly.norm_spec(d, cfg.norm),
        "attn": attn.attn_spec(cfg),
        "ffn_norm": ly.norm_spec(d, cfg.norm),
        "mlp": mlpm.mlp_spec(cfg),
    }


def decoder_spec(cfg: ArchConfig) -> dict:
    kinds = block_kinds(cfg)
    blocks = {f"pos{i}": _block_spec(cfg, k) for i, k in enumerate(kinds)}
    spec: dict[str, Any] = {
        "embed": ly.embed_spec(cfg.vocab_size, cfg.d_model),
        "blocks": stack_specs(blocks, n_repeats(cfg)),
        "final_norm": ly.norm_spec(cfg.d_model, cfg.norm),
    }
    if cfg.shared_attn:
        spec["shared"] = shared_attn_spec(cfg)
    if not cfg.tie_embeddings:
        spec["unembed"] = ly.unembed_spec(cfg.d_model, cfg.vocab_size)
    return spec


def _norm(cfg, p, x):
    return ly.apply_norm(p, x, kind=cfg.norm, eps=cfg.norm_eps)


def _apply_attn_block(cfg, bp, x, positions, *, window, emit_cache, rules):
    h = _norm(cfg, bp["attn_norm"], x)
    q, k, v = attn.project_qkv(cfg, bp["attn"], h, h, positions, positions,
                               use_rope=True, rules=rules)
    o = attn.prefill_attention(q, k, v, causal=True, window=window)
    x = x + attn.output_proj(bp["attn"], o, rules=rules)
    return x, (attn.KVCache(k=k, v=v) if emit_cache else None)


def _apply_ffn(cfg, bp, x, rules=None):
    """The block's FFN with its residual: (x, metrics), the MoE's routing
    metrics where the block has experts, else {}."""
    h = _norm(cfg, bp["ffn_norm"], x)
    if "moe" in bp:
        y, metrics = moem.moe_apply(cfg, bp["moe"], h, rules=rules)
        return x + y, metrics
    return x + mlpm.mlp_apply(cfg, bp["mlp"], h, rules=rules), {}


def _apply_block(cfg, kind, bp, shared, x, positions, *, window,
                 emit_cache, rules=None):
    """Returns (x, cache entry or None, metrics)."""
    if kind in ("ssm", "shared_ssm"):
        cache = None
        if kind == "shared_ssm" and shared is not None:
            x, cache = _apply_attn_block(cfg, shared, x, positions,
                                         window=window, emit_cache=emit_cache,
                                         rules=rules)
            x, _ = _apply_ffn(cfg, shared, x, rules)
        h = _norm(cfg, bp["norm"], x)
        if emit_cache:
            y, sstate = ssmm.ssm_apply(cfg, bp["ssm"], h, return_state=True,
                                       rules=rules)
            return x + y, {"kv": cache, "ssm": sstate}, {}
        return x + ssmm.ssm_apply(cfg, bp["ssm"], h, rules=rules), None, {}
    x, cache = _apply_attn_block(cfg, bp, x, positions, window=window,
                                 emit_cache=emit_cache, rules=rules)
    x, metrics = _apply_ffn(cfg, bp, x, rules)
    return x, ({"kv": cache, "ssm": None} if emit_cache else None), metrics


class DecoderOutput(NamedTuple):
    logits: torch.Tensor
    metrics: dict       # MoE routing metrics (empty without experts)
    cache: Any          # stacked per-repeat cache tree (prefill) or None


def dtype_of(cfg: ArchConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _stack(entries: list):
    """Stack a list of per-repeat cache entries along a new leading
    axis."""
    first = entries[0]
    if first is None:
        return None
    if isinstance(first, dict):
        return {k: _stack([e[k] for e in entries]) for k in first}
    return type(first)(*(torch.stack(xs) for xs in zip(*entries)))


# The products that the "dots" policy keeps, as JAX's
# dots_with_no_batch_dims_saveable keeps dot_generals without batch
# dimensions: the projections (a [B, S, d] x [d, n] matmul is one aten.mm).
_SAVED_OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (tcp.CheckpointPolicy.MUST_SAVE if op in _SAVED_OPS
            else tcp.CheckpointPolicy.PREFER_RECOMPUTE)


def _dots_contexts():
    return tcp.create_selective_checkpoint_contexts(_dots_policy)


def forward(cfg: ArchConfig, params: dict, tokens: torch.Tensor, *,
            window: int = 0, emit_cache: bool = False,
            remat: bool = False, rules=None) -> DecoderOutput:
    """tokens [B, S] -> logits [B, S, V] (and the stacked caches).
    With ``remat``, ``cfg.remat_policy`` chooses what the backward
    recomputes, as in the reference: ``"dots"`` keeps only the outputs
    of each repeat's matrix products, ``"none"`` keeps everything, and
    any other policy recomputes each repeat of the layer pattern whole
    (``torch.utils.checkpoint``, non-reentrant).  ``metrics`` holds each
    MoE metric summed over the pattern positions of a repeat, then
    averaged over the repeats.  ``rules`` (``models/sharding.py``) places
    the activations where the reference constrains them."""
    kinds = block_kinds(cfg)
    shared = params.get("shared")
    b, s = tokens.shape[:2]
    positions = torch.arange(s, dtype=torch.int32,
                             device=tokens.device).expand(b, s)
    x = ly.embed(params["embed"], tokens, rules=rules).to(dtype_of(cfg))
    policy = cfg.remat_policy if remat else "none"

    def body(x, blk):
        entries, sums = [], {}
        for i, kind in enumerate(kinds):
            x, entry, metrics = _apply_block(
                cfg, kind, blk[f"pos{i}"], shared, x, positions,
                window=window, emit_cache=emit_cache, rules=rules)
            entries.append(entry)
            for k, v in metrics.items():
                sums[k] = sums.get(k, 0.0) + v
        return x, entries, sums

    caches = {f"pos{i}": [] for i in range(len(kinds))}
    per_repeat = []
    repeats = unstack(params["blocks"], n_repeats(cfg))
    for blk in repeats:
        if policy == "none" or emit_cache:
            x, entries, sums = body(x, blk)
        else:
            x, entries, sums = tcp.checkpoint(
                body, x, blk, use_reentrant=False,
                **({"context_fn": _dots_contexts} if policy == "dots"
                   else {}))
        per_repeat.append(sums)
        if emit_cache:
            for i, entry in enumerate(entries):
                caches[f"pos{i}"].append(entry)
    metrics = {k: torch.stack([m[k] for m in per_repeat]).mean()
               for k in per_repeat[0]}
    x = _norm(cfg, params["final_norm"], x)
    lg = ly.logits(params.get("unembed"), params["embed"], x,
                   tied=cfg.tie_embeddings, rules=rules)
    cache = {k: _stack(v) for k, v in caches.items()} if emit_cache else None
    return DecoderOutput(logits=lg, metrics=metrics, cache=cache)


def decode_step(cfg: ArchConfig, params: dict, token: torch.Tensor, cache,
                pos: int, *, window: int = 0, rules=None):
    """token [B] at position ``pos`` (the tokens already in the cache)
    -> (logits [B, V], cache).  The cache is updated in place (slot ``pos
    % S_max``: a cache of ``window`` slots is a ring); with ``rules`` each
    updated KV cache is pinned to its declared placement, as the
    reference pins its loop-carried cache.  ``window`` reaches
    ``decode_attention``, so a windowed prefill is followed by a windowed
    step over a padded cache too; the reference's ``decode_step`` takes
    ``window`` and drops it (ROADMAP.md section 3)."""
    kinds = block_kinds(cfg)
    shared = params.get("shared")
    b = token.shape[0]
    pos = int(pos)
    positions = torch.full((b, 1), pos, dtype=torch.int32,
                           device=token.device)
    x = ly.embed(params["embed"], token[:, None],
                 rules=rules).to(dtype_of(cfg))

    def attn_decode(bp, x, kv):
        h = _norm(cfg, bp["attn_norm"], x)
        q, k, v = attn.project_qkv(cfg, bp["attn"], h, h, positions,
                                   positions, use_rope=True, rules=rules)
        s_max = kv.k.shape[2]
        kv = attn.cache_update(kv, k, v, pos % s_max)
        kv = attn.KVCache(
            k=shard(kv.k, rules, "batch", "kv_heads", None, None),
            v=shard(kv.v, rules, "batch", "kv_heads", None, None))
        o = attn.decode_attention(q, kv, min(pos + 1, s_max), window=window)
        return x + attn.output_proj(bp["attn"], o, rules=rules)

    for r, blk in enumerate(unstack(params["blocks"], n_repeats(cfg))):
        for i, kind in enumerate(kinds):
            bp = blk[f"pos{i}"]
            entry = cache[f"pos{i}"]
            kv = None if entry["kv"] is None else attn.KVCache(
                k=entry["kv"].k[r], v=entry["kv"].v[r])
            if kind in ("ssm", "shared_ssm"):
                if kind == "shared_ssm" and shared is not None:
                    x = attn_decode(shared, x, kv)
                    x, _ = _apply_ffn(cfg, shared, x, rules)
                st = entry["ssm"]
                h = _norm(cfg, bp["norm"], x)
                y, new = ssmm.ssm_decode(
                    cfg, bp["ssm"], h, ssmm.SSMState(h=st.h[r],
                                                     conv=st.conv[r]),
                    rules=rules)
                st.h[r].copy_(new.h)
                st.conv[r].copy_(new.conv)
                x = x + y
            else:
                x = attn_decode(bp, x, kv)
                # An MoE block routes the step's B tokens at their own
                # capacity (at least 8 slots an expert); its metrics are
                # dropped, as the reference's decode drops them.
                x, _ = _apply_ffn(cfg, bp, x, rules)
    x = _norm(cfg, params["final_norm"], x)
    lg = ly.logits(params.get("unembed"), params["embed"], x,
                   tied=cfg.tie_embeddings, rules=rules)
    return lg[:, 0, :], cache


def make_cache(cfg: ArchConfig, batch: int, s_max: int, *, device) -> dict:
    """Stacked per-repeat decode cache of zeros; on the ``meta`` device
    its shapes and types alone (the reference's ``build="spec"``)."""
    dtype = dtype_of(cfg)
    r = n_repeats(cfg)
    out = {}
    for i, kind in enumerate(block_kinds(cfg)):
        has_attn = kind in ("attn_mlp", "attn_moe") or (
            kind == "shared_ssm" and cfg.shared_attn)
        kv = ssm = None
        if has_attn:
            kv = attn.init_cache(cfg, batch, s_max, dtype, device)
        if kind in ("ssm", "shared_ssm"):
            ssm = ssmm.init_ssm_state(cfg, batch, dtype, device)
        out[f"pos{i}"] = {"kv": kv, "ssm": ssm}
    return tree_map(
        lambda e: None if e is None else type(e)(
            *(x.expand((r,) + x.shape).clone() for x in e)), out)


def cache_pspecs(cache_tree, rules) -> dict:
    """PartitionSpecs of a stacked cache tree, by the entries' types: KV
    [R, B, Hkv, S, D], SSM h [R, B, di, N] and conv [R, B, K-1, di]."""

    def one(entry):
        if entry is None:
            return None
        if isinstance(entry, attn.KVCache):
            p = rules.pspec((None, "batch", "kv_heads", None, None),
                            tuple(entry.k.shape))
            return attn.KVCache(k=p, v=p)
        if isinstance(entry, ssmm.SSMState):
            return ssmm.SSMState(
                h=rules.pspec((None, "batch", "d_inner", None),
                              tuple(entry.h.shape)),
                conv=rules.pspec((None, "batch", None, "d_inner"),
                                 tuple(entry.conv.shape)))
        raise TypeError(type(entry))

    return tree_map(one, cache_tree)
