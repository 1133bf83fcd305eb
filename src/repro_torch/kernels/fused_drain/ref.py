"""Plain PyTorch version of the fused drain path: the composed chain of the
reference (``repro.kernels.fused_drain.ref.fused_drain_ref``) — the
optional merge stage, then per substep k the ring deposit against clock
``t0 + k`` with ``min_ahead = extra_ahead + B-1-k`` — for every chip at
once.  This is also the port's unfused drain (``_drain_block_unfused``).

Modes: ``passthrough`` (simplified scheme), ``sort`` (full scheme, each
substep's words time-ordered) and ``rate`` (full scheme through the
rate-limited merge queue).  ``gate[n_chips]`` masks an empty pipeline
carry: a gated-off chip deposits nothing, emits sentinels and keeps its
queue.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import delays as dl
from repro_torch.core import events as ev
from repro_torch.core import merge as mg

MODES = ("passthrough", "sort", "rate")


class FusedDrainOut(NamedTuple):
    """ring        : the updated delay ring (clock untouched)
    words       : int32[B, n_chips, R] emitted words (R = rate in rate
                  mode, else the delivered lane count)
    dep_expired : int32[B, n_chips] deposit-window expiries
    dropped     : int32[B, n_chips] merge-queue congestion drops
    queue       : int32[n_chips, depth] queue after the block (rate mode;
                  passed through otherwise)
    """

    ring: dl.DelayRing
    words: torch.Tensor
    dep_expired: torch.Tensor
    dropped: torch.Tensor
    queue: torch.Tensor | None


def fused_drain_ref(ring: dl.DelayRing, delivered: torch.Tensor,
                    queue: torch.Tensor | None, t0: torch.Tensor, *,
                    mode: str = "passthrough", rate: int = 0,
                    extra_ahead: int = 0,
                    gate: torch.Tensor | None = None) -> FusedDrainOut:
    """``delivered [n_chips, B, L]``, ``queue [n_chips, depth]``,
    ``t0 [n_chips]``."""
    if mode not in MODES:
        raise ValueError(f"unknown drain mode {mode!r}")
    b = delivered.shape[1]
    words = delivered.transpose(0, 1)
    if gate is not None:
        words = torch.where(gate[:, None], words, ev.WORD_SENTINEL)

    dropped = torch.zeros(words.shape[:2], dtype=torch.int32,
                          device=words.device)
    if mode == "rate":
        buf = mg.MergeBuffer(words=queue)
        new_buf, merged, dropped = mg.merge_drain_words(
            buf, words, now0=t0, rate=rate)
        if gate is not None:
            new_buf = mg.MergeBuffer(
                words=torch.where(gate[:, None], new_buf.words, queue))
            merged = torch.where(gate[:, None], merged, ev.WORD_SENTINEL)
            dropped = torch.where(gate, dropped, 0)
        queue = new_buf.words

    out_words, dep_expired = [], []
    for k in range(b):
        now_k = t0 + k
        if mode == "rate":
            words_k = merged[k]
        elif mode == "sort":
            words_k = mg.merge_words(words[k], now_k)
        else:
            words_k = words[k]
        ring, expired = dl.deposit_words(
            ring, words_k, now=now_k, min_ahead=extra_ahead + b - 1 - k)
        out_words.append(words_k)
        dep_expired.append(expired)
    return FusedDrainOut(ring=ring, words=torch.stack(out_words),
                         dep_expired=torch.stack(dep_expired),
                         dropped=dropped, queue=queue)
