"""Merge buffers: time-ordered merging of wire-word streams (port of
``repro.core.merge``).

The merge sorts wire words by the wrap-aware key of
:func:`repro_torch.core.events.word_sort_key`, stably (ties keep lane
order), so FIFO order within a stream survives.  The stream is the last
axis; leading axes are independent chips, and ``now`` carries those
leading axes (or is a scalar).

``use_pallas=True`` (the reference's name for its kernel switch) sorts
with the ``merge_sort_words`` kernel: on CUDA tensors it launches, on
CPU tensors it runs the plain sort.  ``merge_words`` and the default
stay plain PyTorch.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import events as ev

I32 = torch.int32


class MergeBuffer(NamedTuple):
    """Bounded rate-limited merge queue: ``words`` int32[..., depth], kept
    sorted, valid lanes first, sentinel-filled."""

    words: torch.Tensor

    @property
    def depth(self) -> int:
        return self.words.shape[-1]

    def occupancy(self) -> torch.Tensor:
        return ev.word_valid(self.words).sum(-1, dtype=I32)


def merge_init(depth: int, *, batch_shape: tuple[int, ...] = (),
               device=None) -> MergeBuffer:
    return MergeBuffer(words=ev.sentinel_words(batch_shape + (depth,),
                                               device=device))


def _now(now, like: torch.Tensor) -> torch.Tensor:
    now = torch.as_tensor(now, dtype=I32, device=like.device)
    return now[..., None] if now.dim() else now


def merge_words(words: torch.Tensor, now) -> torch.Tensor:
    """Stable ascending sort of ``words[..., L]`` by the wrap key."""
    key = ev.word_sort_key(words, _now(now, words))
    order = torch.sort(key, dim=-1, stable=True).indices
    return words.gather(-1, order)


def _sorted_words(words: torch.Tensor, now, use_pallas: bool) -> torch.Tensor:
    if use_pallas:
        from repro_torch.kernels.merge_sort import ops as ms_ops

        return ms_ops.merge_sort_words(words, now)
    return merge_words(words, now)


def merge_split(all_words_sorted: torch.Tensor, *, rate: int, depth: int):
    """Split one sorted merge cycle into ``(queue[..., depth],
    emitted[..., rate], dropped[...])``: emit the first ``rate`` lanes,
    keep the window ``[rate, rate + depth)``, drop the rest of the
    valid words."""
    out_words = all_words_sorted[..., :rate]
    n_valid = ev.word_valid(all_words_sorted).sum(-1, dtype=I32)
    emitted = torch.clamp(n_valid, max=rate)
    dropped = torch.clamp(n_valid - emitted - depth, min=0)
    return all_words_sorted[..., rate:rate + depth], out_words, dropped


def merge_step_words(buf: MergeBuffer, in_words: torch.Tensor, *, now,
                     rate: int, use_pallas: bool = False):
    """One merge cycle: enqueue, emit the ``rate`` earliest words, keep at
    most ``depth``.  Returns ``(buf, out_words[..., rate], dropped)``."""
    lead = buf.words.shape[:-1]
    pad = ev.sentinel_words(lead + (rate,), device=buf.words.device)
    all_words = torch.cat([buf.words, in_words, pad], dim=-1)
    queue, out, dropped = merge_split(
        _sorted_words(all_words, now, use_pallas),
        rate=rate, depth=buf.depth)
    return MergeBuffer(words=queue), out, dropped


def merge_drain_words(buf: MergeBuffer, in_words: torch.Tensor, *, now0,
                      rate: int, use_pallas: bool = False):
    """Drain a superstep block ``in_words[B, ..., L]`` through the queue,
    substep k judged at ``now0 + k``.  Returns ``(buf, out[B, ..., rate],
    dropped[B, ...])``."""
    now0 = torch.as_tensor(now0, dtype=I32, device=in_words.device)
    outs, drops = [], []
    for k in range(in_words.shape[0]):
        buf, out_k, dropped_k = merge_step_words(
            buf, in_words[k], now=now0 + k, rate=rate, use_pallas=use_pallas)
        outs.append(out_k)
        drops.append(dropped_k)
    return buf, torch.stack(outs), torch.stack(drops)


def merge_step(buf: MergeBuffer, in_addr: torch.Tensor,
               in_deadline: torch.Tensor, in_valid: torch.Tensor, *,
               rate: int, use_pallas: bool = False):
    """SoA view of :func:`merge_step_words` at ``now = 0``: lanes ``[...,
    L]`` encoded to wire words (deadlines through ``wrap8``), the emitted
    words decoded.  Returns ``(buf, (addr, deadline8, valid)[..., rate],
    dropped)``."""
    in_words = ev.encode_word(in_addr, in_deadline, in_valid)
    buf, out_words, dropped = merge_step_words(
        buf, in_words, now=0, rate=rate, use_pallas=use_pallas)
    return buf, ev.decode_word(out_words), dropped
