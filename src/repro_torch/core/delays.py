"""Axonal-delay ring buffers (port of ``repro.core.delays``).

``ring[..., D, n_inputs]`` holds the pending spike counts of the next D
steps; depositing an event adds one at ``((now + ahead) mod D, addr)``,
popping returns and zeroes slot ``now mod D``.  ``now`` carries the same
leading (chip) axes as the ring.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import events as ev

I32 = torch.int32


class DelayRing(NamedTuple):
    """ring : int32[..., D, n_inputs]; now : int32[...]."""

    ring: torch.Tensor
    now: torch.Tensor

    @property
    def depth(self) -> int:
        return self.ring.shape[-2]

    @property
    def n_inputs(self) -> int:
        return self.ring.shape[-1]


def init(depth: int, n_inputs: int, *, now: int = 0, dtype=I32,
         batch_shape: tuple[int, ...] = (), device=None) -> DelayRing:
    return DelayRing(
        ring=torch.zeros(batch_shape + (depth, n_inputs), dtype=dtype,
                         device=device),
        now=torch.full(batch_shape, now, dtype=I32, device=device))


def _lanes(x, like: torch.Tensor) -> torch.Tensor:
    """A per-chip scalar broadcast against the lane axis of ``like``."""
    x = torch.as_tensor(x, dtype=I32, device=like.device)
    return x[..., None] if x.dim() else x


def deposit_judgment(words: torch.Tensor, *, now, min_ahead, depth: int,
                     n_inputs: int):
    """Admission of wire words into the ring: deliverable iff
    ``min_ahead < ahead <= depth`` with ``ahead`` the wrap difference of
    the word's timestamp to ``now``.  Returns ``(deliverable, slot, col,
    expired)``."""
    now = _lanes(now, words)
    min_ahead = _lanes(min_ahead, words)
    valid = ev.word_valid(words)
    ahead = ev.wrap8_diff(words & ev.WORD_TIME_MASK, ev.wrap8(now))
    deliverable = valid & (ahead > min_ahead) & (ahead <= depth)
    expired = (valid & ~deliverable).sum(-1, dtype=I32)
    slot = torch.where(deliverable, torch.remainder(now + ahead, depth), 0)
    col = torch.where(deliverable,
                      ev.word_addr(words).clamp(0, n_inputs - 1), 0)
    return deliverable, slot, col, expired


def deposit_words(state: DelayRing, words: torch.Tensor, *, now=None,
                  min_ahead=0) -> tuple[DelayRing, torch.Tensor]:
    """Scatter wire words ``[..., L]`` into their deadline slots.  Returns
    ``(state, expired)``; the clock is untouched."""
    if now is None:
        now = state.now
    d, n_in = state.depth, state.n_inputs
    deliverable, slot, col, expired = deposit_judgment(
        words, now=now, min_ahead=min_ahead, depth=d, n_inputs=n_in)
    lead = state.ring.shape[:-2]
    flat = state.ring.reshape(lead + (d * n_in,)).clone()
    idx = (slot * n_in + col).long().expand(lead + words.shape[-1:])
    flat.scatter_add_(-1, idx,
                      deliverable.to(flat.dtype).expand(idx.shape))
    return DelayRing(ring=flat.reshape(state.ring.shape),
                     now=state.now), expired


def pop_current(state: DelayRing) -> tuple[DelayRing, torch.Tensor]:
    """Return (and zero) the slot whose deadline is ``now``."""
    slot = torch.remainder(state.now, state.depth).long()
    idx = slot[..., None, None].expand(
        state.ring.shape[:-2] + (1, state.n_inputs))
    spikes = state.ring.gather(-2, idx).squeeze(-2)
    ring = state.ring.scatter(-2, idx, 0)
    return DelayRing(ring=ring, now=state.now), spikes


def tick(state: DelayRing) -> DelayRing:
    return DelayRing(ring=state.ring, now=state.now + 1)
