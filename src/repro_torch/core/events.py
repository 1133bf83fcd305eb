"""Pulse-event representation (port of ``repro.core.events``).

BSS-2 pulse events leave the chip as (14-bit neuron address, 8-bit
timestamp) pairs.  A step's events live in a fixed-capacity
structure-of-arrays buffer; invalid lanes carry ``ADDR_SENTINEL``.  On the
wire an event is one int32 word: address in bits [8, 22), wraparound
timestamp in bits [0, 8), bits [22, 32) zero, so ``word >= 0`` marks a
valid lane and the all-ones word (-1) is the reserved "no event" fill.
Word 0 (address 0, time 0) is a valid event.

Every function takes arbitrary leading (chip, substep) axes; the event
lanes are the last axis.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

ADDR_BITS = 14
ADDR_SENTINEL = -1
TIME_BITS = 8
TIME_MOD = 1 << TIME_BITS

WORD_TIME_BITS = TIME_BITS
WORD_ADDR_SHIFT = TIME_BITS
WORD_TIME_MASK = TIME_MOD - 1
WORD_ADDR_MASK = (1 << ADDR_BITS) - 1
WORD_SENTINEL = -1

I32 = torch.int32


class EventBuffer(NamedTuple):
    """addr : int32[..., capacity]; time : int32[..., capacity];
    valid : bool[..., capacity]."""

    addr: torch.Tensor
    time: torch.Tensor
    valid: torch.Tensor


def _t(x, like: torch.Tensor) -> torch.Tensor:
    """``x`` as an int32 tensor on ``like``'s device."""
    return torch.as_tensor(x, dtype=I32, device=like.device)


def from_spikes(spikes: torch.Tensor, t, capacity: int
                ) -> tuple[EventBuffer, torch.Tensor]:
    """Dense spike mask ``[..., n]`` -> stably compacted event buffer.

    Spiking neuron indices come first in index order; more than
    ``capacity`` spikes are cut (the FPGA event interface is rate
    limited) and the cut count is returned as ``dropped``.  ``t`` is a
    scalar (int or 0-d tensor) stamped on every lane.
    """
    n = spikes.shape[-1]
    spikes = spikes.bool()
    lane = torch.arange(n, device=spikes.device)
    order = torch.argsort(torch.where(spikes, lane, n + lane), dim=-1)
    fired = spikes.sum(-1, dtype=I32)
    lead = spikes.shape[:-1]
    if capacity > n:
        pad = torch.full(lead + (capacity - n,), ADDR_SENTINEL,
                         dtype=order.dtype, device=spikes.device)
        order = torch.cat([order, pad], dim=-1)
    addr = order[..., :capacity].to(I32)
    valid = (torch.arange(capacity, device=spikes.device)
             < torch.clamp(fired, max=capacity)[..., None])
    addr = torch.where(valid, addr, ADDR_SENTINEL)
    time = _t(t, spikes).expand(lead + (capacity,)).contiguous()
    dropped = torch.clamp(fired - capacity, min=0)
    return EventBuffer(addr=addr, time=time, valid=valid), dropped


def sentinel_words(shape, device=None) -> torch.Tensor:
    """An all-sentinel word slab."""
    return torch.full(tuple(shape), WORD_SENTINEL, dtype=I32, device=device)


def wrap8(t: torch.Tensor) -> torch.Tensor:
    """Project a full-width timestamp onto the 8-bit on-wire format."""
    return t & (TIME_MOD - 1)


def wrap8_diff(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Signed smallest difference ``a - b`` under 8-bit wraparound."""
    d = (a - b) & (TIME_MOD - 1)
    return torch.where(d >= TIME_MOD // 2, d - TIME_MOD, d)


def encode_word(addr: torch.Tensor, time: torch.Tensor,
                valid: torch.Tensor) -> torch.Tensor:
    """Pack (addr, time, valid) into the on-wire word (sentinel if invalid)."""
    w = ((addr.to(I32) & WORD_ADDR_MASK) << WORD_ADDR_SHIFT) \
        | wrap8(time.to(I32))
    return torch.where(valid.bool(), w, WORD_SENTINEL).to(I32)


def word_valid(word: torch.Tensor) -> torch.Tensor:
    return word >= 0


def word_addr(word: torch.Tensor) -> torch.Tensor:
    return torch.where(word >= 0, word >> WORD_ADDR_SHIFT, ADDR_SENTINEL)


def word_time(word: torch.Tensor) -> torch.Tensor:
    return torch.where(word >= 0, word & WORD_TIME_MASK, 0)


def decode_word(word: torch.Tensor):
    return word_addr(word), word_time(word), word_valid(word)


def word_sort_key(word: torch.Tensor, now) -> torch.Tensor:
    """Wrap-aware merge key: ``(word - now + 128) & 255`` for valid words,
    256 for invalid ones.  ``now`` broadcasts against ``word``."""
    rel = (word - now + TIME_MOD // 2) & WORD_TIME_MASK
    return torch.where(word >= 0, rel, TIME_MOD)


def word_deadline(word: torch.Tensor, now) -> torch.Tensor:
    """Full-width deadline of a word relative to ``now`` (0 if invalid)."""
    now = _t(now, word)
    return torch.where(word >= 0,
                       now + wrap8_diff(word & WORD_TIME_MASK, wrap8(now)), 0)
