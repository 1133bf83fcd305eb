"""Credit-based flow control: the NHTL-Extoll host ring buffer protocol
(port of ``repro.core.flowcontrol``).

The producer (the FPGA) may only write into the consumer's ring buffer
while it holds credits; the consumer (the host) returns credits by a
notification after reading.  The protocol is explicit state threaded
through the run, with the real protocol's invariants:

  * the producer never overwrites an unconsumed slot
    (written - consumed <= capacity at all times);
  * no data is lost or duplicated (FIFO order, exactly once);
  * a stalled consumer eventually stalls the producer (back-pressure);
  * credits returned == slots consumed (notification conservation).

Every counter carries the leading (chip) axes it was made with:
``init(capacity, batch_shape=(n_chips,))`` gives ``[n_chips]`` counters,
``sendq_init(depth, batch_shape=(n_chips,))`` a ``[n_chips, depth]``
queue.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import events as ev

I32 = torch.int32


class RingState(NamedTuple):
    """head: next write slot; tail: next read slot (absolute counters, the
    slot is counter % capacity); notifications: credit-return messages;
    capacity: slots.  All int32 ``[...]``."""

    head: torch.Tensor
    tail: torch.Tensor
    notifications: torch.Tensor
    capacity: torch.Tensor


def init(capacity: int, *, batch_shape: tuple[int, ...] = (),
         device=None) -> RingState:
    z = lambda v: torch.full(batch_shape, v, dtype=I32,  # noqa: E731
                             device=device)
    return RingState(head=z(0), tail=z(0), notifications=z(0),
                     capacity=z(capacity))


def _at_most(x: torch.Tensor, n) -> torch.Tensor:
    """``min(x, n)`` for an int or a tensor ``n``; an int is never copied
    to the device (a copy from host memory would wait for the stream)."""
    if isinstance(n, torch.Tensor):
        return torch.minimum(x, n.to(I32))
    return torch.clamp(x, max=int(n))


def credits(state: RingState) -> torch.Tensor:
    return state.capacity - (state.head - state.tail)


def produce(state: RingState, n) -> tuple[RingState, torch.Tensor]:
    """The producer wants to write ``n`` slots and is granted
    ``min(n, credits)``.  Returns ``(state, accepted)``; the rest stays in
    the producer's send queue (back-pressure), never silently dropped."""
    accepted = _at_most(torch.clamp(credits(state), min=0), n)
    return state._replace(head=state.head + accepted), accepted


def consume(state: RingState, n) -> tuple[RingState, torch.Tensor]:
    """The consumer reads up to ``n`` available slots and returns their
    credits by one notification.  Returns ``(state, consumed)``."""
    available = state.head - state.tail
    consumed = _at_most(torch.clamp(available, min=0), n)
    return state._replace(
        tail=state.tail + consumed,
        notifications=state.notifications + (consumed > 0).to(I32),
    ), consumed


class SendQueue(NamedTuple):
    """Bounded retransmit queue at the injection point: credit-stalled
    wire words and the destination chip their bucket was bound to (the
    word carries only the destination input row); empty slots hold the
    word sentinel / -1.  ``[..., depth]``."""

    words: torch.Tensor
    dest: torch.Tensor

    def occupancy(self) -> torch.Tensor:
        return ev.word_valid(self.words).sum(-1, dtype=I32)


def sendq_init(depth: int, *, batch_shape: tuple[int, ...] = (),
               device=None) -> SendQueue:
    shape = tuple(batch_shape) + (depth,)
    return SendQueue(words=ev.sentinel_words(shape, device=device),
                     dest=torch.full(shape, -1, dtype=I32, device=device))


def slot_indices(state: RingState, width: int, *, count=None,
                 producer: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """Physical ring slots of the next ``width`` writes (``producer``) or
    reads, ``[..., width]``, and the mask of the first ``count`` of them
    (default: all)."""
    if not isinstance(width, int):
        raise TypeError(f"width must be an int, got {type(width).__name__};"
                        " pass a tensor as count= instead")
    base = state.head if producer else state.tail
    offsets = torch.arange(width, dtype=I32, device=base.device)
    n = torch.as_tensor(width if count is None else count, dtype=I32,
                        device=base.device)
    slots = torch.remainder(base[..., None] + offsets,
                            state.capacity[..., None])
    return slots, offsets < n[..., None]
