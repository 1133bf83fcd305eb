"""Destination lookup tables (port of ``repro.core.routing``).

Each (source neuron, k) entry of the LUT holds the destination chip, the
remapped destination address, the axonal delay and an enable bit; K is the
fan-out.  Tables carry a leading chip axis in the network
(``[n_chips, N, K]``); ``route`` broadcasts the table's leading axes
against the events'.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import events as ev

I32 = torch.int32


class RoutingTable(NamedTuple):
    """All fields are ``[..., n_neurons, K]``."""

    dest_chip: torch.Tensor  # int32
    dest_addr: torch.Tensor  # int32
    delay: torch.Tensor      # int32
    valid: torch.Tensor      # bool

    @property
    def n_neurons(self) -> int:
        return self.dest_chip.shape[-2]

    @property
    def fanout(self) -> int:
        return self.dest_chip.shape[-1]


class RoutedEvents(NamedTuple):
    """Events after LUT expansion, one lane per (event, fan-out) pair:
    every field is ``[..., E * K]``."""

    dest_chip: torch.Tensor
    dest_addr: torch.Tensor
    deadline: torch.Tensor
    valid: torch.Tensor


def lut_index(addr: torch.Tensor, n: int) -> torch.Tensor:
    """JAX gather index rule: a negative index wraps once, then every
    index clamps into ``[0, n)`` (torch indexing would raise instead)."""
    addr = torch.where(addr < 0, addr + n, addr)
    return addr.clamp(0, n - 1)


def route(events: ev.EventBuffer, table: RoutingTable) -> RoutedEvents:
    """Expand events through the LUT (gather + deadline computation).

    ``deadline`` rides unmasked on invalid lanes, as in the reference.
    """
    n, k = table.n_neurons, table.fanout
    e = events.addr.shape[-1]
    lead = torch.broadcast_shapes(events.addr.shape[:-1],
                                  table.dest_chip.shape[:-2])
    addr = lut_index(torch.where(events.valid, events.addr, 0), n)
    idx = addr.expand(lead + (e,))[..., None].expand(lead + (e, k)).long()

    def gather(x):
        return x.expand(lead + (n, k)).gather(-2, idx)

    valid = gather(table.valid) & events.valid[..., None]
    deadline = events.time[..., None] + gather(table.delay)
    flat = lambda x: x.reshape(lead + (e * k,))
    return RoutedEvents(
        dest_chip=flat(torch.where(valid, gather(table.dest_chip), 0)).to(I32),
        dest_addr=flat(torch.where(valid, gather(table.dest_addr),
                                   ev.ADDR_SENTINEL)).to(I32),
        deadline=flat(deadline).to(I32),
        valid=flat(valid),
    )


def feedforward_table(n_neurons: int, *, src_chip: int, dst_chip: int,
                      delay: int = 2, remap_offset: int = 0,
                      device=None) -> RoutingTable:
    """The paper's demo topology: chip A projects 1:1 onto chip B."""
    del src_chip  # kept for call-site readability
    dest_addr = ((np.arange(n_neurons) + remap_offset) % n_neurons)
    col = lambda x, dt: torch.as_tensor(np.asarray(x).reshape(-1, 1),
                                        dtype=dt, device=device)
    return RoutingTable(
        dest_chip=col(np.full(n_neurons, dst_chip), I32),
        dest_addr=col(dest_addr, I32),
        delay=col(np.full(n_neurons, delay), I32),
        valid=col(np.ones(n_neurons, bool), torch.bool),
    )


def random_table(generator: torch.Generator, n_neurons: int, n_chips: int,
                 *, fanout: int = 1, max_delay: int = 8, min_delay: int = 1,
                 p_valid: float = 1.0, device=None) -> RoutingTable:
    """A random LUT drawn from ``generator`` (a CPU ``torch.Generator``).

    It cannot reproduce ``jax.random``'s bits: parity tests feed tables
    built by the JAX package through ``repro_torch.convert``.
    """
    shape = (n_neurons, fanout)
    rand = lambda lo, hi: torch.randint(lo, hi, shape, generator=generator,
                                        dtype=I32)
    table = RoutingTable(
        dest_chip=rand(0, n_chips),
        dest_addr=rand(0, n_neurons),
        delay=rand(min_delay, max_delay + 1),
        valid=torch.rand(shape, generator=generator) < p_valid,
    )
    return RoutingTable(*(x.to(device) for x in table))
