"""Transport on one device with an explicit chip axis (port of the
"local" path of ``repro.core.transport``).

The JAX fabric vmaps a per-chip body and lets ``all_to_all`` over the
vmapped axis move the slabs.  Here the chip axis is written out: a block
``[n_chips(src), n_chips(dst), ...]`` is exchanged by swapping its two
leading axes.
"""

from __future__ import annotations

import dataclasses

import torch

I32 = torch.int32


@dataclasses.dataclass(frozen=True)
class LocalTransport:
    """Every chip on one device; ``all_to_all`` swaps the source and
    destination chip axes (a view)."""

    n_chips: int

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        return x.transpose(0, 1)


def exchange_matrix(dest_chip: torch.Tensor, valid: torch.Tensor,
                    n_chips: int) -> torch.Tensor:
    """Event counts by destination chip, ``[..., n_chips]``.

    Destinations outside ``[0, n_chips)`` are dropped; negatives are
    pushed past ``n_chips`` first, as the reference does so that JAX's
    negative-index wrap cannot land them on a real chip.
    """
    dest = torch.where((dest_chip < 0) | (dest_chip >= n_chips), n_chips,
                       dest_chip).long()
    counts = torch.zeros(dest.shape[:-1] + (n_chips + 1,), dtype=I32,
                         device=dest.device)
    counts.scatter_add_(-1, dest, valid.to(I32))
    return counts[..., :n_chips]
