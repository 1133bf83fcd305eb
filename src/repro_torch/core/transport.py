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
    """Every chip on one device, every pair one hop with no latency: the
    exchange swaps the source and destination chip axes (a view).  The
    same two halves as a routed transport's, so one exchange drives
    both."""

    n_chips: int

    def exchange_words_start(self, x: torch.Tensor):
        """Move a block ``[n_chips(src), n_chips(dst), ...]``; its link
        words ``[n_chips, 1]`` are each source chip's off-chip words (its
        valid words minus those addressed to itself), its backlog zeros."""
        valid = (x >= 0).flatten(2)
        mine = torch.arange(self.n_chips, device=x.device)
        off_chip = (valid.sum((1, 2), dtype=I32)
                    - valid[mine, mine].sum(-1, dtype=I32))[:, None]
        return x.transpose(0, 1), off_chip, torch.zeros_like(off_chip)

    def exchange_words_finish(self, y: torch.Tensor) -> torch.Tensor:
        """No path latency to apply."""
        return y


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
