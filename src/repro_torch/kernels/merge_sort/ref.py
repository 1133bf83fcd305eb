"""Plain PyTorch versions of the merge-stage sorts (``repro.kernels.
merge_sort.ref``): stable ``torch.sort`` of the key, then a gather, row by
row over the leading axes."""

from __future__ import annotations

import torch

from repro_torch.core import merge as mg

INF = 2**30


def merge_sort_words_ref(words: torch.Tensor, now) -> torch.Tensor:
    """``words [..., L]`` sorted stably by the wrap-aware key relative to
    ``now`` (a scalar or one value per row): the merge buffer's own
    plain sort."""
    return mg.merge_words(words, now)


def merge_sort_ref(addr: torch.Tensor, deadline: torch.Tensor,
                   valid: torch.Tensor):
    """``(addr, deadline, valid) [..., L]`` sorted stably by ``valid ?
    deadline : 2^30``."""
    key = torch.where(valid.bool(), deadline, INF)
    order = torch.sort(key, dim=-1, stable=True).indices
    return (addr.gather(-1, order), deadline.gather(-1, order),
            valid.gather(-1, order))
