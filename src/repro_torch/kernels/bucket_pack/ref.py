"""Plain PyTorch version of the bucket_pack kernel, with the TPU kernel's
semantics (``repro.kernels.bucket_pack.kernel``): a lane belongs to bucket
``b`` iff ``bucket_id == b`` for ``0 <= b < n_buckets`` and its word is
valid; members fill their bucket row in lane order, counts are the member
counts and the overflow is ``sum_b max(counts[b] - capacity, 0)``.

For bucket ids inside ``[0, n_buckets)`` this equals the reference
``repro_torch.core.buckets.pack``; outside it the lane is dropped, where
the reference ranks it against the clipped bucket.
"""

from __future__ import annotations

import torch

from repro_torch.core import buckets as bk

I32 = torch.int32


def bucket_pack_ref(bucket_id: torch.Tensor, words: torch.Tensor, *,
                    n_buckets: int, capacity: int):
    """``bucket_id``, ``words`` ``[..., L]`` -> ``(rows[..., n_buckets,
    capacity], counts[..., n_buckets], overflow[...])``."""
    member = (words >= 0) & (bucket_id >= 0) & (bucket_id < n_buckets)
    slot, counts = bk.compute_slots(bucket_id, member, n_buckets)
    keep = member & (slot < capacity)
    cells, _ = bk.scatter_cells(bucket_id, slot, keep, words, n_buckets,
                                capacity)
    rows = cells.reshape(cells.shape[:-1] + (n_buckets, capacity))
    overflow = torch.clamp(counts - capacity, min=0).sum(-1, dtype=I32)
    return rows, counts, overflow
