"""Bucket-buffer event aggregation (port of ``repro.core.buckets``).

Event *i* with bucket *b* lands at ``out[b, rank_i]``, where ``rank_i`` is
the number of earlier valid events in bucket *b* (FIFO order); ranks past
``capacity`` overflow.  These are the reference semantics of the unfused
JAX chain, kept exactly, including its edge rules:

* a lane whose bucket id lies outside ``[0, n_buckets)`` counts towards no
  bucket but is ranked against the clipped bucket (``compute_slots``);
* a kept lane with a negative bucket id wraps once onto ``b + n_buckets``
  and is dropped if still out of range; of two words that land on one
  cell the later lane wins, as XLA's CPU scatter resolves it.

Every function takes arbitrary leading axes; the event lanes are last.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import events as ev

I32 = torch.int32


class PackedBuckets(NamedTuple):
    """words : int32[..., n_buckets, capacity]; counts : int32[...,
    n_buckets] (pre-overflow fill); overflow : int32[...]."""

    words: torch.Tensor
    counts: torch.Tensor
    overflow: torch.Tensor


def compute_slots(bucket_id: torch.Tensor, valid: torch.Tensor,
                  n_buckets: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Rank of each lane within its bucket, and the bucket fill counts.

    ``slot[e]`` is the number of earlier lanes ``e' < e`` with
    ``valid[e']`` and ``bucket_id[e'] == clip(bucket_id[e])``;
    ``counts[b]`` the number of valid lanes with ``bucket_id == b``.
    Computed with one sort and one binary search per row (O(E log E))
    instead of the reference's one-hot cumsum; results are identical.
    """
    e = bucket_id.shape[-1]
    dev = bucket_id.device
    bid = bucket_id.long()
    member = valid.bool() & (bid >= 0) & (bid < n_buckets)
    lane = torch.arange(e, device=dev)
    key = torch.where(member, bid, n_buckets)
    srt = torch.sort(key * e + lane, dim=-1).values
    cb = bid.clamp(0, n_buckets - 1)
    pos = torch.searchsorted(srt, (cb * e + lane).contiguous())
    counts = torch.zeros(bid.shape[:-1] + (n_buckets + 1,), dtype=torch.long,
                         device=dev).scatter_add_(-1, key,
                                                  torch.ones_like(key))
    start = torch.cumsum(counts, -1) - counts
    slot = pos - start.gather(-1, cb)
    return slot.to(I32), counts[..., :n_buckets].to(I32)


def compute_slots_sorted(bucket_id: torch.Tensor, valid: torch.Tensor,
                         n_buckets: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Rank within bucket by one stable sort (the reference's
    ``compute_slots_sorted``, the form MoE token dispatch uses: lanes are
    tokens x top-k, buckets are experts).

    The key is ``where(valid, bucket_id, n_buckets)``; a lane's slot is its
    position in the stable order minus the exclusive prefix of the key
    counts at its key.  The counts follow ``jnp``'s scatter rule (a
    negative key wraps once onto ``key + n_buckets + 1``, then an
    out-of-range key is dropped), the prefix lookup its gather rule (wrap
    once, then clamp), so every lane's slot, invalid and out-of-range lanes
    included, equals the reference's bitwise.  Returns ``(slot int32[...,
    E], counts int32[..., n_buckets])``.
    """
    e = bucket_id.shape[-1]
    dev = bucket_id.device
    nk = n_buckets + 1
    key = torch.where(valid.bool(), bucket_id.long(), n_buckets)
    order = torch.argsort(key, dim=-1, stable=True)
    wrapped = torch.where(key < 0, key + nk, key)
    hit = (wrapped >= 0) & (wrapped < nk)
    counts = torch.zeros(key.shape[:-1] + (nk + 1,), dtype=torch.long,
                         device=dev).scatter_add_(
        -1, torch.where(hit, wrapped, nk), torch.ones_like(key))[..., :nk]
    start = torch.cumsum(counts, -1) - counts
    sorted_key = wrapped.gather(-1, order).clamp(0, nk - 1)
    rank = torch.arange(e, device=dev) - start.gather(-1, sorted_key)
    slot = torch.empty_like(rank).scatter_(-1, order, rank)
    return slot.to(I32), counts[..., :n_buckets].to(I32)


def scatter_cells(bucket_id, slot, keep, words, n_buckets: int,
                  capacity: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Reference scatter of kept words into ``[..., n_buckets*capacity]``
    cells (negative buckets wrap once, later lanes win).  Returns the
    cell words and a hit mask."""
    e = bucket_id.shape[-1]
    b = bucket_id.long()
    b = torch.where(b < 0, b + n_buckets, b)
    ok = keep & (b >= 0) & (b < n_buckets)
    n_cells = n_buckets * capacity
    code = torch.where(ok, b * capacity + slot.long(), n_cells)
    lane = torch.arange(e, device=b.device).expand(b.shape)
    owner = torch.full(b.shape[:-1] + (n_cells + 1,), -1, dtype=torch.long,
                       device=b.device)
    owner = owner.scatter_reduce(-1, code, lane, reduce="amax")[..., :n_cells]
    hit = owner >= 0
    cell = words.gather(-1, owner.clamp(min=0))
    return torch.where(hit, cell, ev.WORD_SENTINEL), hit


def pack(bucket_id, addr, deadline, valid, *, n_buckets: int,
         capacity: int) -> PackedBuckets:
    """Stable FIFO bucket packing into a word slab (reference semantics)."""
    slot, counts = compute_slots(bucket_id, valid, n_buckets)
    keep = valid & (slot < capacity)
    words_in = ev.encode_word(addr, deadline, keep)
    cells, _ = scatter_cells(bucket_id, slot, keep, words_in, n_buckets,
                             capacity)
    overflow = (valid & (slot >= capacity)).sum(-1, dtype=I32)
    return PackedBuckets(
        words=cells.reshape(cells.shape[:-1] + (n_buckets, capacity)),
        counts=counts, overflow=overflow)


def flush_pack(bucket_id, addr, deadline, valid, *, slab: torch.Tensor,
               capacity: int, substep: int):
    """Pack one substep straight into column ``substep`` of a flush slab
    ``[..., n_buckets, B, capacity]``; cells no word lands on keep the
    slab's contents.  Returns ``(slab, counts, overflow)``."""
    n_buckets = slab.shape[-3]
    slot, counts = compute_slots(bucket_id, valid, n_buckets)
    keep = valid & (slot < capacity)
    words_in = ev.encode_word(addr, deadline, keep)
    cells, hit = scatter_cells(bucket_id, slot, keep, words_in, n_buckets,
                               capacity)
    shape = cells.shape[:-1] + (n_buckets, capacity)
    slab = slab.clone()
    col = slab[..., substep, :]
    slab[..., substep, :] = torch.where(hit.reshape(shape),
                                        cells.reshape(shape), col)
    overflow = (valid & (slot >= capacity)).sum(-1, dtype=I32)
    return slab, counts, overflow


def unpack(packed: PackedBuckets):
    """The packed buckets flattened back to decoded SoA event lanes
    ``[n_buckets * capacity]`` (every leading axis flattened too, as the
    reference's ``reshape(-1)``): ``(addr, deadline8, valid)``."""
    return ev.decode_word(packed.words.reshape(-1))


def static_bucket_ids(dest_chip, *, n_chips: int, streams: int = 1,
                      stream: int = 0) -> torch.Tensor:
    """Simplified scheme: one bucket per (destination chip, stream)."""
    del n_chips
    return dest_chip * streams + stream


def dynamic_bucket_ids(dest_chip, deadline, *, n_chips: int,
                       pool_per_chip: int, window: int) -> torch.Tensor:
    """Bucket renaming: pool keyed by the deadline's time window (floor
    division and modulo, as ``jnp``'s ``//`` and ``%``)."""
    del n_chips
    win = torch.remainder(torch.div(deadline, max(window, 1),
                                    rounding_mode="floor"), pool_per_chip)
    return dest_chip * pool_per_chip + win


def bucket_dest_chip(n_chips: int, buckets_per_chip: int, *,
                     device=None) -> torch.Tensor:
    """Static bucket -> destination chip binding table, int32
    ``[n_chips * buckets_per_chip]`` ("network addresses are statically
    configured in the buckets")."""
    return torch.arange(n_chips, dtype=I32, device=device).repeat_interleave(
        buckets_per_chip)
