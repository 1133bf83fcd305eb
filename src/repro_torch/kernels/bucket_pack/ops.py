"""Wrappers of the bucket_pack kernel (``csrc/bucket_pack.cu``).

The SoA lanes are encoded into wire words here; on CUDA tensors one
launch packs every row (one CTA per row), on CPU tensors
:func:`repro_torch.kernels.bucket_pack.ref.bucket_pack_ref` runs.
"""

from __future__ import annotations

import torch

from repro_torch.core import buckets as bk
from repro_torch.core import events as ev
from repro_torch.kernels import common as kc
from repro_torch.kernels.bucket_pack.ref import bucket_pack_ref

NAME = "bucket_pack"
I32 = torch.int32
_ARGTYPES = [kc.P] * 2 + [kc.I] * 6 + [kc.LL] + [kc.P] + [kc.LL] * 3 \
    + [kc.P] * 3


def bucket_pack(bucket_id, addr, deadline, valid, *, n_buckets: int,
                capacity: int) -> bk.PackedBuckets:
    """Pack ``[..., L]`` lanes into ``[..., n_buckets, capacity]`` rows."""
    words = ev.encode_word(addr, deadline, valid)
    bucket_id = bucket_id.to(I32)
    if not words.is_cuda:
        rows, counts, overflow = bucket_pack_ref(
            bucket_id, words, n_buckets=n_buckets, capacity=capacity)
        return bk.PackedBuckets(words=rows, counts=counts, overflow=overflow)
    lead = words.shape[:-1]
    r = max(1, words[..., 0].numel())
    out = torch.empty(lead + (n_buckets, capacity), dtype=I32,
                      device=words.device)
    counts, overflow = _launch(
        bucket_id.reshape(r, -1), words.reshape(r, -1), out,
        n_outer=r, n_inner=1, strides=(n_buckets * capacity, 0, capacity),
        n_buckets=n_buckets, capacity=capacity)
    return bk.PackedBuckets(words=out, counts=counts.reshape(
        lead + (n_buckets,)), overflow=overflow.reshape(lead))


def flush_pack(bucket_id, addr, deadline, valid, *, n_buckets: int,
               capacity: int):
    """Pack a whole block ``[B, n_chips, L]`` into the flush slab
    ``[n_chips, n_buckets, B, capacity]``.  Returns ``(slab, counts[B,
    n_chips, n_buckets], overflow[B, n_chips])``."""
    b, n = bucket_id.shape[:2]
    words = ev.encode_word(addr, deadline, valid)
    bucket_id = bucket_id.to(I32)
    if not words.is_cuda:
        rows, counts, overflow = bucket_pack_ref(
            bucket_id, words, n_buckets=n_buckets, capacity=capacity)
        return rows.permute(1, 2, 0, 3).contiguous(), counts, overflow
    slab = torch.empty((n, n_buckets, b, capacity), dtype=I32,
                       device=words.device)
    counts, overflow = _launch(
        bucket_id.reshape(b * n, -1), words.reshape(b * n, -1), slab,
        n_outer=b, n_inner=n,
        strides=(capacity, n_buckets * b * capacity, b * capacity),
        n_buckets=n_buckets, capacity=capacity)
    return slab, counts.reshape(b, n, n_buckets), overflow.reshape(b, n)


def launch_plan(lanes: int, n_buckets: int, capacity: int
                ) -> tuple[int, int]:
    """Threads per CTA and dynamic shared-memory bytes."""
    threads = min(1024, max(32, -(-lanes // 32) * 32))
    smem = 4 * (n_buckets * capacity + (threads // 32) * n_buckets
                + n_buckets + 1)
    if smem > kc.MAX_SMEM:
        raise ValueError(f"bucket_pack needs {smem} B of shared memory, more "
                         f"than a Hopper block has ({kc.MAX_SMEM})")
    return threads, smem


def _launch(bucket_id, words, out, *, n_outer, n_inner, strides, n_buckets,
            capacity):
    """Row r = o * n_inner + i of ``[rows, L]`` lands at ``out`` offset
    ``o * strides[0] + i * strides[1]``, bucket stride ``strides[2]``."""
    rows, lanes = words.shape
    bucket_id = bucket_id.contiguous()
    words = words.contiguous()
    counts = torch.empty((rows, n_buckets), dtype=I32, device=words.device)
    overflow = torch.empty((rows,), dtype=I32, device=words.device)
    threads, smem = launch_plan(lanes, n_buckets, capacity)
    if not out.is_contiguous() or out.numel() != rows * n_buckets * capacity:
        raise ValueError("bucket_pack output must be contiguous and hold "
                         "every row")
    fn = kc.kernel_fn(NAME, "bucket_pack_launch", _ARGTYPES)
    kc.launch(NAME, fn,
              kc.check(bucket_id, "bucket_id", I32, (rows, lanes)),
              kc.check(words, "words", I32, (rows, lanes)),
              n_outer, n_inner, lanes, n_buckets, capacity, threads, smem,
              out.data_ptr(), *strides, counts.data_ptr(),
              overflow.data_ptr())
    return counts, overflow
