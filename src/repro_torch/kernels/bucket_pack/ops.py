"""Wrappers of the bucket_pack kernel (``csrc/bucket_pack.cu``).

On CUDA tensors one launch packs every row, one CTA per row: the kernel
reads the event's lanes (bucket id, addr, deadline, valid) and builds each
wire word in registers.  :func:`flush_pack` packs a whole block into a new
flush slab; :func:`flush_pack_column` packs one substep into column k of
an existing slab in place (the credit-gated inject, substep by
substep).  Contiguous int32 lanes and a bool ``valid`` go to
the launch as they are.  On CPU tensors the lanes are encoded into words
and :func:`repro_torch.kernels.bucket_pack.ref.bucket_pack_ref` runs.
"""

from __future__ import annotations

import functools
import math

import torch

from repro_torch.core import buckets as bk
from repro_torch.core import events as ev
from repro_torch.kernels import common as kc
from repro_torch.kernels.bucket_pack.ref import bucket_pack_ref

NAME = "bucket_pack"
I32 = torch.int32
_ARGTYPES = [kc.P] * 4 + [kc.I] * 6 + [kc.LL] + [kc.P] + [kc.LL] * 3 \
    + [kc.P] * 3


def bucket_pack(bucket_id, addr, deadline, valid, *, n_buckets: int,
                capacity: int) -> bk.PackedBuckets:
    """Pack ``[..., L]`` lanes into ``[..., n_buckets, capacity]`` rows."""
    if not bucket_id.is_cuda:
        rows, counts, overflow = bucket_pack_ref(
            bucket_id.to(I32), ev.encode_word(addr, deadline, valid),
            n_buckets=n_buckets, capacity=capacity)
        return bk.PackedBuckets(words=rows, counts=counts, overflow=overflow)
    lead = bucket_id.shape[:-1]
    r = math.prod(lead)
    out = torch.empty(lead + (n_buckets, capacity), dtype=I32,
                      device=bucket_id.device)
    counts, overflow = _launch(
        bucket_id, addr, deadline, valid, out, n_outer=r, n_inner=1,
        strides=(n_buckets * capacity, 0, capacity), n_buckets=n_buckets,
        capacity=capacity)
    return bk.PackedBuckets(words=out, counts=counts.reshape(
        lead + (n_buckets,)), overflow=overflow.reshape(lead))


def flush_pack(bucket_id, addr, deadline, valid, *, n_buckets: int,
               capacity: int):
    """Pack a whole block ``[B, n_chips, L]`` into the flush slab
    ``[n_chips, n_buckets, B, capacity]``.  Returns ``(slab, counts[B,
    n_chips, n_buckets], overflow[B, n_chips])``."""
    b, n = bucket_id.shape[:2]
    if not bucket_id.is_cuda:
        rows, counts, overflow = bucket_pack_ref(
            bucket_id.to(I32), ev.encode_word(addr, deadline, valid),
            n_buckets=n_buckets, capacity=capacity)
        return rows.permute(1, 2, 0, 3).contiguous(), counts, overflow
    slab = torch.empty((n, n_buckets, b, capacity), dtype=I32,
                       device=bucket_id.device)
    counts, overflow = _launch(
        bucket_id, addr, deadline, valid, slab, n_outer=b, n_inner=n,
        strides=(capacity, n_buckets * b * capacity, b * capacity),
        n_buckets=n_buckets, capacity=capacity)
    return slab, counts.reshape(b, n, n_buckets), overflow.reshape(b, n)


def flush_pack_column(bucket_id, addr, deadline, valid, *,
                      slab: torch.Tensor, substep: int, capacity: int):
    """Pack one substep ``[n_chips, L]`` into column ``substep`` of the
    flush slab ``[n_chips, n_buckets, B, capacity]``, in place: every cell
    of the column is written (sentinels where no word lands), the other
    columns are left as they are.  Returns ``(counts[n_chips, n_buckets],
    overflow[n_chips])``."""
    n, n_buckets, b = slab.shape[:3]
    if not bucket_id.is_cuda:
        rows, counts, overflow = bucket_pack_ref(
            bucket_id.to(I32), ev.encode_word(addr, deadline, valid),
            n_buckets=n_buckets, capacity=capacity)
        slab[:, :, substep] = rows
        return counts, overflow
    return _launch(
        bucket_id, addr, deadline, valid, slab, n_outer=1, n_inner=n,
        strides=(0, n_buckets * b * capacity, b * capacity),
        n_buckets=n_buckets, capacity=capacity, offset=substep * capacity)


@functools.lru_cache(maxsize=64)
def launch_plan(lanes: int, n_buckets: int, capacity: int
                ) -> tuple[int, int]:
    """Threads per CTA (one lane per thread, up to 1024; longer rows loop
    over tiles) and dynamic shared-memory bytes (the row's cells, the
    per-warp bucket histogram and the running counts)."""
    threads = min(1024, max(32, -(-lanes // 32) * 32))
    smem = 4 * n_buckets * (capacity + threads // 32 + 1)
    if smem > kc.MAX_SMEM:
        raise ValueError(f"bucket_pack needs {smem} B of shared memory, more "
                         f"than a Hopper block has ({kc.MAX_SMEM})")
    return threads, smem


def _lanes(x, like, dtype, rows, lanes):
    """``x`` as a contiguous ``[rows, lanes]`` tensor of ``dtype`` on the
    device of ``like`` (``valid`` as bytes): a view of a contiguous input
    of that type, a copy of any other."""
    if x.shape != like.shape or x.device != like.device:
        raise ValueError(f"bucket_pack lanes must all have shape "
                         f"{tuple(like.shape)} on {like.device}, got "
                         f"{tuple(x.shape)} on {x.device}")
    if dtype == torch.uint8:
        x = (x if x.dtype == torch.bool else x != 0).view(torch.uint8)
    elif x.dtype != dtype:
        x = x.to(dtype)
    if not x.is_contiguous():
        x = x.contiguous()
    return x.view(rows, lanes)


def _launch(bucket_id, addr, deadline, valid, out, *, n_outer, n_inner,
            strides, n_buckets, capacity, offset=0):
    """Row r = o * n_inner + i of the ``[rows, L]`` lanes lands at ``out``
    offset ``offset + o * strides[0] + i * strides[1]``, bucket stride
    ``strides[2]``."""
    rows, lanes = n_outer * n_inner, bucket_id.shape[-1]
    end = (offset + (n_outer - 1) * strides[0] + (n_inner - 1) * strides[1]
           + (n_buckets - 1) * strides[2] + capacity)
    if out.dtype != I32 or not out.is_contiguous() or end > out.numel():
        raise ValueError("bucket_pack output must be contiguous int32 and "
                         "hold every row")
    # The lanes stay referenced until the launch: a copy freed earlier
    # could hand its memory to the outputs below.
    lanes_in = [_lanes(x, bucket_id, dt, rows, lanes)
                for x, dt in ((bucket_id, I32), (addr, I32), (deadline, I32),
                              (valid, torch.uint8))]
    counts = torch.empty((rows, n_buckets), dtype=I32, device=out.device)
    overflow = torch.empty((rows,), dtype=I32, device=out.device)
    threads, smem = launch_plan(lanes, n_buckets, capacity)
    kc.launch(NAME, kc.kernel_fn(NAME, "bucket_pack_launch", _ARGTYPES),
              *(x.data_ptr() for x in lanes_in), n_outer, n_inner, lanes,
              n_buckets, capacity, threads, smem,
              out.data_ptr() + offset * out.element_size(),
              *strides, counts.data_ptr(), overflow.data_ptr())
    return counts, overflow
