"""Wrappers of the merge-sort kernels (``csrc/merge_sort.cu``).

On CUDA tensors they launch one CTA per row (leading axes flattened),
each row padded to the next power of two >= 128 as the reference pads;
on CPU tensors they run the plain versions in ``ref.py``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import common as kc
from repro_torch.kernels.merge_sort.ref import merge_sort_ref, merge_sort_words_ref

I32 = torch.int32
MIN_LANES = 128
_WORDS_ARGTYPES = [kc.P] * 2 + [kc.I] * 4 + [kc.LL] + [kc.P] * 2
_SOA_ARGTYPES = [kc.P] * 3 + [kc.I] * 4 + [kc.LL] + [kc.P] * 4


def sort_length(lanes: int) -> int:
    """The bitonic network's length for a row of ``lanes``."""
    n = MIN_LANES
    while n < lanes:
        n *= 2
    return n


def launch_plan(lanes: int, key_bytes: int) -> tuple[int, int, int]:
    """Network length, threads per CTA and dynamic shared-memory bytes
    (one composite key of ``key_bytes`` per lane)."""
    n = sort_length(lanes)
    smem = n * key_bytes
    if smem > kc.MAX_SMEM:
        raise ValueError(f"a row of {lanes} lanes needs {smem} B of shared "
                         f"memory, more than a Hopper block has "
                         f"({kc.MAX_SMEM})")
    return n, min(1024, n), smem


def merge_sort_words(words: torch.Tensor, now) -> torch.Tensor:
    """``words [..., L]`` int32 sorted stably by the wrap-aware key
    relative to ``now`` (a scalar or one value per row)."""
    if not words.is_cuda:
        return merge_sort_words_ref(words, now)
    lead, lanes = words.shape[:-1], words.shape[-1]
    rows = words.reshape(-1, lanes).to(I32).contiguous()
    now = torch.as_tensor(now, dtype=I32, device=words.device)
    now = now.broadcast_to(lead).reshape(-1).contiguous()
    out = torch.empty_like(rows)
    if rows.numel() == 0:
        return out.reshape(words.shape)
    n, threads, smem = launch_plan(lanes, 4)
    fn = kc.kernel_fn("merge_sort_words", "merge_sort_words_launch",
                      _WORDS_ARGTYPES)
    r = rows.shape[0]
    kc.launch("merge_sort_words", fn,
              kc.check(rows, "words", I32, (r, lanes)),
              kc.check(now, "now", I32, (r,)),
              r, lanes, n, threads, smem, out.data_ptr())
    return out.reshape(words.shape)


def merge_sort(addr: torch.Tensor, deadline: torch.Tensor,
               valid: torch.Tensor):
    """``(addr, deadline, valid) [..., L]`` sorted stably by ``valid ?
    deadline : 2^30``; returns int32, int32, bool."""
    if not addr.is_cuda:
        return merge_sort_ref(addr.to(I32), deadline.to(I32), valid.bool())
    shape, lanes = addr.shape, addr.shape[-1]
    a, d, v = (x.reshape(-1, lanes).to(dt).contiguous() for x, dt in (
        (addr, I32), (deadline, I32), (valid, torch.bool)))
    outs = [torch.empty_like(x) for x in (a, d, v)]
    if a.numel():
        n, threads, smem = launch_plan(lanes, 8)
        fn = kc.kernel_fn("merge_sort", "merge_sort_launch", _SOA_ARGTYPES)
        r = a.shape[0]
        kc.launch("merge_sort", fn,
                  kc.check(a, "addr", I32, (r, lanes)),
                  kc.check(d, "deadline", I32, (r, lanes)),
                  kc.check(v, "valid", torch.bool, (r, lanes)),
                  r, lanes, n, threads, smem, *(x.data_ptr() for x in outs))
    return tuple(x.reshape(shape) for x in outs)
