"""Wrappers of the merge-sort kernels (``csrc/merge_sort.cu``).

On CUDA tensors they launch one CTA per row (leading axes flattened),
which sorts the row by stable counting passes in shared memory: one pass
over 257 bins for the words, least-significant-digit passes of 8 bits
over the varying key bits for the structure-of-arrays lanes.  On CPU
tensors they run the plain versions in ``ref.py``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import common as kc
from repro_torch.kernels.merge_sort.ref import merge_sort_ref, merge_sort_words_ref

I32 = torch.int32
# Longest rows the kernels take: the largest powers of two whose plan fits
# a Hopper block's shared memory (the word sort keeps one int per lane, the
# SoA sort two dense keys and two u16 lane orders).
MAX_LANES = {"words": 32768, "soa": 16384}
# Bins of one counting pass: 256 wrap keys and the sentinel; 8-bit digits.
BINS = {"words": 257, "soa": 256}
# Bytes of shared memory per lane, and beside the histogram (the scan's 32
# ints, the row's AND and OR).
LANE_BYTES = {"words": 4, "soa": 12}
SCRATCH_BYTES = 4 * 34
_WORDS_ARGTYPES = [kc.P] * 2 + [kc.I] * 3 + [kc.LL] + [kc.P] * 2
_SOA_ARGTYPES = [kc.P] * 3 + [kc.I] * 3 + [kc.LL] + [kc.P] * 4


def launch_plan(lanes: int, kind: str) -> tuple[int, int]:
    """Threads per CTA (one warp per 32 lanes, at most 32 warps) and
    dynamic shared-memory bytes of a row of ``lanes`` for the ``"words"``
    or ``"soa"`` sort: the block histogram (bins x (warps + 1) ints; the
    extra column keeps a warp's bins in different banks), the scratch and
    the row.  Raises ``ValueError`` past ``MAX_LANES``."""
    if lanes > MAX_LANES[kind]:
        raise ValueError(f"a row of {lanes} lanes is longer than the {kind} "
                         f"sort's shared memory plan takes "
                         f"({MAX_LANES[kind]} lanes)")
    warps = min(32, max(1, -(-lanes // 32)))
    smem = (4 * BINS[kind] * (warps + 1) + SCRATCH_BYTES
            + LANE_BYTES[kind] * lanes)
    return 32 * warps, smem


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
    threads, smem = launch_plan(lanes, "words")
    fn = kc.kernel_fn("merge_sort_words", "merge_sort_words_launch",
                      _WORDS_ARGTYPES)
    r = rows.shape[0]
    kc.launch("merge_sort_words", fn,
              kc.check(rows, "words", I32, (r, lanes)),
              kc.check(now, "now", I32, (r,)),
              r, lanes, threads, smem, out.data_ptr())
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
        threads, smem = launch_plan(lanes, "soa")
        fn = kc.kernel_fn("merge_sort", "merge_sort_launch", _SOA_ARGTYPES)
        r = a.shape[0]
        kc.launch("merge_sort", fn,
                  kc.check(a, "addr", I32, (r, lanes)),
                  kc.check(d, "deadline", I32, (r, lanes)),
                  kc.check(v, "valid", torch.bool, (r, lanes)),
                  r, lanes, threads, smem, *(x.data_ptr() for x in outs))
    return tuple(x.reshape(shape) for x in outs)
