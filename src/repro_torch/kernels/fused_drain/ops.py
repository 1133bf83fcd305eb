"""Wrapper of the fused drain kernel (``csrc/fused_drain.cu``).

On CUDA tensors it launches the kernel, one CTA per chip: warp groups
sort the block's rows at once, each by one stable counting pass over the
257 values of the deadline key, and in rate mode one warp then merges the
queue into each row's head, substep by substep.  On CPU tensors it runs
:func:`repro_torch.kernels.fused_drain.ref.fused_drain_ref`.
"""

from __future__ import annotations

import torch

from repro_torch.core import delays as dl
from repro_torch.kernels import common as kc
from repro_torch.kernels.fused_drain.ref import MODES, FusedDrainOut, fused_drain_ref

NAME = "fused_drain"
I32 = torch.int32
_ARGTYPES = [kc.P] * 5 + [kc.I] * 11 + [kc.LL] + [kc.P] * 6
# Passthrough deposits one lane per thread.  A merging CTA has up to 32
# warps, in up to 8 groups (one named barrier each) that sort rows at
# once, a group one warp per 32 lanes of a row at most.
THREADS = 1024
MAX_WARPS = 32
MAX_GROUPS = 8
# Bins of the counting pass: 256 wrap keys and the sentinel.
BINS = 257


def fused_drain(ring: dl.DelayRing, delivered: torch.Tensor,
                queue: torch.Tensor | None, t0: torch.Tensor, *,
                mode: str = "passthrough", rate: int = 0,
                extra_ahead: int = 0,
                gate: torch.Tensor | None = None) -> FusedDrainOut:
    """Drain one block: ``delivered [n_chips, B, L]``, ``queue [n_chips,
    depth]`` (rate mode), ``t0 [n_chips]``, ``gate [n_chips]`` bool."""
    if mode not in MODES:
        raise ValueError(f"unknown drain mode {mode!r}")
    if mode == "rate" and (queue is None or rate < 1):
        raise ValueError("rate mode needs a merge queue and rate >= 1")
    kw = dict(mode=mode, rate=rate, extra_ahead=extra_ahead, gate=gate)
    if not delivered.is_cuda:
        return fused_drain_ref(ring, delivered, queue, t0, **kw)
    return _launch(ring, delivered, queue, t0, **kw)


def sort_length(mode: str, lanes: int, depth: int) -> int:
    """Lanes of the merged row that the counting pass sorts (0 in
    passthrough): the queue, then the lanes, in rate mode; the lanes in
    sort mode.  No padding: positions past it are sentinels."""
    if mode == "passthrough":
        return 0
    return depth + lanes if mode == "rate" else lanes


def launch_plan(mode, lanes, depth, rate, b, ring_depth, n_inputs
                ) -> tuple[int, int, int]:
    """Threads per CTA, warp groups and dynamic shared-memory bytes (the
    kernel's ``layout``): the ring and two tallies per substep and, when
    merging, per group a staged row, a histogram (``BINS`` x (warps + 1)
    ints) and the scan's 32 ints; in rate mode also per substep the row's
    bin ends and its head (the first ``min(lanes, rate + depth)`` sorted
    words), the two queues and the queue's keys (padded to whole int4s).
    Takes the most groups, up to ``MAX_GROUPS`` and ``b``, that fit a
    Hopper block; raises ``ValueError`` where one does not."""
    ints = ring_depth * n_inputs + 2 * b
    if mode == "passthrough":
        return THREADS, 1, 4 * ints
    if mode == "rate":
        ints += (b * (BINS + min(lanes, rate + depth)) + 2 * depth
                 + -(-depth // 4) * 4)
    for groups in range(max(1, min(b, MAX_GROUPS)), 0, -1):
        warps = min(MAX_WARPS // groups, max(1, -(-lanes // 32)))
        smem = 4 * (ints + groups * (lanes + BINS * (warps + 1) + 32))
        if smem <= kc.MAX_SMEM:
            return 32 * groups * warps, groups, smem
    raise ValueError(f"fused_drain needs {smem} B of shared memory for "
                     f"{lanes} lanes, more than a Hopper block has "
                     f"({kc.MAX_SMEM})")


def _launch(ring, delivered, queue, t0, *, mode, rate, extra_ahead, gate
            ) -> FusedDrainOut:
    n, b, lanes = delivered.shape
    d, n_in = ring.ring.shape[-2:]
    dev = delivered.device
    rate_mode = mode == "rate"
    q = queue.shape[-1] if rate_mode else 0
    threads, groups, smem = launch_plan(mode, lanes, q, rate, b, d,
                                        n_in)
    delivered = delivered.to(I32).contiguous()
    ring_in = ring.ring.to(I32).contiguous()
    t0 = torch.as_tensor(t0, dtype=I32, device=dev).contiguous()
    queue_in = queue.to(I32).contiguous() if rate_mode else None
    gate_in = gate.bool().contiguous() if gate is not None else None
    r = rate if rate_mode else lanes
    ring_out = torch.empty_like(ring_in)
    words = torch.empty((b, n, r), dtype=I32, device=dev)
    queue_out = torch.empty_like(queue_in) if rate_mode else None
    dep_expired = torch.empty((b, n), dtype=I32, device=dev)
    dropped = torch.empty((b, n), dtype=I32, device=dev)
    fn = kc.kernel_fn(NAME, "fused_drain_launch", _ARGTYPES)
    kc.launch(
        NAME, fn,
        kc.check(delivered, "delivered", I32, (n, b, lanes)),
        kc.check(queue_in, "queue", I32, (n, q)) if rate_mode else None,
        kc.check(ring_in, "ring", I32, (n, d, n_in)),
        kc.check(t0, "t0", I32, (n,)),
        (kc.check(gate_in, "gate", torch.bool, (n,))
         if gate_in is not None else None),
        n, b, lanes, q, d, n_in, MODES.index(mode), rate, extra_ahead,
        threads, groups, smem,
        ring_out.data_ptr(), words.data_ptr(),
        queue_out.data_ptr() if rate_mode else None,
        dep_expired.data_ptr(), dropped.data_ptr())
    return FusedDrainOut(
        ring=dl.DelayRing(ring=ring_out.to(ring.ring.dtype), now=ring.now),
        words=words, dep_expired=dep_expired, dropped=dropped,
        queue=queue_out if rate_mode else queue)
