"""Wrapper of the fused drain kernel (``csrc/fused_drain.cu``).

On CUDA tensors it launches the kernel, one CTA per chip looping over the
block's substeps; on CPU tensors it runs :func:`repro_torch.kernels.
fused_drain.ref.fused_drain_ref`.
"""

from __future__ import annotations

import torch

from repro_torch.core import delays as dl
from repro_torch.kernels import common as kc
from repro_torch.kernels.fused_drain.ref import MODES, FusedDrainOut, fused_drain_ref

NAME = "fused_drain"
I32 = torch.int32
_ARGTYPES = [kc.P] * 5 + [kc.I] * 11 + [kc.LL] + [kc.P] * 6
# One CTA per chip; the bitonic stages keep every thread busy.
THREADS = 1024


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


def sort_length(mode: str, lanes: int, depth: int, rate: int) -> int:
    """Power-of-two length of the in-kernel sort (0 in passthrough):
    queue + lanes + rate sentinels in rate mode, the lanes in sort mode,
    at least 128 as in the reference."""
    if mode == "passthrough":
        return 0
    need = depth + lanes + rate if mode == "rate" else lanes
    n = 128
    while n < need:
        n *= 2
    return n


def launch_plan(mode, lanes, depth, rate, ring_depth, n_inputs
                ) -> tuple[int, int]:
    """Sort length and dynamic shared-memory bytes."""
    sort_n = sort_length(mode, lanes, depth, rate)
    q = depth if mode == "rate" else 0
    smem = 4 * (ring_depth * n_inputs + 2 * sort_n + q + 2)
    if smem > kc.MAX_SMEM:
        raise ValueError(f"fused_drain needs {smem} B of shared memory, more "
                         f"than a Hopper block has ({kc.MAX_SMEM})")
    return sort_n, smem


def _launch(ring, delivered, queue, t0, *, mode, rate, extra_ahead, gate
            ) -> FusedDrainOut:
    n, b, lanes = delivered.shape
    d, n_in = ring.ring.shape[-2:]
    dev = delivered.device
    rate_mode = mode == "rate"
    q = queue.shape[-1] if rate_mode else 0
    sort_n, smem = launch_plan(mode, lanes, q, rate, d, n_in)
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
        sort_n, THREADS, smem,
        ring_out.data_ptr(), words.data_ptr(),
        queue_out.data_ptr() if rate_mode else None,
        dep_expired.data_ptr(), dropped.data_ptr())
    return FusedDrainOut(
        ring=dl.DelayRing(ring=ring_out.to(ring.ring.dtype), now=ring.now),
        words=words, dep_expired=dep_expired, dropped=dropped,
        queue=queue_out if rate_mode else queue)
