"""Wrapper of the fused inject kernel (``csrc/fused_inject.cu``).

On CUDA tensors it launches the kernel, one CTA per (chip, substep); on
CPU tensors it runs :func:`repro_torch.kernels.fused_inject.ref.
fused_inject_ref`.  The fused path needs fan-out 1; the fabric packs
fan-out > 1 through ``bucket_pack``.
"""

from __future__ import annotations

import torch

from repro_torch.core import events as ev
from repro_torch.core import routing as rt
from repro_torch.kernels import common as kc
from repro_torch.kernels.fused_inject.ref import FusedInjectOut, fused_inject_ref

NAME = "fused_inject"
I32 = torch.int32
_ARGTYPES = [kc.P] * 8 + [kc.I] * 9 + [kc.LL] + [kc.P] * 7


def fused_inject(events: ev.EventBuffer, table: rt.RoutingTable,
                 t0: torch.Tensor, *, n_chips: int, buckets_per_chip: int,
                 capacity: int, mode: str = "simplified",
                 time_window: int = 1) -> FusedInjectOut:
    """Inject one block: ``events [B, n_chips, E]``, ``table [n_chips, N,
    1]``, ``t0 [n_chips]``."""
    if mode not in ("simplified", "full"):
        raise ValueError(f"unknown mode {mode!r}")
    if table.fanout != 1:
        raise ValueError(f"fused inject requires fanout 1, got {table.fanout}")
    kw = dict(n_chips=n_chips, buckets_per_chip=buckets_per_chip,
              capacity=capacity, mode=mode, time_window=time_window)
    if not events.addr.is_cuda:
        return fused_inject_ref(events, table, t0, **kw)
    return _launch(events, table, t0, **kw)


def launch_plan(e: int, n_chips: int, nb: int, capacity: int
                ) -> tuple[int, int]:
    """Threads per CTA and dynamic shared-memory bytes."""
    threads = min(1024, max(32, -(-e // 32) * 32))
    smem = nb * capacity * 8 + 4 * ((threads // 32) * nb + nb + n_chips + 3)
    if smem > kc.MAX_SMEM:
        raise ValueError(f"fused_inject needs {smem} B of shared memory, "
                         f"more than a Hopper block has ({kc.MAX_SMEM})")
    return threads, smem


def _launch(events, table, t0, *, n_chips, buckets_per_chip, capacity, mode,
            time_window) -> FusedInjectOut:
    b, n, e = events.addr.shape
    if n != n_chips:
        raise ValueError(f"events carry {n} chips, expected {n_chips}")
    nb = n_chips * buckets_per_chip
    n_lut = table.n_neurons
    addr = events.addr.to(I32).contiguous()
    time = events.time.to(I32).contiguous()
    valid = events.valid.bool().contiguous()
    t0 = torch.as_tensor(t0, dtype=I32, device=addr.device).contiguous()
    lut = [(f"table.{f}", x.to(dt).contiguous(), dt) for f, x, dt in zip(
        table._fields, table, (I32, I32, I32, torch.bool))]
    dev = addr.device
    slab = torch.empty((n, nb, b, capacity), dtype=I32, device=dev)
    counts = torch.empty((b, n, nb), dtype=I32, device=dev)
    sent, overflow, wrap_expired = (
        torch.empty((b, n), dtype=I32, device=dev) for _ in range(3))
    traffic = torch.empty((b, n, n), dtype=I32, device=dev)
    threads, smem = launch_plan(e, n, nb, capacity)
    fn = kc.kernel_fn(NAME, "fused_inject_launch", _ARGTYPES)
    kc.launch(
        NAME, fn,
        kc.check(addr, "addr", I32, (b, n, e)),
        kc.check(time, "time", I32, (b, n, e)),
        kc.check(valid, "valid", torch.bool, (b, n, e)),
        *(kc.check(x, name, dt, (n, n_lut, 1)) for name, x, dt in lut),
        kc.check(t0, "t0", I32, (n,)),
        b, n, e, n_lut, buckets_per_chip, capacity, int(mode == "full"),
        time_window, threads, smem,
        slab.data_ptr(), counts.data_ptr(), sent.data_ptr(),
        overflow.data_ptr(), wrap_expired.data_ptr(), traffic.data_ptr())
    return FusedInjectOut(slab=slab, counts=counts, sent=sent,
                          overflow=overflow, wrap_expired=wrap_expired,
                          traffic=traffic)
