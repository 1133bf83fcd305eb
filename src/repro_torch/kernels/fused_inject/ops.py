"""Wrappers of the fused inject kernels (``csrc/fused_inject.cu``).

On CUDA tensors ``fused_inject`` launches its kernel, one CTA per (chip,
substep), and ``fused_lif_inject`` its kernel, one CTA per chip; on CPU
tensors they run the plain versions in ``ref.py``.  The fused path needs
fan-out 1; the fabric packs fan-out > 1 through ``bucket_pack``.

``fused_lif_inject`` is an entry point of its own: the network does not
call it (nor does the reference's), since under STDP the weights, and so
a block's currents, change every substep.  The port has no health masks
yet, so it takes no ``reach`` and culls nothing as lost.
"""

from __future__ import annotations

import torch

from repro_torch.core import events as ev
from repro_torch.core import routing as rt
from repro_torch.kernels import common as kc
from repro_torch.kernels.fused_inject.ref import (FusedInjectOut,
                                                 FusedLifInjectOut,
                                                 fused_inject_ref,
                                                 fused_lif_inject_ref)

NAME = "fused_inject"
I32, F32 = torch.int32, torch.float32
_ARGTYPES = [kc.P] * 8 + [kc.I] * 9 + [kc.LL] + [kc.P] * 7
_LIF_ARGTYPES = [kc.P] * 13 + [kc.I] * 9 + [kc.LL] * 2 + [kc.P] * 11


def fused_inject(events: ev.EventBuffer, table: rt.RoutingTable,
                 t0: torch.Tensor, *, n_chips: int, buckets_per_chip: int,
                 capacity: int, mode: str = "simplified",
                 time_window: int = 1) -> FusedInjectOut:
    """Inject one block: ``events [B, n_chips, E]``, ``table [n_chips, N,
    1]``, ``t0 [n_chips]``."""
    _check_mode_and_fanout(mode, table)
    kw = dict(n_chips=n_chips, buckets_per_chip=buckets_per_chip,
              capacity=capacity, mode=mode, time_window=time_window)
    if not events.addr.is_cuda:
        return fused_inject_ref(events, table, t0, **kw)
    return _launch(events, table, t0, **kw)


def _check_mode_and_fanout(mode: str, table: rt.RoutingTable) -> None:
    if mode not in ("simplified", "full"):
        raise ValueError(f"unknown mode {mode!r}")
    if table.fanout != 1:
        raise ValueError(f"fused inject requires fanout 1, got {table.fanout}")


def launch_plan(e: int, n_chips: int, nb: int, capacity: int
                ) -> tuple[int, int]:
    """Threads per CTA and dynamic shared-memory bytes."""
    threads = min(1024, max(32, -(-e // 32) * 32))
    smem = nb * capacity * 8 + 4 * ((threads // 32) * nb + nb + n_chips + 3)
    if smem > kc.MAX_SMEM:
        raise ValueError(f"fused_inject needs {smem} B of shared memory, "
                         f"more than a Hopper block has ({kc.MAX_SMEM})")
    return threads, smem


def lif_launch_plan(n: int, n_chips: int, nb: int, capacity: int
                    ) -> tuple[int, int, int]:
    """Threads per CTA, the inject scratch's bytes and all dynamic
    shared-memory bytes of ``fused_lif_inject``: the inject scratch of
    :func:`launch_plan` for ``n`` event lanes, then the compaction scan's
    per-warp counts and running total and one fired flag per neuron.  At
    the feedforward cell (46 chips x 512 neurons, 2 buckets per chip,
    C 32) that is 512 threads and 30004 + 68 + 512 = 30584 B."""
    threads, inject = launch_plan(n, n_chips, nb, capacity)
    smem = inject + 4 * (threads // 32 + 1) + n
    if smem > kc.MAX_SMEM:
        raise ValueError(f"fused_lif_inject needs {smem} B of shared memory, "
                         f"more than a Hopper block has ({kc.MAX_SMEM})")
    return threads, inject, smem


def fused_lif_inject(v: torch.Tensor, refrac: torch.Tensor,
                     currents: torch.Tensor, params, table: rt.RoutingTable,
                     t0: torch.Tensor, *, event_capacity: int, n_chips: int,
                     buckets_per_chip: int, capacity: int,
                     mode: str = "simplified",
                     time_window: int = 1) -> FusedLifInjectOut:
    """B substeps of LIF, spike compaction and inject: ``v, refrac
    [n_chips, N]``, ``currents [B, n_chips, N]``, ``params`` LIF
    parameters broadcasting to ``[n_chips, N]``, ``table [n_chips, N,
    1]``, ``t0 [n_chips]``."""
    _check_mode_and_fanout(mode, table)
    kw = dict(event_capacity=event_capacity, n_chips=n_chips,
              buckets_per_chip=buckets_per_chip, capacity=capacity,
              mode=mode, time_window=time_window)
    if not currents.is_cuda:
        return fused_lif_inject_ref(v, refrac, currents, params, table, t0,
                                    **kw)
    return _launch_lif(v, refrac, currents, params, table, t0, **kw)


_LUT_DTYPES = (I32, I32, I32, torch.bool)


def _lut_args(table: rt.RoutingTable, n: int, n_lut: int):
    """The table's four arrays as kernel arguments; returns the tensors
    (kept alive by the caller until the launch) and their pointers."""
    lut = [x.to(dt).contiguous() for x, dt in zip(table, _LUT_DTYPES)]
    ptrs = [kc.check(x, f"table.{f}", dt, (n, n_lut, 1))
            for f, x, dt in zip(table._fields, lut, _LUT_DTYPES)]
    return lut, ptrs


def _inject_out(b: int, n: int, nb: int, capacity: int, dev
                ) -> FusedInjectOut:
    return FusedInjectOut(
        slab=torch.empty((n, nb, b, capacity), dtype=I32, device=dev),
        counts=torch.empty((b, n, nb), dtype=I32, device=dev),
        sent=torch.empty((b, n), dtype=I32, device=dev),
        overflow=torch.empty((b, n), dtype=I32, device=dev),
        wrap_expired=torch.empty((b, n), dtype=I32, device=dev),
        traffic=torch.empty((b, n, n), dtype=I32, device=dev))


def _launch_lif(v, refrac, currents, params, table, t0, *, event_capacity,
                n_chips, buckets_per_chip, capacity, mode, time_window
                ) -> FusedLifInjectOut:
    b, n, n_neurons = currents.shape
    if n != n_chips:
        raise ValueError(f"currents carry {n} chips, expected {n_chips}")
    if table.n_neurons != n_neurons:
        raise ValueError(f"the table has {table.n_neurons} entries per chip, "
                         f"the chips {n_neurons} neurons")
    nb = n_chips * buckets_per_chip
    dev = currents.device
    shape = (n, n_neurons)
    names = ("v", "refrac", "currents") + params._fields
    dtypes = (F32, I32, F32, F32, F32, F32, F32, I32)
    shapes = (shape, shape, (b, n, n_neurons)) + (shape,) * 5
    ins = [torch.as_tensor(x, device=dev).broadcast_to(sh).to(dt).contiguous()
           for x, dt, sh in zip((v, refrac, currents, *params), dtypes,
                                shapes)]
    lut, lut_ptrs = _lut_args(table, n, n_neurons)
    t0 = torch.as_tensor(t0, dtype=I32, device=dev).contiguous()
    v_out = torch.empty(shape, dtype=F32, device=dev)
    refrac_out = torch.empty(shape, dtype=I32, device=dev)
    spikes = torch.empty((b, n, n_neurons), dtype=F32, device=dev)
    voltage = torch.empty((b, n, n_neurons), dtype=F32, device=dev)
    out = _inject_out(b, n, nb, capacity, dev)
    threads, inject_smem, smem = lif_launch_plan(n_neurons, n, nb, capacity)
    fn = kc.kernel_fn("fused_lif_inject", "fused_lif_inject_launch",
                      _LIF_ARGTYPES)
    kc.launch(
        "fused_lif_inject", fn,
        *(kc.check(x, name, dt, sh)
          for x, name, dt, sh in zip(ins, names, dtypes, shapes)),
        *lut_ptrs, kc.check(t0, "t0", I32, (n,)),
        b, n, n_neurons, buckets_per_chip, capacity, int(mode == "full"),
        time_window, event_capacity, threads, inject_smem, smem,
        v_out.data_ptr(), refrac_out.data_ptr(), spikes.data_ptr(),
        voltage.data_ptr(), *(x.data_ptr() for x in out))
    return FusedLifInjectOut(v=v_out, refrac=refrac_out, spikes=spikes,
                             voltage=voltage, inject=out)


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
    lut, lut_ptrs = _lut_args(table, n, n_lut)
    out = _inject_out(b, n, nb, capacity, addr.device)
    threads, smem = launch_plan(e, n, nb, capacity)
    fn = kc.kernel_fn(NAME, "fused_inject_launch", _ARGTYPES)
    kc.launch(
        NAME, fn,
        kc.check(addr, "addr", I32, (b, n, e)),
        kc.check(time, "time", I32, (b, n, e)),
        kc.check(valid, "valid", torch.bool, (b, n, e)),
        *lut_ptrs, kc.check(t0, "t0", I32, (n,)),
        b, n, e, n_lut, buckets_per_chip, capacity, int(mode == "full"),
        time_window, threads, smem, *(x.data_ptr() for x in out))
    return out
