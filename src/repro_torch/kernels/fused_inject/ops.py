"""Wrappers of the fused inject kernels (``csrc/fused_inject.cu``).

On CUDA tensors ``fused_inject`` and ``fused_lif_inject`` each launch
their kernel, one CTA per (row, substep); on CPU tensors they run the
plain versions in ``ref.py``.  The rows are the source chips the caller
holds (``n_rows``, from the inputs' chip axis: every chip on one device,
a rank's own block in the shard forms); ``n_chips`` counts the
destinations (``n_chips * buckets_per_chip`` buckets, the traffic
width, the reach row's length).  The fused path needs fan-out 1; the fabric
packs fan-out > 1 through ``bucket_pack``.

Arguments that already are contiguous tensors of the kernel's type and
shape on the card (the network's calls) go to the launch as they are;
others are converted first.  The outputs of one call are views of one
``int32`` buffer, the slab first.

``fused_lif_inject`` is an entry point of its own: the network does not
call it (nor does the reference's), since under STDP the weights, and so
a block's currents, change every substep.

Both take ``reach``, bool ``[n_rows(src), n_chips(dst)]`` (each row's
deliverable destinations, the fabric's health mask) or None: a
routed lane whose in-range destination its chip cannot reach is dropped
into ``lost`` before admission.  With None the kernels get a null
pointer and read nothing more.
"""

from __future__ import annotations

import functools
import math

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
_ARGTYPES = [kc.P] * 9 + [kc.I] * 10 + [kc.LL] + [kc.P] * 8
_LIF_ARGTYPES = [kc.P] * 14 + [kc.I] * 10 + [kc.LL] + [kc.P] * 12
_LUT_DTYPES = (I32, I32, I32, torch.bool)
_LIF_NAMES = ("v", "refrac", "currents", "tau_m", "v_th", "v_reset",
              "v_rest", "refrac_period")
_LIF_DTYPES = (F32, I32, F32, F32, F32, F32, F32, I32)


def fused_inject(events: ev.EventBuffer, table: rt.RoutingTable,
                 t0: torch.Tensor, *, reach: torch.Tensor | None = None,
                 n_chips: int, buckets_per_chip: int, capacity: int,
                 mode: str = "simplified",
                 time_window: int = 1) -> FusedInjectOut:
    """Inject one block: ``events [B, n_rows, E]``, ``table [n_rows, N,
    1]``, ``t0 [n_rows]``, ``reach [n_rows, n_chips]`` or None."""
    _check_mode_and_fanout(mode, table)
    kw = dict(reach=reach, n_chips=n_chips,
              buckets_per_chip=buckets_per_chip, capacity=capacity,
              mode=mode, time_window=time_window)
    if not events.addr.is_cuda:
        return fused_inject_ref(events, table, t0, **kw)
    return _launch(events, table, t0, **kw)


def _check_mode_and_fanout(mode: str, table: rt.RoutingTable) -> None:
    if mode not in ("simplified", "full"):
        raise ValueError(f"unknown mode {mode!r}")
    if table.fanout != 1:
        raise ValueError(f"fused inject requires fanout 1, got {table.fanout}")


def _threads(lanes: int) -> int:
    return min(512, max(32, -(-lanes // 32) * 32))


def _scratch_bytes(threads: int, n_chips: int, nb: int, capacity: int) -> int:
    """The inject scratch: a lane index per cell, each warp's counts by
    bucket and by destination chip and its three stats (sent,
    wrap_expired, lost), and each bucket's running count
    (``inject_scratch_ints`` in the source)."""
    return 4 * (nb * capacity + (threads // 32) * (nb + n_chips + 3) + nb)


@functools.lru_cache(maxsize=64)
def launch_plan(e: int, n_chips: int, nb: int, capacity: int,
                reach: bool = False) -> tuple[int, int]:
    """Threads per CTA (one lane per thread, up to 512, so three CTAs fit
    on an SM; longer rows loop over tiles) and dynamic shared-memory
    bytes, plus the row's reach row (``n_chips`` bytes) with a reach
    table; the grid is (n_rows, B).  At the feedforward cell (512
    lanes, 46 chips, 92 buckets, C 32) that is 512 threads and 21168 B
    (21214 with a reach row)."""
    threads = _threads(e)
    smem = _scratch_bytes(threads, n_chips, nb, capacity) + (
        n_chips if reach else 0)
    if smem > kc.MAX_SMEM:
        raise ValueError(f"fused_inject needs {smem} B of shared memory, "
                         f"more than a Hopper block has ({kc.MAX_SMEM})")
    return threads, smem


@functools.lru_cache(maxsize=64)
def lif_launch_plan(n: int, n_chips: int, nb: int, capacity: int,
                    reach: bool = False) -> tuple[int, int]:
    """Threads per CTA and dynamic shared-memory bytes of
    ``fused_lif_inject``, whose grid is (n_chips, B) as
    :func:`launch_plan`'s: the inject scratch for ``n`` event lanes, then
    the compaction's spike counts per warp of two tiles, one fired flag
    per neuron and, with a reach table, the chip's row.  At the
    feedforward cell (46 chips x 512 neurons, 2 buckets per chip, C 32)
    that is 512 threads and 21168 + 128 + 512 = 21808 B."""
    threads = _threads(n)
    smem = (_scratch_bytes(threads, n_chips, nb, capacity)
            + 4 * 2 * (threads // 32) + n + (n_chips if reach else 0))
    if smem > kc.MAX_SMEM:
        raise ValueError(f"fused_lif_inject needs {smem} B of shared memory, "
                         f"more than a Hopper block has ({kc.MAX_SMEM})")
    return threads, smem


def fused_lif_inject(v: torch.Tensor, refrac: torch.Tensor,
                     currents: torch.Tensor, params, table: rt.RoutingTable,
                     t0: torch.Tensor, *, reach: torch.Tensor | None = None,
                     event_capacity: int, n_chips: int,
                     buckets_per_chip: int, capacity: int,
                     mode: str = "simplified",
                     time_window: int = 1) -> FusedLifInjectOut:
    """B substeps of LIF, spike compaction and inject: ``v, refrac
    [n_rows, N]``, ``currents [B, n_rows, N]``, ``params`` LIF
    parameters broadcasting to ``[n_rows, N]``, ``table [n_rows, N,
    1]``, ``t0 [n_rows]``, ``reach [n_rows, n_chips]`` or None."""
    _check_mode_and_fanout(mode, table)
    kw = dict(reach=reach, event_capacity=event_capacity, n_chips=n_chips,
              buckets_per_chip=buckets_per_chip, capacity=capacity,
              mode=mode, time_window=time_window)
    if not currents.is_cuda:
        return fused_lif_inject_ref(v, refrac, currents, params, table, t0,
                                    **kw)
    return _launch_lif(v, refrac, currents, params, table, t0, **kw)


def _ready(xs, dtypes, shapes, device) -> bool:
    """Whether every argument can go to the kernel as it is: a contiguous
    tensor of its type and shape on ``device``."""
    for x, dt, shape in zip(xs, dtypes, shapes):
        if not (isinstance(x, torch.Tensor) and x.dtype == dt
                and x.device == device and x.shape == shape
                and x.is_contiguous()):
            return False
    return True


def _prepared(xs, names, dtypes, shapes, device):
    """The arguments converted for the kernel (broadcast, typed,
    contiguous, on ``device``), then checked."""
    xs = [torch.as_tensor(x, device=device).broadcast_to(sh).to(dt)
          .contiguous() for x, dt, sh in zip(xs, dtypes, shapes)]
    for x, name, dt, sh in zip(xs, names, dtypes, shapes):
        kc.check(x, name, dt, sh)
    return xs


@functools.lru_cache(maxsize=64)
def _layout(shapes):
    """Elements of a buffer holding ``shapes`` one after another, and the
    (shape, strides, offset) of each, contiguous."""
    views, offset = [], 0
    for sh in shapes:
        strides = tuple(math.prod(sh[i + 1:]) for i in range(len(sh)))
        views.append((sh, strides, offset))
        offset += math.prod(sh)
    return offset, tuple(views)


def _outputs(device, shapes, n_float: int = 0):
    """Contiguous views of one int32 buffer, one per shape, in order (the
    first, the slab, at its start: 16-byte aligned for the kernel's
    vector stores); the last ``n_float`` viewed as float32."""
    total, views = _layout(shapes)
    buf = torch.empty(total, dtype=I32, device=device)
    floats = buf.view(F32) if n_float else None
    first_float = len(views) - n_float
    return [(buf if i < first_float else floats).as_strided(*view)
            for i, view in enumerate(views)]


def _inject_shapes(b: int, n: int, nb: int, capacity: int,
                   n_chips: int | None = None):
    """slab, counts, sent, overflow, wrap_expired, lost, traffic, for
    ``n`` rows and ``n_chips`` destinations (``n`` by default)."""
    return ((n, nb, b, capacity), (b, n, nb), (b, n), (b, n), (b, n),
            (b, n), (b, n, n if n_chips is None else n_chips))


def _reach_arg(reach, n: int, n_chips: int, device):
    """The reach table as contiguous bytes on ``device`` and its pointer
    (None and 0 without one).  The caller holds the tensor until the
    launch."""
    if reach is None:
        return None, 0
    if not (isinstance(reach, torch.Tensor) and reach.dtype == torch.bool
            and reach.device == device and reach.is_contiguous()):
        reach = torch.as_tensor(reach, device=device).bool().contiguous()
    return reach, kc.check(reach, "reach", torch.bool, (n, n_chips))


def _launch(events, table, t0, *, reach, n_chips, buckets_per_chip,
            capacity, mode, time_window) -> FusedInjectOut:
    b, n, e = events.addr.shape
    dev = events.addr.device
    n_lut = table.n_neurons
    args = (*events, *table, t0)
    dtypes = (I32, I32, torch.bool) + _LUT_DTYPES + (I32,)
    shapes = ((b, n, e),) * 3 + ((n, n_lut, 1),) * 4 + ((n,),)
    if not _ready(args, dtypes, shapes, dev):
        names = ("addr", "time", "valid") + tuple(
            f"table.{f}" for f in table._fields) + ("t0",)
        args = _prepared(args, names, dtypes, shapes, dev)
    reach, reach_ptr = _reach_arg(reach, n, n_chips, dev)
    nb = n_chips * buckets_per_chip
    out = _outputs(dev, _inject_shapes(b, n, nb, capacity, n_chips))
    threads, smem = launch_plan(e, n_chips, nb, capacity, reach is not None)
    kc.launch(
        NAME, kc.kernel_fn(NAME, "fused_inject_launch", _ARGTYPES),
        *(x.data_ptr() for x in args), reach_ptr, b, n, n_chips, e, n_lut,
        buckets_per_chip,
        capacity, int(mode == "full"), time_window, threads, smem,
        *(x.data_ptr() for x in out))
    return FusedInjectOut(*out)


def _launch_lif(v, refrac, currents, params, table, t0, *, reach,
                event_capacity, n_chips, buckets_per_chip, capacity, mode,
                time_window) -> FusedLifInjectOut:
    b, n, n_neurons = currents.shape
    if table.n_neurons != n_neurons:
        raise ValueError(f"the table has {table.n_neurons} entries per chip, "
                         f"the chips {n_neurons} neurons")
    dev = currents.device
    shape = (n, n_neurons)
    args = (v, refrac, currents, *params, *table, t0)
    dtypes = _LIF_DTYPES + _LUT_DTYPES + (I32,)
    shapes = (shape, shape, (b, n, n_neurons)) + (shape,) * 5 \
        + ((n, n_neurons, 1),) * 4 + ((n,),)
    if not _ready(args, dtypes, shapes, dev):
        names = _LIF_NAMES + tuple(f"table.{f}" for f in table._fields) \
            + ("t0",)
        args = _prepared(args, names, dtypes, shapes, dev)
    reach, reach_ptr = _reach_arg(reach, n, n_chips, dev)
    nb = n_chips * buckets_per_chip
    *out, refrac_out, v_out, spikes, voltage = _outputs(
        dev, _inject_shapes(b, n, nb, capacity, n_chips) + (
            shape, shape, (b, n, n_neurons), (b, n, n_neurons)), n_float=3)
    threads, smem = lif_launch_plan(n_neurons, n_chips, nb, capacity,
                                    reach is not None)
    kc.launch(
        "fused_lif_inject",
        kc.kernel_fn("fused_lif_inject", "fused_lif_inject_launch",
                     _LIF_ARGTYPES),
        *(x.data_ptr() for x in args), reach_ptr, b, n, n_chips, n_neurons,
        buckets_per_chip,
        capacity, int(mode == "full"), time_window, event_capacity, threads,
        smem, v_out.data_ptr(), refrac_out.data_ptr(), spikes.data_ptr(),
        voltage.data_ptr(), *(x.data_ptr() for x in out))
    return FusedLifInjectOut(v=v_out, refrac=refrac_out, spikes=spikes,
                             voltage=voltage, inject=FusedInjectOut(*out))
