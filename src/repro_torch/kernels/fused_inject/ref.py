"""Plain PyTorch version of the fused inject path: the composed chain of
the reference (``repro.kernels.fused_inject.ref.fused_inject_ref``) over
a whole block and every chip at once — route, the reach cull (lanes to
an in-range destination their chip cannot reach drop into ``lost``),
wrap-window admission, bucket ids, and the reference flush-pack into a
fresh slab.

:func:`fused_lif_inject_ref` puts the LIF update in front, as the
reference's ``fused_lif_inject_ref`` does: per substep the plain LIF
step, then ``events.from_spikes`` (the stable compaction with the
``event_capacity`` cut), then the inject chain over the block.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import buckets as bk
from repro_torch.core import events as ev
from repro_torch.core import pulse_comm as pc
from repro_torch.core import routing as rt
from repro_torch.core import transport as tp
from repro_torch.kernels.lif_step.ref import lif_step_ref


class FusedInjectOut(NamedTuple):
    """``n_rows`` source chips (the inputs' chip axis), ``n_chips``
    destinations (``n_buckets = n_chips * buckets_per_chip``):

    slab         : int32[n_rows, n_buckets, B, capacity]
    counts       : int32[B, n_rows, n_buckets] pre-overflow fill levels
    sent         : int32[B, n_rows] routed events offered
    overflow     : int32[B, n_rows] bucket-capacity drops
    wrap_expired : int32[B, n_rows] admission-window drops
    lost         : int32[B, n_rows] culled by the reach row
    traffic      : int32[B, n_rows, n_chips] events by destination
    """

    slab: torch.Tensor
    counts: torch.Tensor
    sent: torch.Tensor
    overflow: torch.Tensor
    wrap_expired: torch.Tensor
    lost: torch.Tensor
    traffic: torch.Tensor


def fused_inject_ref(events: ev.EventBuffer, table: rt.RoutingTable,
                     t0: torch.Tensor, *, reach: torch.Tensor | None = None,
                     n_chips: int, buckets_per_chip: int, capacity: int,
                     mode: str = "simplified",
                     time_window: int = 1) -> FusedInjectOut:
    """``events [B, n_rows, E]``, ``table [n_rows, N, 1]``,
    ``t0 [n_rows]``, ``reach [n_rows(src), n_chips(dst)]`` bool (None:
    every chip reaches every chip)."""
    routed, sent, wrap_expired, lost = pc.route_block(events, table, t0,
                                                      reach)
    if mode == "simplified":
        bid = bk.static_bucket_ids(routed.dest_chip, n_chips=n_chips,
                                   streams=buckets_per_chip)
    else:
        bid = bk.dynamic_bucket_ids(routed.dest_chip, routed.deadline,
                                    n_chips=n_chips,
                                    pool_per_chip=buckets_per_chip,
                                    window=time_window)
    packed = bk.pack(bid, routed.dest_addr, routed.deadline, routed.valid,
                     n_buckets=n_chips * buckets_per_chip, capacity=capacity)
    return FusedInjectOut(
        slab=packed.words.permute(1, 2, 0, 3).contiguous(),
        counts=packed.counts, sent=sent, overflow=packed.overflow,
        wrap_expired=wrap_expired,
        lost=torch.zeros_like(sent) if lost is None else lost,
        traffic=tp.exchange_matrix(routed.dest_chip, routed.valid, n_chips))


class FusedLifInjectOut(NamedTuple):
    """v, refrac : [n_rows, N] membrane and refractory count after the
    block; spikes, voltage : f32[B, n_rows, N] per substep; inject : the
    block's :class:`FusedInjectOut`."""

    v: torch.Tensor
    refrac: torch.Tensor
    spikes: torch.Tensor
    voltage: torch.Tensor
    inject: FusedInjectOut


def fused_lif_inject_ref(v: torch.Tensor, refrac: torch.Tensor,
                         currents: torch.Tensor, params,
                         table: rt.RoutingTable, t0: torch.Tensor, *,
                         reach: torch.Tensor | None = None,
                         event_capacity: int, n_chips: int,
                         buckets_per_chip: int, capacity: int,
                         mode: str = "simplified",
                         time_window: int = 1) -> FusedLifInjectOut:
    """``v, refrac [n_rows, N]``, ``currents [B, n_rows, N]`` (known for
    the whole block: under the superstep admission rule no event injected
    in a block is delivered inside it), ``params`` LIF parameters
    ``[n_rows, N]``, ``table [n_rows, N, 1]``, ``t0 [n_rows]``,
    ``reach`` as :func:`fused_inject_ref`'s."""
    ebs, spikes, voltage = [], [], []
    for k in range(currents.shape[0]):
        v, refrac, spk = lif_step_ref(
            v, refrac, currents[k], params.tau_m, params.v_th,
            params.v_reset, params.v_rest, params.refrac)
        spikes.append(spk)
        voltage.append(v)
        ebs.append(ev.from_spikes(spk > 0.5, (t0 + k)[..., None],
                                  event_capacity)[0])
    events = ev.EventBuffer(*(torch.stack(x) for x in zip(*ebs)))
    inject = fused_inject_ref(
        events, table, t0, reach=reach, n_chips=n_chips, buckets_per_chip=buckets_per_chip,
        capacity=capacity, mode=mode, time_window=time_window)
    return FusedLifInjectOut(v=v, refrac=refrac, spikes=torch.stack(spikes),
                             voltage=torch.stack(voltage), inject=inject)
