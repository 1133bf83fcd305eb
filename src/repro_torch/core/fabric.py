"""PulseFabric on one device, serial schedule (port of the "local" path of
``repro.core.fabric``).

One block of B substeps runs three phases, the chips on a leading axis:

1. *inject* (substep k at clock ``t0 + k``): route through the LUT, admit
   deadlines with ``B-1-k < deadline - now < 128``, flush-pack into
   column k of the ``[n_chips, n_buckets, B, C]`` slab.  With fan-out 1
   this is one ``fused_inject`` launch; otherwise routing and admission
   are tensor ops and the pack is one ``bucket_pack`` launch;
2. *exchange*: one swap of the source and destination chip axes;
3. *drain*: one ``fused_drain`` launch (passthrough, sort or rate mode).

Kernels run when the tensors lie on a CUDA device; on the CPU the same
wrappers run their plain PyTorch versions.  Flow control, topologies,
health masks and the pipelined schedule are later slices and raise
``NotImplementedError``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import delays as dl
from repro_torch.core import events as ev
from repro_torch.core import merge as mg
from repro_torch.core import pulse_comm as pc
from repro_torch.core import routing as rt
from repro_torch.core import transport as tp
from repro_torch.kernels import common as kc
from repro_torch.kernels.fused_drain import ops as fd_ops
from repro_torch.kernels.fused_inject import ops as fi_ops

I32 = torch.int32


class FabricResult(NamedTuple):
    """``delivered.words`` is ``[B, n_chips, R]`` (``[n_chips, R]`` from
    :meth:`PulseFabric.step`), stats likewise; ``merge`` is the queue
    carry when the rate-limited merge runs."""

    ring: dl.DelayRing
    delivered: pc.Delivered
    stats: pc.CommStats
    flow: None = None
    merge: mg.MergeBuffer | None = None
    sendq: None = None
    pending: None = None


class PulseFabric:
    """The pulse-communication engine for chips on a leading tensor axis.

    Arguments of :meth:`superstep`: ``events [B, n_chips, E]``,
    ``table [n_chips, N, K]``, ``ring [n_chips, D, n_inputs]`` with
    ``ring.now [n_chips]``.  Substep k runs at ``ring.now + k``; the caller
    advances the clock by B afterwards.
    """

    def __init__(self, cfg: pc.PulseCommConfig, transport="local", *,
                 flow=None, healthy=None, dead_links=(), device="cuda"):
        if transport != "local":
            raise NotImplementedError(
                "only the single-device 'local' transport is ported; "
                "topologies and multi-GPU transports are later slices")
        if flow is not None:
            raise NotImplementedError("flow control is not ported yet")
        if healthy is not None or dead_links:
            raise NotImplementedError(
                "health masks and dead links are not ported yet")
        self.cfg = cfg
        self.device = kc.resolve_device(device)
        self.transport = tp.LocalTransport(cfg.n_chips)

    @property
    def merge_enabled(self) -> bool:
        return self.cfg.mode == "full" and self.cfg.merge_rate > 0

    def init_merge(self) -> mg.MergeBuffer | None:
        if not self.merge_enabled:
            return None
        return mg.merge_init(self.cfg.merge_depth,
                             batch_shape=(self.cfg.n_chips,),
                             device=self.device)

    def _check(self, events: ev.EventBuffer, ring: dl.DelayRing, flow,
               sendq):
        if flow is not None or sendq is not None:
            raise NotImplementedError("flow control is not ported yet")
        for x in (events.addr, ring.ring):
            if x.device != self.device:
                raise ValueError(f"tensor on {x.device}, fabric on "
                                 f"{self.device}")

    def step(self, events: ev.EventBuffer, table: rt.RoutingTable,
             ring: dl.DelayRing, flow=None, merge=None,
             sendq=None) -> FabricResult:
        """One step (``cfg.superstep == 1``): ``events [n_chips, E]``."""
        if self.cfg.superstep != 1:
            raise ValueError(
                f"cfg.superstep={self.cfg.superstep}: drive the fabric "
                "through superstep(events[B, ...], ...)")
        res = self.superstep(ev.EventBuffer(*(x[None] for x in events)),
                             table, ring, flow, merge, sendq)
        return res._replace(
            delivered=pc.Delivered(words=res.delivered.words[0]),
            stats=pc.CommStats(*(x[0] for x in res.stats)))

    def superstep(self, events: ev.EventBuffer, table: rt.RoutingTable,
                  ring: dl.DelayRing, flow=None, merge=None,
                  sendq=None) -> FabricResult:
        """One B-step block: B injections, one exchange, B drains."""
        b = events.addr.shape[0]
        if b != self.cfg.superstep:
            raise ValueError(f"events carry {b} substeps, cfg.superstep is "
                             f"{self.cfg.superstep}")
        self._check(events, ring, flow, sendq)
        if self.merge_enabled and merge is None:
            merge = self.init_merge()
        t0 = ring.now
        if table.fanout == 1:
            slab, inject = self._inject_block_fused(events, table, t0)
        else:
            slab, inject = self._inject_block(events, table, t0)
        issued = pc.exchange_flush_issue(self.cfg, slab, self.transport)
        ring, delivered, stats, merge = self._drain_block(
            ring, merge, issued, inject, t0)
        return FabricResult(ring=ring, delivered=delivered, stats=stats,
                            merge=merge)

    def _inject_block(self, events, table, t0):
        """Phase 1 for fan-out > 1: routing and admission as tensor ops
        over the whole block, then one ``bucket_pack`` launch."""
        cfg = self.cfg
        routed, sent, wrap_expired = pc.route_block(events, table, t0)
        flushbuf, counts, overflow, traffic = pc.aggregate_into(cfg, routed)
        inject = pc.inject_stats(cfg, counts=counts, sent=sent,
                                 overflow=overflow,
                                 wrap_expired=wrap_expired, traffic=traffic)
        return flushbuf.slab, inject

    def _inject_block_fused(self, events, table, t0):
        """Phase 1 for fan-out 1: one ``fused_inject`` launch."""
        cfg = self.cfg
        out = fi_ops.fused_inject(
            events, table, t0, n_chips=cfg.n_chips,
            buckets_per_chip=cfg.buckets_per_chip,
            capacity=cfg.bucket_capacity, mode=cfg.mode,
            time_window=cfg.time_window)
        inject = pc.inject_stats(cfg, counts=out.counts, sent=out.sent,
                                 overflow=out.overflow,
                                 wrap_expired=out.wrap_expired,
                                 traffic=out.traffic)
        return out.slab, inject

    def _drain_block(self, ring, merge, issued, inject, t0):
        """Phase 3: one ``fused_drain`` launch, then the per-substep
        ``CommStats``; the exchange's link words are attributed to the
        last substep of the block."""
        cfg = self.cfg
        delivered_words, link = pc.exchange_flush_complete(cfg, issued)
        dmode = ("rate" if self.merge_enabled
                 else "sort" if cfg.mode == "full" else "passthrough")
        fused = fd_ops.fused_drain(
            ring, delivered_words, merge.words if dmode == "rate" else None,
            t0, mode=dmode, rate=cfg.merge_rate)
        if dmode == "rate":
            merge = mg.MergeBuffer(words=fused.queue)
        zeros = torch.zeros_like(inject.sent)
        link_words = torch.zeros_like(zeros)[..., None].repeat(
            1, 1, link.words.shape[-1])
        link_words[-1] = link.words
        stats = pc.CommStats(
            sent=inject.sent, overflow=inject.overflow,
            merge_dropped=fused.dropped,
            expired=inject.wrap_expired + fused.dep_expired,
            stalled=inject.stalled, utilization=inject.utilization,
            wire_bytes=inject.wire_bytes, traffic=inject.traffic,
            link_words=link_words, link_backlog=torch.zeros_like(link_words),
            lost_to_failure=inject.lost)
        return fused.ring, pc.Delivered(words=fused.words), stats, merge
