"""PulseFabric on one device (port of the "local" path of
``repro.core.fabric``).

One block of B substeps runs three phases, the chips on a leading axis:

1. *inject* (substep k at clock ``t0 + k``): route through the LUT, admit
   deadlines with ``B-1-k < deadline - now < 128``, flush-pack into
   column k of the ``[n_chips, n_buckets, B, C]`` slab.  Without flow
   control this is one ``fused_inject`` launch at fan-out 1; at a larger
   fan-out routing and admission are tensor ops over the block and the
   pack is one ``bucket_pack`` launch.  With flow control the substeps
   depend on each other through the credits, so they run one by one:
   route, re-offer the send queue, admit, one ``bucket_pack`` launch into
   column k, then the credit gate;
2. *exchange*: one swap of the source and destination chip axes, through
   a :class:`repro_torch.core.topology.RoutedTransport` when the fabric
   is given a topology (the timestamps then shifted by the path latency,
   per-port link words and backlog counted);
3. *drain*: one ``fused_drain`` launch (passthrough, sort or rate mode).

With a health mask (``healthy``, ``dead_links``) the routes are
recompiled around the failures and a lane whose destination its chip
cannot reach is culled at injection (inside ``fused_inject`` at fan-out
1) into ``CommStats.lost_to_failure``; words that still arrive at a dead
chip (a carry from before the failure) are culled at the drain.

:meth:`PulseFabric.superstep` runs the three in order.  The pipelined
schedule (:meth:`PulseFabric.pipeline_block`) injects and exchanges
block f, then drains block f-1, carried in a :class:`repro_torch.core.
pulse_comm.PipelineCarry`; its deposits clear the B slots popped during
the extra block (``extra_ahead=B``).

Kernels run when the tensors lie on a CUDA device; on the CPU the same
wrappers run their plain PyTorch versions.  Multi-GPU transports are a
later slice and raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import delays as dl
from repro_torch.core import events as ev
from repro_torch.core import flowcontrol as fc
from repro_torch.core import merge as mg
from repro_torch.core import pulse_comm as pc
from repro_torch.core import routing as rt
from repro_torch.core import topology as tpo
from repro_torch.core import transport as tp
from repro_torch.kernels import common as kc
from repro_torch.kernels.fused_drain import ops as fd_ops
from repro_torch.kernels.fused_inject import ops as fi_ops
from repro_torch.obs.trace import phase_scope

I32 = torch.int32


@dataclasses.dataclass(frozen=True)
class FlowControlConfig:
    """Credit-based back-pressure at the injection point (paper §2.1).

    capacity         -- consumer ring-buffer slots == packets in flight;
    drain_rate       -- packets the consumer retires (credits returned)
                        per step;
    retransmit_depth -- when > 0, credit-stalled words wait in a bounded
                        per-chip send queue and are re-offered next step;
                        only the overflow beyond it drops into
                        ``CommStats.stalled``.  0 drops every withheld
                        word into ``stalled``.
    """

    capacity: int = 8
    drain_rate: int = 2
    retransmit_depth: int = 0


class FabricResult(NamedTuple):
    """``delivered.words`` is ``[B, n_chips, R]`` (``[n_chips, R]`` from
    :meth:`PulseFabric.step`), stats likewise.  The carries: ``flow``
    (credits, with flow control), ``merge`` (the rate-limited merge
    queue), ``sendq`` (the retransmit queue) and ``pending`` (the
    pipelined schedule's in-flight block); each is None where its stage
    is off."""

    ring: dl.DelayRing
    delivered: pc.Delivered
    stats: pc.CommStats
    flow: fc.RingState | None = None
    merge: mg.MergeBuffer | None = None
    sendq: fc.SendQueue | None = None
    pending: pc.PipelineCarry | None = None


class PulseFabric:
    """The pulse-communication engine for chips on a leading tensor axis.

    Arguments of :meth:`superstep`: ``events [B, n_chips, E]``,
    ``table [n_chips, N, K]``, ``ring [n_chips, D, n_inputs]`` with
    ``ring.now [n_chips]``.  Substep k runs at ``ring.now + k``; the caller
    advances the clock by B afterwards.

    ``transport`` is ``"local"`` (the dense exchange), a
    :class:`~repro_torch.core.topology.Topology` or a
    :class:`~repro_torch.core.topology.RoutedTransport`.  ``healthy``
    (alive chips: indices or a bool mask) and ``dead_links`` ((chip,
    port) pairs, which need a topology) run the fabric degraded; then
    ``reach`` is the deliverability table, bool ``[n_chips(src),
    n_chips(dst)]`` on the fabric's device (None at full health).
    """

    def __init__(self, cfg: pc.PulseCommConfig, transport="local", *,
                 flow: FlowControlConfig | None = None, healthy=None,
                 dead_links=(), device="cuda"):
        self.cfg = cfg
        self.flow = flow
        self.device = kc.resolve_device(device)
        self._spec = transport
        self.healthy = tpo.normalize_healthy(cfg.n_chips, healthy)
        self.dead_links = tpo.normalize_dead_links(dead_links)
        if isinstance(transport, tpo.Topology):
            transport = tpo.RoutedTransport(topology=transport)
        if isinstance(transport, tpo.RoutedTransport):
            if transport.n_chips != cfg.n_chips:
                raise ValueError(f"topology has {transport.n_chips} chips, "
                                 f"config {cfg.n_chips}")
            if cfg.superstep > 1:
                # A block of B steps has B steps of link capacity to drain.
                transport = transport.with_flush_rounds(cfg.superstep)
        elif transport == "local":
            transport = tp.LocalTransport(cfg.n_chips)
        else:
            raise NotImplementedError(
                f"transport {transport!r}: the port takes 'local', a "
                "Topology or a RoutedTransport; multi-GPU transports are "
                "ROADMAP section 1, item 7")
        # Degraded: rebind a routed transport onto the plan recompiled
        # around the failures; ``reach`` is the deliverability table the
        # inject stage culls against, ``_dead`` the dead chips the drain
        # culls at (None where every chip lives).
        self.reach = self._dead = None
        if self.healthy is not None or self.dead_links:
            alive = tpo.alive_mask(cfg.n_chips, self.healthy)
            if isinstance(transport, tpo.RoutedTransport):
                transport = transport.with_health(self.healthy,
                                                  self.dead_links)
                reach = transport.plan.hops >= 0
            else:
                if self.dead_links:
                    raise ValueError(
                        "dead_links need a routed topology transport; "
                        "dense transports model no individual links")
                reach = np.ones((cfg.n_chips, cfg.n_chips), bool)
            self.reach = torch.as_tensor(
                reach & alive[:, None] & alive[None, :], device=self.device)
            if not alive.all():
                self._dead = torch.as_tensor(~alive, device=self.device)
        self.transport = transport
        max_lat = self.max_path_latency
        if max_lat >= ev.TIME_MOD // 2:
            # An admitted word's deadline lies within 128 steps ahead; a
            # shift below 128 keeps it under 256, so an over-delayed word
            # wraps onto a negative difference and expires at deposit.
            raise ValueError(
                f"transport path latency {max_lat} reaches the 8-bit wrap "
                f"half-window ({ev.TIME_MOD // 2}); a delivered word could "
                "alias onto a future deadline")
        if cfg.superstep > 1 and (cfg.superstep + max_lat + cfg.ring_depth
                                  >= ev.TIME_MOD // 2):
            raise ValueError(
                f"superstep {cfg.superstep} + transport path latency "
                f"{max_lat} + ring_depth {cfg.ring_depth} reaches the 8-bit "
                f"wrap half-window ({ev.TIME_MOD // 2}); a deferred word "
                "could alias onto a future deadline - lower the superstep "
                "or shorten the topology's paths")

    @property
    def max_path_latency(self) -> int:
        """The transport's longest path latency (0 on the dense path)."""
        return int(getattr(self.transport, "max_path_latency", 0))

    def degrade(self, healthy=None, dead_links=()) -> "PulseFabric":
        """A fabric on the same config and transport whose routes are
        recompiled around the given failures (full health: the baseline);
        every carry keeps its shape, so ring, credits, queues and the
        pipeline carry thread straight across."""
        return PulseFabric(self.cfg, self._spec, flow=self.flow,
                           healthy=healthy, dead_links=dead_links,
                           device=self.device)

    # -- carries -------------------------------------------------------------

    @property
    def merge_enabled(self) -> bool:
        return self.cfg.mode == "full" and self.cfg.merge_rate > 0

    @property
    def sendq_enabled(self) -> bool:
        """True when credit-stalled words are queued for retransmission
        instead of dropped."""
        return self.flow is not None and self.flow.retransmit_depth > 0

    def init_merge(self) -> mg.MergeBuffer | None:
        if not self.merge_enabled:
            return None
        return mg.merge_init(self.cfg.merge_depth,
                             batch_shape=(self.cfg.n_chips,),
                             device=self.device)

    def init_flow(self) -> fc.RingState | None:
        """Fresh credit state, ``[n_chips]`` counters; None without flow
        control."""
        if self.flow is None:
            return None
        return fc.init(self.flow.capacity, batch_shape=(self.cfg.n_chips,),
                       device=self.device)

    def init_sendq(self) -> fc.SendQueue | None:
        """An empty ``[n_chips, retransmit_depth]`` send queue; None unless
        the retransmit queue is on."""
        if not self.sendq_enabled:
            return None
        return fc.sendq_init(self.flow.retransmit_depth,
                             batch_shape=(self.cfg.n_chips,),
                             device=self.device)

    @property
    def _n_ports(self) -> int:
        """Ports of the transport's link stats: the topology's, one on the
        dense path."""
        topo = getattr(self.transport, "topology", None)
        return 1 if topo is None else topo.n_ports

    def init_pending(self) -> pc.PipelineCarry:
        """An empty pipeline carry: the prologue block, whose drain
        deposits nothing and reports zeros."""
        return pc.pipeline_init(self.cfg, self._n_ports, device=self.device)

    def _init_missing(self, flow, merge, sendq):
        if self.flow is not None and flow is None:
            flow = self.init_flow()
        if self.merge_enabled and merge is None:
            merge = self.init_merge()
        if self.sendq_enabled and sendq is None:
            sendq = self.init_sendq()
        return flow, merge, sendq

    def _check(self, events: ev.EventBuffer, ring: dl.DelayRing):
        b = events.addr.shape[0]
        if b != self.cfg.superstep:
            raise ValueError(f"events carry {b} substeps, cfg.superstep is "
                             f"{self.cfg.superstep}")
        for x in (events.addr, ring.ring):
            if x.device != self.device:
                raise ValueError(f"tensor on {x.device}, fabric on "
                                 f"{self.device}")

    def _check_pipeline_guard(self) -> None:
        """A word waits up to two blocks before its deposit on the
        pipelined schedule, so ``2B + path latency + ring_depth`` must
        stay inside the 8-bit half-window."""
        b, d = self.cfg.superstep, self.cfg.ring_depth
        lat = self.max_path_latency
        if 2 * b + lat + d >= ev.TIME_MOD // 2:
            raise ValueError(
                f"pipelined schedule: 2*superstep ({2 * b}) + transport "
                f"path latency {lat} + ring_depth {d} reaches the 8-bit "
                f"wrap half-window ({ev.TIME_MOD // 2}); an in-flight word "
                "could alias onto a future deadline")

    # -- the serial schedule -------------------------------------------------

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
        """One B-step block: B injections, one exchange, B drains.  Missing
        carries are made fresh."""
        self._check(events, ring)
        flow, merge, sendq = self._init_missing(flow, merge, sendq)
        t0 = ring.now
        with phase_scope("fabric/inject"):
            slab, inject, flow, sendq = self._inject_block(
                events, table, flow, sendq, t0)
        with phase_scope("fabric/exchange"):
            issued = pc.exchange_flush_issue(self.cfg, slab, self.transport)
        with phase_scope("fabric/drain"):
            ring, delivered, stats, merge = self._drain_block(
                ring, merge, issued, inject, t0)
        return FabricResult(ring=ring, delivered=delivered, stats=stats,
                            flow=flow, merge=merge, sendq=sendq)

    # -- the pipelined schedule ----------------------------------------------

    def pipeline_block(self, events: ev.EventBuffer, table: rt.RoutingTable,
                       ring: dl.DelayRing, flow=None, merge=None, sendq=None,
                       pending: pc.PipelineCarry | None = None
                       ) -> FabricResult:
        """One stage of the pipelined schedule: inject and exchange this
        block, then drain the carried previous block with the deposit
        guard widened by B (its slots of the following block were popped
        too).  Same clock contract as :meth:`superstep`.  The returned
        ``delivered`` / ``stats`` describe the previous block (zeros and
        sentinels after the empty prologue); this block rides in
        ``pending`` until the next call or :meth:`flush_pending`."""
        self._check(events, ring)
        self._check_pipeline_guard()
        flow, merge, sendq = self._init_missing(flow, merge, sendq)
        if pending is None:
            pending = self.init_pending()
        t0 = ring.now
        with phase_scope("fabric/inject"):
            slab, inject, flow, sendq = self._inject_block(
                events, table, flow, sendq, t0)
        with phase_scope("fabric/exchange"):
            issued = pc.exchange_flush_issue(self.cfg, slab, self.transport)
        with phase_scope("fabric/drain"):
            ring, delivered, stats, merge = self._drain_block(
                ring, merge, pc.IssuedFlush(words=pending.words,
                                            link=pending.link),
                pending.inject, pending.t0, extra_ahead=self.cfg.superstep,
                gate=pending.valid)
        pending = pc.PipelineCarry(
            words=issued.words, link=issued.link, inject=inject,
            t0=t0.clone(), valid=torch.ones_like(pending.valid))
        return FabricResult(ring=ring, delivered=delivered, stats=stats,
                            flow=flow, merge=merge, sendq=sendq,
                            pending=pending)

    def flush_pending(self, ring: dl.DelayRing, pending: pc.PipelineCarry,
                      flow=None, merge=None, sendq=None) -> FabricResult:
        """Epilogue: drain the carried block against its own clock with the
        serial deposit guard; returns its ``delivered`` / ``stats`` and an
        empty carry.  ``flow`` and ``sendq`` pass through."""
        if self.merge_enabled and merge is None:
            merge = self.init_merge()
        with phase_scope("fabric/flush"):
            ring, delivered, stats, merge = self._drain_block(
                ring, merge, pc.IssuedFlush(words=pending.words,
                                            link=pending.link),
                pending.inject, pending.t0, gate=pending.valid)
        return FabricResult(ring=ring, delivered=delivered, stats=stats,
                            flow=flow, merge=merge, sendq=sendq,
                            pending=self.init_pending())

    def run_pipelined(self, events: ev.EventBuffer, table: rt.RoutingTable,
                      ring: dl.DelayRing, flow=None, merge=None,
                      sendq=None) -> FabricResult:
        """F pipelined blocks end to end, ``events [F, B, n_chips, E]``:
        the stages, then the flush.  Outputs are realigned to blocks (the
        first stage drained the empty prologue, so it is dropped and the
        flush appended): ``delivered`` and ``stats`` are ``[F, B, n_chips,
        ...]``, element f exactly block f.  The clock advances by B per
        block; on return ``ring.now`` is ``t0 + F*B``."""
        if events.addr.dim() < 2 or events.addr.shape[1] != (
                self.cfg.superstep):
            raise ValueError(
                f"events must carry [F, B={self.cfg.superstep}, ...] "
                f"leading axes, got shape {tuple(events.addr.shape)}")
        self._check_pipeline_guard()
        flow, merge, sendq = self._init_missing(flow, merge, sendq)
        b = self.cfg.superstep
        pending, outs = None, []
        for f in range(events.addr.shape[0]):
            res = self.pipeline_block(
                ev.EventBuffer(*(x[f] for x in events)), table, ring, flow,
                merge, sendq, pending)
            ring = dl.DelayRing(ring=res.ring.ring, now=res.ring.now + b)
            flow, merge, sendq, pending = (res.flow, res.merge, res.sendq,
                                           res.pending)
            outs.append(res)
        last = self.flush_pending(ring, pending, flow, merge, sendq)
        outs = outs[1:] + [last]
        stack = lambda xs: type(xs[0])(*(  # noqa: E731
            torch.stack(v) for v in zip(*xs)))
        return last._replace(
            delivered=stack([r.delivered for r in outs]),
            stats=stack([r.stats for r in outs]))

    # -- the three phases ----------------------------------------------------

    def _inject_block(self, events, table, flow, sendq, t0):
        """Phase 1.  Returns ``(slab, inject_stats, flow, sendq)``."""
        if self.flow is not None:
            return self._inject_block_gated(events, table, flow, sendq, t0)
        if table.fanout == 1:
            slab, inject = self._inject_block_fused(events, table, t0)
        else:
            slab, inject = self._inject_block_packed(events, table, t0)
        return slab, inject, flow, sendq

    def _inject_block_packed(self, events, table, t0):
        """Fan-out > 1 without flow control: routing and admission as
        tensor ops over the whole block, then one ``bucket_pack``
        launch."""
        cfg = self.cfg
        routed, sent, wrap_expired, lost = pc.route_block(events, table, t0,
                                                          self.reach)
        flushbuf, counts, overflow, traffic = pc.aggregate_into(cfg, routed)
        inject = pc.inject_stats(cfg, counts=counts, sent=sent,
                                 overflow=overflow,
                                 wrap_expired=wrap_expired, traffic=traffic,
                                 lost=lost)
        return flushbuf.slab, inject

    def _inject_block_fused(self, events, table, t0):
        """Fan-out 1 without flow control: one ``fused_inject`` launch
        (with the reach cull under a health mask)."""
        cfg = self.cfg
        out = fi_ops.fused_inject(
            events, table, t0, reach=self.reach, n_chips=cfg.n_chips,
            buckets_per_chip=cfg.buckets_per_chip,
            capacity=cfg.bucket_capacity, mode=cfg.mode,
            time_window=cfg.time_window)
        inject = pc.inject_stats(cfg, counts=out.counts, sent=out.sent,
                                 overflow=out.overflow,
                                 wrap_expired=out.wrap_expired,
                                 traffic=out.traffic, lost=out.lost)
        return out.slab, inject

    def _inject_block_gated(self, events, table, flow, sendq, t0):
        """With flow control, at any fan-out: substep by substep (the
        credits of substep k depend on substep k-1), route, re-offer the
        send queue ahead of the fresh lanes, cull against the health mask
        (after the requeue, so a queued word for a chip that died while
        it waited is culled too; before the window, so a culled word is
        never also expired), admit, pack into column k (one
        ``bucket_pack`` launch), then the credit gate.  ``sent`` counts
        each substep's fresh lanes only: a queued word was counted when
        it was first offered."""
        cfg = self.cfg
        b = events.addr.shape[0]
        flushbuf = pc.flush_init(cfg, device=t0.device)
        per_k, lost_k = [], []
        for k in range(b):
            now_k = t0 + k
            routed = rt.route(ev.EventBuffer(*(x[k] for x in events)), table)
            sent = routed.valid.sum(-1, dtype=I32)
            if self.sendq_enabled:
                routed = self._requeue(routed, sendq, now_k)
            if self.reach is not None:
                routed, lost = pc.cull(routed, self.reach)
                lost_k.append(lost)
            routed, wrap_expired = pc.admit(routed, now_k, (b - 1) - k)
            flushbuf, counts, overflow, traffic = pc.aggregate_into(
                cfg, routed, flushbuf, k)
            column = flushbuf.slab[:, :, k]
            flow, words, counts, stalled, sendq = self._gate(flow, column,
                                                             counts)
            column.copy_(words)
            per_k.append((counts, sent, overflow, wrap_expired, traffic,
                          stalled))
        counts, sent, overflow, wrap_expired, traffic, stalled = (
            torch.stack(x) for x in zip(*per_k))
        inject = pc.inject_stats(
            cfg, counts=counts, sent=sent, overflow=overflow,
            wrap_expired=wrap_expired, traffic=traffic, stalled=stalled,
            lost=torch.stack(lost_k) if lost_k else None)
        return flushbuf.slab, inject, flow, sendq

    def _requeue(self, routed: rt.RoutedEvents, sendq: fc.SendQueue,
                 now: torch.Tensor) -> rt.RoutedEvents:
        """Queued words go ahead of this substep's fresh lanes (age
        priority for bucket slots).  Their full deadline is rebuilt from
        the 8-bit timestamp against the clock, so a word that expired
        while it waited fails the window next and drops into
        ``expired``."""
        q_addr, _, q_valid = ev.decode_word(sendq.words)
        q_valid = q_valid & (sendq.dest >= 0)
        cat = lambda q, r: torch.cat([q, r], dim=-1)  # noqa: E731
        return rt.RoutedEvents(
            dest_chip=cat(torch.where(q_valid, sendq.dest, 0),
                          routed.dest_chip),
            dest_addr=cat(q_addr.to(I32), routed.dest_addr),
            deadline=cat(ev.word_deadline(sendq.words, now[:, None]),
                         routed.deadline),
            valid=cat(q_valid, routed.valid))

    def _gate(self, flow: fc.RingState, words: torch.Tensor,
              counts: torch.Tensor):
        """The credit gate over one substep's packed buckets (``words
        [n_chips, n_buckets, C]``, ``counts [n_chips, n_buckets]``): the
        non-empty buckets are served lowest index first while credits
        last.  Withheld words leave the wire; with a send queue they
        refill it, held lanes first in bucket-major order, cut to its
        depth, and only the surplus counts as ``stalled``; without one
        every withheld word does.  The consumer then retires
        ``drain_rate`` packets.  Returns ``(flow, words, counts, stalled,
        sendq)`` (``sendq`` None without a queue)."""
        cfg = self.cfg
        ready = (counts > 0).to(I32)
        flow, accepted = fc.produce(flow, ready.sum(-1, dtype=I32))
        rank = torch.cumsum(ready, -1, dtype=I32) - ready
        inject = ready.bool() & (rank < accepted[:, None])
        withheld = ev.word_valid(words) & ~inject[..., None]
        sendq = None
        if self.sendq_enabled:
            depth = self.flow.retransmit_depth
            n = words.shape[0]
            held = withheld.reshape(n, -1)
            # Stable compaction: held lane i goes to queue slot (number of
            # held lanes before it); slots past the depth drop.
            pos = torch.cumsum(held, -1, dtype=I32) - 1
            slot = torch.where(held & (pos < depth), pos, depth).long()
            # The word carries only the destination input row; the chip
            # is its bucket's static binding.
            dest = (torch.arange(held.shape[-1], dtype=I32,
                                 device=words.device)
                    // (cfg.buckets_per_chip * words.shape[-1])).expand(n, -1)
            q_words = ev.sentinel_words((n, depth + 1), device=words.device)
            q_words.scatter_(-1, slot, words.reshape(n, -1))
            q_dest = torch.full_like(q_words, -1)
            q_dest.scatter_(-1, slot, dest)
            q_words = q_words[:, :depth]
            sendq = fc.SendQueue(
                words=q_words,
                dest=torch.where(q_words >= 0, q_dest[:, :depth], -1))
            stalled = torch.clamp(held.sum(-1, dtype=I32) - depth, min=0)
        else:
            stalled = withheld.flatten(1).sum(-1, dtype=I32)
        words = torch.where(inject[..., None], words, ev.WORD_SENTINEL)
        counts = torch.where(inject, counts, 0)
        flow, _ = fc.consume(flow, self.flow.drain_rate)
        return flow, words, counts, stalled, sendq

    def _drain_block(self, ring, merge, issued, inject, t0, *,
                     extra_ahead: int = 0, gate=None):
        """Phase 3: the path-latency shift, then one ``fused_drain``
        launch, then the per-substep ``CommStats``; the exchange's link
        words and backlog are attributed to the last substep of the
        block.  ``extra_ahead`` widens the deposit guard, ``gate
        [n_chips]`` masks an empty pipeline carry.  Under a health mask
        the words that arrive at a dead chip (only a carry from before the
        failure can hold any) are culled into ``lost_to_failure``."""
        cfg = self.cfg
        delivered_words, link = pc.exchange_flush_complete(cfg, issued,
                                                           self.transport)
        lost = inject.lost
        if self._dead is not None:
            dead = self._dead if gate is None else self._dead & gate
            arrived = ev.word_valid(delivered_words).sum(-1, dtype=I32)
            lost = lost + torch.where(dead[:, None], arrived, 0).T
            delivered_words = torch.where(self._dead[:, None, None],
                                          ev.WORD_SENTINEL, delivered_words)
        dmode = ("rate" if self.merge_enabled
                 else "sort" if cfg.mode == "full" else "passthrough")
        fused = fd_ops.fused_drain(
            ring, delivered_words, merge.words if dmode == "rate" else None,
            t0, mode=dmode, rate=cfg.merge_rate, extra_ahead=extra_ahead,
            gate=gate)
        if dmode == "rate":
            merge = mg.MergeBuffer(words=fused.queue)
        b = inject.sent.shape[0]
        link_words, link_backlog = (
            torch.cat([torch.zeros((b - 1,) + x.shape, dtype=I32,
                                   device=x.device), x[None]])
            for x in (link.words, link.backlog))
        stats = pc.CommStats(
            sent=inject.sent, overflow=inject.overflow,
            merge_dropped=fused.dropped,
            expired=inject.wrap_expired + fused.dep_expired,
            stalled=inject.stalled, utilization=inject.utilization,
            wire_bytes=inject.wire_bytes, traffic=inject.traffic,
            link_words=link_words, link_backlog=link_backlog,
            lost_to_failure=lost)
        return fused.ring, pc.Delivered(words=fused.words), stats, merge
