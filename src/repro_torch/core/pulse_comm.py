"""PulseComm configuration, accounting and the superstep exchange (port of
``repro.core.pulse_comm``).

Layouts on the local path: the flush slab is ``[n_chips(src), n_buckets,
B, capacity]``; per-substep accounting is ``[B, n_chips, ...]``, as the
JAX fabric returns it.  The exchange goes through the dense transport or
a :class:`repro_torch.core.topology.RoutedTransport`.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core import buckets as bk
from repro_torch.core import events as ev
from repro_torch.core import routing as rt
from repro_torch.core import transport as tp
from repro_torch.obs.trace import phase_scope

I32 = torch.int32

WORD_BYTES = 4
EVENT_BYTES = WORD_BYTES
HEADER_BYTES = 32


@dataclasses.dataclass(frozen=True)
class PulseCommConfig:
    """The reference config without ``use_pallas``: kernels run whenever
    the tensors lie on a CUDA device."""

    n_chips: int
    neurons_per_chip: int = 512
    n_inputs_per_chip: int = 256
    event_capacity: int = 256
    fanout: int = 1
    bucket_capacity: int = 16
    buckets_per_chip: int = 1
    ring_depth: int = 16
    mode: str = "simplified"
    merge_rate: int = 0
    merge_depth: int = 64
    time_window: int = 4
    superstep: int = 1

    def __post_init__(self):
        half = ev.TIME_MOD // 2
        if self.mode not in ("simplified", "full"):
            raise ValueError(f"unknown mode {self.mode!r}")
        if self.superstep < 1:
            raise ValueError(f"superstep {self.superstep} must be >= 1")
        if self.superstep > 1 and self.superstep + self.ring_depth >= half:
            # A deferred word must land inside the wrap half-window, or it
            # could alias onto a future deadline instead of expiring.
            raise ValueError(
                f"superstep {self.superstep} + ring_depth {self.ring_depth}"
                f" reaches the 8-bit wrap half-window ({half})")
        if self.neurons_per_chip > (1 << ev.ADDR_BITS):
            raise ValueError("neuron address exceeds 14-bit event format")
        if self.n_inputs_per_chip > (1 << ev.ADDR_BITS):
            raise ValueError("input address exceeds 14-bit event format")
        if self.merge_rate > 0 and self.merge_depth > half * self.merge_rate:
            # A queued word must drain before it can age across the wrap.
            raise ValueError(
                f"merge_depth {self.merge_depth} exceeds {half} * "
                "merge_rate; a queued word could age past the 8-bit wrap")
        if self.ring_depth >= half:
            raise ValueError(f"ring_depth {self.ring_depth} exceeds the "
                             f"8-bit wrap half-window ({half - 1})")

    @property
    def n_buckets(self) -> int:
        return self.n_chips * self.buckets_per_chip

    @property
    def lanes_in(self) -> int:
        """Incoming lanes per chip after exchange."""
        return self.n_chips * self.buckets_per_chip * self.bucket_capacity


class CommStats(NamedTuple):
    """Per-step, per-chip accounting (fields lead with ``[B, n_chips]``)."""

    sent: torch.Tensor
    overflow: torch.Tensor
    merge_dropped: torch.Tensor
    expired: torch.Tensor
    stalled: torch.Tensor
    utilization: torch.Tensor    # f32
    wire_bytes: torch.Tensor
    traffic: torch.Tensor        # [..., n_chips]
    link_words: torch.Tensor     # [..., n_ports] words of the exchange
    link_backlog: torch.Tensor   # [..., n_ports] words past link capacity
    lost_to_failure: torch.Tensor


class Delivered(NamedTuple):
    """Post-exchange (merged) wire words at each destination chip."""

    words: torch.Tensor


class FlushBuffer(NamedTuple):
    """The superstep flush slab ``[n_chips, n_buckets, B, capacity]`` and
    the number of substep columns filled so far."""

    slab: torch.Tensor
    phase: int


def flush_init(cfg: PulseCommConfig, device=None) -> FlushBuffer:
    return FlushBuffer(
        slab=ev.sentinel_words((cfg.n_chips, cfg.n_buckets, cfg.superstep,
                                cfg.bucket_capacity), device=device),
        phase=0)


def bucket_ids(cfg: PulseCommConfig, routed: rt.RoutedEvents) -> torch.Tensor:
    if cfg.mode == "simplified":
        return bk.static_bucket_ids(routed.dest_chip, n_chips=cfg.n_chips,
                                    streams=cfg.buckets_per_chip)
    return bk.dynamic_bucket_ids(routed.dest_chip, routed.deadline,
                                 n_chips=cfg.n_chips,
                                 pool_per_chip=cfg.buckets_per_chip,
                                 window=cfg.time_window)


def admit(routed: rt.RoutedEvents, now: torch.Tensor, defer):
    """The 8-bit wrap contract at the injection boundary: a lane stays
    valid iff ``defer < deadline - now < 128``, with ``now`` and ``defer``
    broadcast against the lanes' leading axes.  Returns ``(routed,
    wrap_expired)``, the valid lanes that failed the window counted over
    the lane axis."""
    diff = routed.deadline - now[..., None]
    in_window = (diff > defer) & (diff < ev.TIME_MOD // 2)
    wrap_expired = (routed.valid & ~in_window).sum(-1, dtype=I32)
    return routed._replace(valid=routed.valid & in_window), wrap_expired


def cull(routed: rt.RoutedEvents, reach: torch.Tensor):
    """The health mask at the injection boundary: a valid lane whose
    in-range destination chip its source cannot reach (``reach
    [n_chips(src), n_chips(dst)]`` bool, the source chips on the lanes'
    second-to-last axis) leaves the wire.  Out-of-range destinations keep
    their drop at the exchange.  Returns ``(routed, lost)``, ``lost`` the
    culled lanes counted over the lane axis."""
    n = reach.shape[-1]
    dest = routed.dest_chip
    in_range = (dest >= 0) & (dest < n)
    row = reach.expand(dest.shape[:-1] + (n,))
    ok = ~in_range | row.gather(-1, dest.clamp(0, n - 1).long())
    lost = (routed.valid & ~ok).sum(-1, dtype=I32)
    return routed._replace(valid=routed.valid & ok), lost


def route_block(events: ev.EventBuffer, table: rt.RoutingTable,
                t0: torch.Tensor, reach: torch.Tensor | None = None):
    """Route a block ``[B, n_chips, E]``, cull it against ``reach`` (see
    :func:`cull`; None culls nothing) and admit it into the wrap window,
    with the remaining deferral ``B-1-k`` as extra slack.  Returns
    ``(routed, sent, wrap_expired, lost)``, counts ``[B, n_chips]`` (``lost``
    None without ``reach``)."""
    b = events.addr.shape[0]
    routed = rt.route(events, table)
    sent = routed.valid.sum(-1, dtype=I32)
    lost = None
    if reach is not None:
        routed, lost = cull(routed, reach)
    k = torch.arange(b, dtype=I32, device=t0.device)[:, None]
    routed, wrap_expired = admit(routed, t0[None, :] + k,
                                 ((b - 1) - k)[..., None])
    return routed, sent, wrap_expired, lost


def aggregate_into(cfg: PulseCommConfig, routed: rt.RoutedEvents,
                   flushbuf: FlushBuffer | None = None,
                   substep: int | None = None):
    """Bucket assignment and flush-pack, by the ``bucket_pack`` kernel on
    a CUDA device and by its plain version on the CPU.

    Without ``flushbuf``, ``routed`` carries a whole block ``[B, n_chips,
    L]`` (without flow control the substeps do not depend on each other),
    packed into a new slab; counts are ``[B, n_chips, n_buckets]``,
    overflow ``[B, n_chips]``, traffic ``[B, n_chips, n_chips]``.  With
    ``flushbuf`` and ``substep``, ``routed`` is one substep ``[n_chips,
    L]``, packed into column ``substep`` of ``flushbuf.slab`` in place
    (the credit gate's loop); counts are ``[n_chips, n_buckets]``.
    Returns ``(flushbuf, counts, overflow, traffic)``.
    """
    from repro_torch.kernels.bucket_pack import ops as bp_ops

    lanes = (bucket_ids(cfg, routed), routed.dest_addr, routed.deadline,
             routed.valid)
    traffic = tp.exchange_matrix(routed.dest_chip, routed.valid, cfg.n_chips)
    if flushbuf is None:
        slab, counts, overflow = bp_ops.flush_pack(
            *lanes, n_buckets=cfg.n_buckets, capacity=cfg.bucket_capacity)
        return (FlushBuffer(slab=slab, phase=slab.shape[-2]), counts,
                overflow, traffic)
    counts, overflow = bp_ops.flush_pack_column(
        *lanes, slab=flushbuf.slab, substep=substep,
        capacity=cfg.bucket_capacity)
    return (FlushBuffer(slab=flushbuf.slab, phase=substep + 1), counts,
            overflow, traffic)


class LinkStats(NamedTuple):
    words: torch.Tensor     # int32[n_chips, n_ports]
    backlog: torch.Tensor   # int32[n_chips, n_ports]


class IssuedFlush(NamedTuple):
    """An exchanged block: ``words[n_chips(dst), n_chips(src), bpc, B, C]``
    (on a routed transport with the timestamps not yet shifted by the path
    latency) and its link accounting."""

    words: torch.Tensor
    link: LinkStats


def exchange_flush_issue(cfg: PulseCommConfig, slab: torch.Tensor,
                         transport=None) -> IssuedFlush:
    """Exchange the filled slabs of every chip at once through
    ``transport`` (by default the dense ``LocalTransport``).  The dense transport's ``link_words`` is
    each source chip's off-chip word count; a routed transport judges
    backlog against its ``flush_rounds`` (the fabric binds B: the block
    carries B steps and has B steps to drain) and moves the block without
    the latency shift, which :func:`exchange_flush_complete` applies.
    """
    n, bpc = cfg.n_chips, cfg.buckets_per_chip
    transport = transport or tp.LocalTransport(n)
    with phase_scope("pulse_comm/exchange_issue"):
        block = slab.reshape(n, n, bpc, slab.shape[-2], cfg.bucket_capacity)
        words, link_words, link_backlog = transport.exchange_words_start(
            block)
    return IssuedFlush(words=words, link=LinkStats(words=link_words,
                                                   backlog=link_backlog))


def exchange_flush_complete(cfg: PulseCommConfig, issued: IssuedFlush,
                            transport=None):
    """Shift the timestamps by the path latency (a routed transport's,
    from its own plan) and unpack the exchanged block into per-substep
    lanes ``[n_chips, B, lanes_in]`` (lane order: source chip, bucket,
    slot)."""
    transport = transport or tp.LocalTransport(cfg.n_chips)
    with phase_scope("pulse_comm/exchange_complete"):
        words = transport.exchange_words_finish(issued.words)
        n, b = words.shape[0], words.shape[3]
        out = words.permute(0, 3, 1, 2, 4).reshape(n, b, cfg.lanes_in)
    return out, issued.link


def exchange_flush(cfg: PulseCommConfig, slab: torch.Tensor, transport=None):
    return exchange_flush_complete(
        cfg, exchange_flush_issue(cfg, slab, transport), transport)


class InjectStats(NamedTuple):
    """Source-side accounting of one block, fields ``[B, n_chips, ...]``."""

    sent: torch.Tensor
    overflow: torch.Tensor
    stalled: torch.Tensor
    wrap_expired: torch.Tensor
    lost: torch.Tensor
    wire_bytes: torch.Tensor
    utilization: torch.Tensor
    traffic: torch.Tensor


def inject_stats(cfg: PulseCommConfig, *, counts, sent, overflow,
                 wrap_expired, traffic, stalled=None,
                 lost=None) -> InjectStats:
    """Wire bytes and utilization from the per-substep bucket counts
    ``[B, n_chips, n_buckets]`` (after the credit gate), with the
    reference's formulas (utilization is ``mean(fill) / C`` in f32);
    ``stalled`` and ``lost`` default to zeros (no flow control, no health
    mask)."""
    fill = torch.clamp(counts, max=cfg.bucket_capacity)
    n_packets = (counts > 0).sum(-1, dtype=I32)
    wire = n_packets * HEADER_BYTES + fill.sum(-1, dtype=I32) * EVENT_BYTES
    zeros = torch.zeros_like(sent)
    return InjectStats(
        sent=sent, overflow=overflow,
        stalled=zeros if stalled is None else stalled,
        wrap_expired=wrap_expired, lost=zeros if lost is None else lost,
        wire_bytes=wire.to(I32),
        utilization=fill.float().mean(-1) / float(cfg.bucket_capacity),
        traffic=traffic)


class PipelineCarry(NamedTuple):
    """The in-flight block of the pipelined schedule: issued (exchanged)
    but not yet drained.

    words  : int32[n_chips(dst), n_chips(src), bpc, B, C], the exchanged
             block (:class:`IssuedFlush` layout; sentinel = empty lane)
    link   : the exchange's link accounting, ``[n_chips, n_ports]``
    inject : the block's source-side stats, ``[B, n_chips, ...]``,
             reported when the block is drained
    t0     : int32[n_chips] block-start clock of the carried block
    valid  : bool[n_chips], False = pipeline empty (prologue, after a
             flush)

    :meth:`occupancy` is the in-flight leg of the conservation identity
    ``sent == deposited + expired + overflow + merge_dropped + stalled +
    queue occupancies + in_flight``.
    """

    words: torch.Tensor
    link: LinkStats
    inject: InjectStats
    t0: torch.Tensor
    valid: torch.Tensor

    def occupancy(self) -> torch.Tensor:
        """Valid in-flight words per chip (0 where the pipeline is
        empty)."""
        n = ev.word_valid(self.words).flatten(1).sum(-1, dtype=I32)
        return torch.where(self.valid, n, 0)


def pipeline_init(cfg: PulseCommConfig, n_ports: int = 1,
                  device=None) -> PipelineCarry:
    """An empty carry (``valid`` False, every stat zero, so draining it
    deposits nothing and reports zeros)."""
    n, b = cfg.n_chips, cfg.superstep
    z = torch.zeros((b, n), dtype=I32, device=device)
    link = torch.zeros((n, n_ports), dtype=I32, device=device)
    return PipelineCarry(
        words=ev.sentinel_words((n, n, cfg.buckets_per_chip, b,
                                 cfg.bucket_capacity), device=device),
        link=LinkStats(words=link, backlog=link.clone()),
        inject=InjectStats(
            sent=z, overflow=z, stalled=z, wrap_expired=z, lost=z,
            wire_bytes=z,
            utilization=torch.zeros((b, n), dtype=torch.float32,
                                    device=device),
            traffic=torch.zeros((b, n, n), dtype=I32, device=device)),
        t0=torch.zeros((n,), dtype=I32, device=device),
        valid=torch.zeros((n,), dtype=torch.bool, device=device))
