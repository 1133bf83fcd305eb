"""Multi-chip spiking network on the pulse fabric, serial schedule (port
of ``repro.snn.network``).

Per step t, chips on a leading tensor axis: pop delay-ring slot t, add
the external input, crossbar product, neuron dynamics, (STDP), then one
of two communication paths:

* ``event`` — spikes -> events; every B steps (``comm.superstep``) the
  block's events go through :meth:`repro_torch.core.fabric.PulseFabric.
  superstep` at the block-start clock, one exchange per block.
  Admission only puts events on the wire with more slack than their
  remaining deferral, so no event injected in a block is popped inside it
  and the schedule equals the per-step one.  With ``pipeline=True`` the
  blocks go through :meth:`~repro_torch.core.fabric.PulseFabric.
  pipeline_block` instead: block f is injected and exchanged, block f-1
  (carried in ``NetworkState.pending``) drained, and the run ends with
  the carry's flush.  Spikes and voltages are never lagged; the stats
  are realigned to their blocks.  With ``flow`` the credit state and the
  send queue ride in ``NetworkState.flow`` / ``.sendq``.  With a
  ``topology`` the exchange is routed through it (path latency on the
  deadlines, per-port link stats); ``healthy`` / ``dead_links`` run the
  fabric degraded, unreachable traffic culled into ``lost_to_failure``.
* ``dense`` — the differentiable path: the routing table applied as a
  scatter-add of float spike values into float delay rings (infinite
  capacity), per step, never blocked.  It carries surrogate gradients
  and is the event path's oracle.

:func:`run_plastic` threads STDP through the same block body: the
crossbar learns from the delivered input spikes (pre) and the output
spikes (post), updated every substep.

Telemetry (``telemetry=True`` or a :class:`repro_torch.obs.MetricsConfig`)
threads a :class:`repro_torch.obs.MetricsCarry` through the run in
``NetworkState.metrics``, folded in after every fabric call with no host
sync; the spike path never reads it, so a run is the same with it on or
off.  The dense path has no fabric and folds nothing in.

The shard forms (:func:`shard_step`, :func:`shard_superstep`,
:func:`shard_pipeline_block`, :func:`shard_flush_pending`) run the same
block body on a rank of a ``torch.distributed`` device mesh, the
exchange a real collective (:func:`shard_fabric`).  A rank holds a
contiguous block of ``n_local = n_chips // world`` chips on the leading
axis (rank r: global chips ``[r * n_local, (r + 1) * n_local)``), cut
from full trees by :func:`shard_slice`; the reference holds one chip per
device, the ``n_local == 1`` case, and one GPU runs ``world == 1`` with
every chip on its rank.  Telemetry is not folded in on the shard forms,
as in the reference: ``state.metrics`` passes through.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.core import delays as dl
from repro_torch.core import events as ev
from repro_torch.core import fabric as fb
from repro_torch.core import pulse_comm as pc
from repro_torch.core import routing as rt
from repro_torch.core import topology as tpo
from repro_torch.core import transport as tp
from repro_torch.kernels import common as kc
from repro_torch.obs import metrics as obm
from repro_torch.obs.trace import phase_scope
from repro_torch.snn import neuron as nr
from repro_torch.snn import stdp as sd
from repro_torch.snn import synapse as sy

I32 = torch.int32

__all__ = ["NetworkConfig", "NetworkParams", "NetworkState", "StepRecord",
           "local_fabric", "shard_fabric", "init_params", "init_state",
           "dense_route", "step", "run", "run_plastic", "shard_step",
           "shard_superstep", "shard_pipeline_block", "shard_flush_pending",
           "shard_slice"]


@dataclasses.dataclass(frozen=True)
class NetworkConfig:
    comm: pc.PulseCommConfig
    neuron_model: str = "lif"          # "lif" | "adex"
    comm_mode: str = "event"
    record_voltage: bool = True
    flow: fb.FlowControlConfig | None = None
    topology: tpo.Topology | None = None     # switched network (None: dense)
    pipeline: bool = False
    healthy: Any = None                      # alive chips (indices / mask)
    dead_links: tuple = ()                   # cut (chip, port) pairs
    telemetry: Any = None                    # True or obs.MetricsConfig

    def __post_init__(self):
        if self.neuron_model not in ("lif", "adex"):
            raise ValueError(self.neuron_model)
        if self.comm_mode not in ("event", "dense"):
            raise ValueError(self.comm_mode)
        if self.pipeline and self.comm_mode != "event":
            raise ValueError(
                "pipeline=True overlaps the event path's exchange; the "
                "dense comm_mode has no exchange to pipeline")
        if self.topology is not None:
            if not isinstance(self.topology, tpo.Topology):
                raise TypeError(f"topology must be a Topology, got "
                                f"{type(self.topology).__name__}")
            if self.topology.n_chips != self.comm.n_chips:
                raise ValueError(
                    f"topology has {self.topology.n_chips} chips, comm "
                    f"config {self.comm.n_chips}")
        if not (self.telemetry in (None, False, True) or isinstance(
                self.telemetry, obm.MetricsConfig)):
            raise TypeError(f"telemetry must be True or an obs."
                            f"MetricsConfig, got "
                            f"{type(self.telemetry).__name__}")


class NetworkParams(NamedTuple):
    crossbar: sy.Crossbar        # w: [n_chips, n_inputs, n_neurons]
    neuron: Any                  # LIFParams/AdExParams, [n_chips, n]
    table: rt.RoutingTable       # [n_chips, n_neurons, K]


class NetworkState(NamedTuple):
    neuron: Any                  # LIFState/AdExState, [n_chips, n]
    ring: dl.DelayRing           # ring [n_chips, D, n_inputs] (f32 in dense
                                 # mode), now [n_chips]
    t: torch.Tensor              # int32[] simulation step
    flow: Any = None             # credit state when cfg.flow is set
    merge: Any = None            # merge queue (full mode, merge_rate > 0)
    sendq: Any = None            # send queue (flow.retransmit_depth > 0)
    pending: Any = None          # in-flight block (cfg.pipeline)
    metrics: Any = None          # obs.MetricsCarry (cfg.telemetry)


class StepRecord(NamedTuple):
    spikes: torch.Tensor         # [T, n_chips, n_neurons] (f32 0/1)
    voltage: torch.Tensor        # [T, n_chips, n_neurons]
    stats: pc.CommStats          # fields [T, n_chips, ...]


def _neuron_fns(cfg: NetworkConfig):
    if cfg.neuron_model == "lif":
        return nr.lif_step, nr.lif_init
    return nr.adex_step, nr.adex_init


def local_fabric(cfg: NetworkConfig, *, device="cuda") -> fb.PulseFabric:
    """The fabric of the single-device forms: routed through
    ``cfg.topology`` when one is set, degraded by ``cfg.healthy`` /
    ``cfg.dead_links``."""
    transport = cfg.topology if cfg.topology is not None else "local"
    return fb.PulseFabric(cfg.comm, transport=transport, flow=cfg.flow,
                          healthy=cfg.healthy, dead_links=cfg.dead_links,
                          device=device)


def init_params(generator: torch.Generator, cfg: NetworkConfig, *,
                table: rt.RoutingTable | None = None,
                weight_scale: float = 0.3, device="cuda") -> NetworkParams:
    """Random crossbars (and a random LUT unless ``table`` is given) drawn
    from a CPU ``generator``, placed on ``device``."""
    device = kc.resolve_device(device)
    c = cfg.comm
    xb = sy.init_crossbar(generator, c.n_inputs_per_chip, c.neurons_per_chip,
                          scale=weight_scale, batch_shape=(c.n_chips,),
                          device=device)
    make = nr.lif_params if cfg.neuron_model == "lif" else nr.adex_params
    one = make(c.neurons_per_chip, device=device)
    nparams = type(one)(*(x.expand((c.n_chips,) + x.shape).contiguous()
                          for x in one))
    if table is None:
        table = rt.random_table(generator, c.neurons_per_chip, c.n_chips,
                                fanout=c.fanout, max_delay=c.ring_depth // 2)
    if table.dest_chip.dim() == 2:   # one shared LUT for every chip
        table = rt.RoutingTable(*(
            x.expand((c.n_chips,) + x.shape) for x in table))
    table = rt.RoutingTable(*(x.to(device).contiguous() for x in table))
    return NetworkParams(crossbar=xb, neuron=nparams, table=table)


def _metrics_cfg(cfg: NetworkConfig) -> obm.MetricsConfig | None:
    """``cfg.telemetry`` as a MetricsConfig (None: telemetry off).  An
    unset ``link_capacity`` is filled from the topology's
    ``link_bandwidth``, so the link utilization EMA is a ratio wherever
    the fabric bounds its links."""
    t = cfg.telemetry
    if t is None or t is False:
        return None
    mcfg = obm.MetricsConfig() if t is True else t
    if mcfg.link_capacity == 0 and cfg.topology is not None \
            and cfg.topology.link_bandwidth > 0:
        mcfg = dataclasses.replace(mcfg,
                                   link_capacity=cfg.topology.link_bandwidth)
    return mcfg


def _metrics_update(cfg: NetworkConfig, fabric: fb.PulseFabric,
                    metrics: Any, stats: pc.CommStats, *, merge: Any = None,
                    pending: Any = None) -> Any:
    """Fold one fabric call's stats into the carry (nothing when
    telemetry is off, on the dense path, which has no fabric, or on the
    shard forms, whose stats hold one rank's chips)."""
    if metrics is None or cfg.comm_mode != "event" or fabric.sharded:
        return metrics
    with phase_scope("obs/metrics_update"):
        return obm.metrics_update(_metrics_cfg(cfg), metrics, stats,
                                  merge=merge, pending=pending)


def init_state(cfg: NetworkConfig, params: NetworkParams, *,
               device="cuda") -> NetworkState:
    device = kc.resolve_device(device)
    c = cfg.comm
    _, ninit = _neuron_fns(cfg)
    fabric = local_fabric(cfg, device=device)
    mcfg = _metrics_cfg(cfg)
    metrics = None
    if mcfg is not None:
        n_ports = cfg.topology.n_ports if cfg.topology is not None else 1
        metrics = obm.metrics_init(mcfg, c.n_chips, n_ports, device=device)
    return NetworkState(
        neuron=ninit(params.neuron),
        ring=dl.init(c.ring_depth, c.n_inputs_per_chip,
                     dtype=(torch.float32 if cfg.comm_mode == "dense"
                            else I32),
                     batch_shape=(c.n_chips,), device=device),
        t=torch.zeros((), dtype=I32, device=device),
        flow=fabric.init_flow(), merge=fabric.init_merge(),
        sendq=fabric.init_sendq(),
        pending=fabric.init_pending() if cfg.pipeline else None,
        metrics=metrics)


def dense_route(cfg: pc.PulseCommConfig, spikes: torch.Tensor,
                table: rt.RoutingTable, ring: dl.DelayRing,
                t: torch.Tensor) -> dl.DelayRing:
    """Apply the routing table as a differentiable scatter-add of spike
    values ``[n_chips, n_neurons]`` into the destination rings at slot
    ``(t + delay) mod D`` (infinite capacity).  Delays outside ``[1, D]``
    deliver nothing; a destination chip follows the reference's scatter
    rule: a negative index wraps once, then an index out of range drops."""
    n_chips = ring.ring.shape[0]
    d = cfg.ring_depth
    vals = (spikes[:, :, None] * table.valid.to(spikes.dtype)).reshape(-1)
    delay = table.delay.reshape(-1)
    chip = table.dest_chip.reshape(-1).long()
    chip = torch.where(chip < 0, chip + n_chips, chip)
    keep = (delay >= 1) & (delay <= d) & (chip >= 0) & (chip < n_chips)
    slot = torch.remainder(t + delay, d).long()
    addr = table.dest_addr.reshape(-1).clamp(
        0, cfg.n_inputs_per_chip - 1).long()
    new = ring.ring.index_put(
        (torch.where(keep, chip, 0), slot, addr),
        torch.where(keep, vals, 0.0).to(ring.ring.dtype), accumulate=True)
    return dl.DelayRing(ring=new, now=ring.now)


def _zero_stats(c: pc.PulseCommConfig, b: int, device) -> pc.CommStats:
    """The dense path's stats for a block of ``b`` steps: it has no
    fabric, so every counter is 0 (one link port, with or without a
    topology, as the reference's)."""
    z = torch.zeros((b, c.n_chips), dtype=I32, device=device)
    link = torch.zeros((b, c.n_chips, 1), dtype=I32, device=device)
    return pc.CommStats(
        sent=z, overflow=z, merge_dropped=z, expired=z, stalled=z,
        utilization=torch.zeros((b, c.n_chips), dtype=torch.float32,
                                device=device),
        wire_bytes=z,
        traffic=torch.zeros((b, c.n_chips, c.n_chips), dtype=I32,
                            device=device),
        link_words=link, link_backlog=link, lost_to_failure=z)


def _block(cfg: NetworkConfig, fabric: fb.PulseFabric, params: NetworkParams,
           state: NetworkState, ext_block: torch.Tensor, w: torch.Tensor,
           stdp_cfg: sd.STDPConfig | None = None,
           stdp_state: sd.STDPState | None = None):
    """One block of B substeps of [pop ring, crossbar, dynamics, (STDP),
    spikes -> events (event mode) or dense route (dense mode)], then, in
    event mode, one fabric superstep (or pipelined stage, whose stats are
    the previous block's) at the block-start clock.  Returns ``(state,
    spikes[B, ...], voltage[B, ...], stats, w, stdp_state)``."""
    c = cfg.comm
    b = ext_block.shape[0]
    dense = cfg.comm_mode == "dense"
    nstep, _ = _neuron_fns(cfg)
    nstate, ring = state.neuron, state.ring
    ebs, spikes, volts = [], [], []
    for k in range(b):
        ring, in_spikes = dl.pop_current(ring)
        total_in = in_spikes.to(torch.float32) + ext_block[k]
        nstate, spk = nstep(nstate, sy.currents(sy.Crossbar(w=w), total_in),
                            params.neuron)
        if stdp_cfg is not None:
            stdp_state, w = sd.step(stdp_cfg, stdp_state, total_in, spk, w)
        if dense:
            ring = dense_route(c, spk, params.table, ring, state.t + k)
        else:
            ebs.append(ev.from_spikes(spk > 0.5, state.t + k,
                                      c.event_capacity)[0])
        ring = dl.tick(ring)
        spikes.append(spk)
        volts.append(nstate.v if cfg.record_voltage
                     else torch.zeros_like(nstate.v))
    if dense:
        stats = _zero_stats(c, b, ring.ring.device)
        carries = dict(flow=state.flow, merge=state.merge,
                       sendq=state.sendq, pending=state.pending,
                       metrics=state.metrics)
    else:
        events = ev.EventBuffer(*(torch.stack(x) for x in zip(*ebs)))
        ring0 = dl.DelayRing(ring=ring.ring, now=ring.now - b)
        if cfg.pipeline:
            res = fabric.pipeline_block(events, params.table, ring0,
                                        state.flow, state.merge, state.sendq,
                                        state.pending)
        else:
            res = fabric.superstep(events, params.table, ring0, state.flow,
                                   state.merge, state.sendq)
        ring = dl.DelayRing(ring=res.ring.ring, now=res.ring.now + b)
        stats = res.stats
        carries = dict(flow=res.flow, merge=res.merge, sendq=res.sendq,
                       pending=res.pending, metrics=_metrics_update(
                           cfg, fabric, state.metrics, stats, merge=res.merge,
                           pending=res.pending if cfg.pipeline else None))
    state = NetworkState(neuron=nstate, ring=ring, t=state.t + b,
                         **carries)
    return (state, torch.stack(spikes), torch.stack(volts), stats, w,
            stdp_state)


def _check_device(params: NetworkParams, device: torch.device):
    if params.crossbar.w.device != device:
        raise ValueError(f"params lie on {params.crossbar.w.device}, run on "
                         f"{device}")


def step(cfg: NetworkConfig, params: NetworkParams, state: NetworkState,
         ext_input: torch.Tensor, *, device="cuda"
         ) -> tuple[NetworkState, StepRecord]:
    """One step (event mode needs ``comm.superstep == 1`` and the serial
    schedule); ``ext_input [n_chips, n_inputs]``.  The record has no time
    axis."""
    if _block_length(cfg) != 1 or cfg.pipeline:
        raise ValueError(
            f"comm.superstep={cfg.comm.superstep}, pipeline={cfg.pipeline}:"
            " the exchange schedule is defined over whole blocks; drive "
            "the network with run(), which scans whole blocks")
    state, rec = run(cfg, params, state, torch.as_tensor(ext_input)[None],
                     device=device)
    return state, StepRecord(spikes=rec.spikes[0], voltage=rec.voltage[0],
                             stats=pc.CommStats(*(x[0] for x in rec.stats)))


def _block_length(cfg: NetworkConfig) -> int:
    """Steps per block: the superstep B in event mode; the dense path runs
    per step."""
    return cfg.comm.superstep if cfg.comm_mode == "event" else 1


def _run(cfg, params, state, ext_inputs, device, stdp_cfg=None,
         stdp_state=None):
    """The block loop of :func:`run` and :func:`run_plastic`."""
    device = kc.resolve_device(device)
    _check_device(params, device)
    b = _block_length(cfg)
    ext_inputs = torch.as_tensor(ext_inputs, dtype=torch.float32,
                                 device=device)
    t_total = ext_inputs.shape[0]
    if t_total % b:
        raise ValueError(f"run length T={t_total} must be a multiple of "
                         f"comm.superstep={b}")
    fabric = local_fabric(cfg, device=device)
    flow, merge, sendq = fabric._init_missing(state.flow, state.merge,
                                              state.sendq)
    state = state._replace(flow=flow, merge=merge, sendq=sendq)
    if cfg.pipeline and state.pending is None:
        state = state._replace(pending=fabric.init_pending())
    w = params.crossbar.w
    spikes, volts, stats = [], [], []
    for t in range(0, t_total, b):
        state, spk, volt, st, w, stdp_state = _block(
            cfg, fabric, params, state, ext_inputs[t:t + b], w, stdp_cfg,
            stdp_state)
        spikes.append(spk)
        volts.append(volt)
        stats.append(st)
    if cfg.pipeline:
        # The epilogue: drain the carried last block; each stage reported
        # the block before it, so drop the prologue's and append this.
        # Telemetry folds the flushed block in too, so its totals close
        # (the carry saw the prologue's zero block first).
        res = fabric.flush_pending(state.ring, state.pending, state.flow,
                                   state.merge, state.sendq)
        stats = stats[1:] + [res.stats]
        state = state._replace(
            ring=res.ring, merge=res.merge, pending=res.pending,
            metrics=_metrics_update(cfg, fabric, state.metrics, res.stats,
                                    merge=res.merge, pending=res.pending))
    rec = StepRecord(spikes=torch.cat(spikes), voltage=torch.cat(volts),
                     stats=pc.CommStats(*(torch.cat(x) for x in zip(*stats))))
    return state, rec, w, stdp_state


def run(cfg: NetworkConfig, params: NetworkParams, state: NetworkState,
        ext_inputs: torch.Tensor, *, device="cuda"
        ) -> tuple[NetworkState, StepRecord]:
    """Run T steps on ``device`` (in event mode T a multiple of
    ``comm.superstep``); ``ext_inputs [T, n_chips, n_inputs]``.  Records
    are stacked along time.  A pipelined run ends with the carry's flush
    (``state.pending`` comes back empty)."""
    state, rec, _, _ = _run(cfg, params, state, ext_inputs, device)
    return state, rec


def run_plastic(cfg: NetworkConfig, params: NetworkParams,
                state: NetworkState, ext_inputs: torch.Tensor,
                stdp_cfg: sd.STDPConfig | None = None, *, device="cuda"):
    """On-chip learning run: the crossbar weights evolve under STDP
    (BSS-2's correlation sensors and PPU loop), per step or in B-step
    blocks as :func:`run`.  Returns ``(params, state, record,
    stdp_state)``; the STDP traces are ``[n_chips, n_inputs]`` and
    ``[n_chips, n_neurons]``."""
    c = cfg.comm
    sstate = sd.init(c.n_inputs_per_chip, c.neurons_per_chip,
                     batch_shape=(c.n_chips,),
                     device=kc.resolve_device(device))
    state, rec, w, sstate = _run(cfg, params, state, ext_inputs, device,
                                 stdp_cfg or sd.STDPConfig(), sstate)
    return (params._replace(crossbar=sy.Crossbar(w=w)), state, rec, sstate)


def shard_fabric(cfg: NetworkConfig, axis: str | tuple[str, ...], *,
                 mesh) -> fb.PulseFabric:
    """The fabric of the shard forms over ``axis`` of ``mesh`` (None: a
    ``("chip",)`` mesh over the world, on the card): routed through
    ``cfg.topology`` when one is set, otherwise the dense
    :class:`repro_torch.core.transport.DistributedTransport`; flow
    control and the health mask passed through.  Its device is the
    mesh's.  Raises ``RuntimeError`` without a process group."""
    if mesh is None:
        from repro_torch.launch import mesh as ms
        mesh = ms.make_chip_mesh()
    if cfg.topology is not None:
        transport = cfg.topology.transport(axis, mesh=mesh)
        device = transport.base.device
    else:
        transport = tp.DistributedTransport(mesh=mesh, axis=axis,
                                            n_chips=cfg.comm.n_chips)
        device = transport.device
    return fb.PulseFabric(cfg.comm, transport=transport, flow=cfg.flow,
                          healthy=cfg.healthy, dead_links=cfg.dead_links,
                          device=device)


def shard_slice(tree: Any, rank: int, n_local: int) -> Any:
    """Cut a full params or state tree (every chip on the leading axis) to
    rank ``rank``'s ``n_local`` chips: every tensor's leading axis, the
    pipeline carry's block stats ``[B, n_chips, ...]`` on their chip
    axis; the clock and other scalars, and the telemetry carry, stay
    whole."""
    rows = slice(rank * n_local, (rank + 1) * n_local)

    def cut(x):
        if x is None:
            return None
        if isinstance(x, torch.Tensor):
            return x if x.dim() == 0 else x[rows]
        if isinstance(x, pc.PipelineCarry):
            return pc.PipelineCarry(
                words=x.words[rows], link=cut(x.link),
                inject=pc.InjectStats(*(v[:, rows].contiguous()
                                        for v in x.inject)),
                t0=x.t0[rows], valid=x.valid[rows])
        if isinstance(x, NetworkState):
            return x._replace(**{f: cut(getattr(x, f)) for f in x._fields
                                 if f != "metrics"})
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*(cut(v) for v in x))
        if isinstance(x, tuple):
            return tuple(cut(v) for v in x)
        return x

    return cut(tree)


def _shard_block(cfg: NetworkConfig, axis, params: NetworkParams,
                 state: NetworkState, ext_block, mesh):
    """One block of the shard forms through :func:`_block`."""
    if cfg.comm_mode != "event":
        raise ValueError("the dense comm_mode needs every chip on one "
                         "device (the local forms)")
    fabric = shard_fabric(cfg, axis, mesh=mesh)
    if params.crossbar.w.shape[0] != fabric.n_local:
        raise ValueError(f"params hold {params.crossbar.w.shape[0]} chips, "
                         f"this rank {fabric.n_local} (see shard_slice)")
    _check_device(params, fabric.device)
    ext = torch.as_tensor(ext_block, dtype=torch.float32,
                          device=fabric.device)
    state, spikes, volts, stats, _, _ = _block(cfg, fabric, params, state,
                                               ext, params.crossbar.w)
    return state, StepRecord(spikes=spikes, voltage=volts, stats=stats)


def shard_step(cfg: NetworkConfig, axis: str | tuple[str, ...],
               params: NetworkParams, state: NetworkState,
               ext_input: torch.Tensor, *, mesh
               ) -> tuple[NetworkState, StepRecord]:
    """One step on this rank (``comm.superstep == 1``, serial schedule):
    shard-local params and state (``n_local`` chips, see
    :func:`shard_slice`), ``ext_input [n_local, n_inputs]``.  The same
    block body as :func:`step`, the exchange a collective over ``axis``
    of ``mesh``.  The record has no time axis."""
    if _block_length(cfg) != 1:
        raise ValueError(
            f"comm.superstep={cfg.comm.superstep} batches the exchange "
            "over B-step blocks: call shard_superstep(cfg, axis, params, "
            "state, ext_block[B, n_local, n_inputs], mesh=) instead")
    if cfg.pipeline:
        raise ValueError("pipeline=True: drive the pipelined schedule "
                         "with shard_pipeline_block and shard_flush_pending")
    state, rec = _shard_block(cfg, axis, params, state,
                              torch.as_tensor(ext_input)[None], mesh)
    return state, StepRecord(spikes=rec.spikes[0], voltage=rec.voltage[0],
                             stats=pc.CommStats(*(x[0] for x in rec.stats)))


def shard_superstep(cfg: NetworkConfig, axis: str | tuple[str, ...],
                    params: NetworkParams, state: NetworkState,
                    ext_block: torch.Tensor, *, mesh
                    ) -> tuple[NetworkState, StepRecord]:
    """One B-step block on this rank: B substeps of neuron dynamics, then
    one exchange for the block (one collective per B steps);
    ``ext_block [B, n_local, n_inputs]``.  Records carry a leading [B]
    axis.  With ``cfg.pipeline`` this is a pipelined stage, as
    :func:`shard_pipeline_block`."""
    return _shard_block(cfg, axis, params, state, ext_block, mesh)


def shard_pipeline_block(cfg: NetworkConfig, axis: str | tuple[str, ...],
                         params: NetworkParams, state: NetworkState,
                         ext_block: torch.Tensor, *, mesh
                         ) -> tuple[NetworkState, StepRecord]:
    """One pipelined stage on this rank (needs ``cfg.pipeline``): issues
    this block's exchange and drains the previous block from
    ``state.pending`` (an empty carry when None).  The record's
    ``stats`` describe the previous block; finish the stream with
    :func:`shard_flush_pending` and realign as :func:`run` does."""
    if not (cfg.pipeline and cfg.comm_mode == "event"):
        raise ValueError("shard_pipeline_block needs cfg.pipeline=True "
                         "(event comm_mode)")
    return _shard_block(cfg, axis, params, state, ext_block, mesh)


def shard_flush_pending(cfg: NetworkConfig, axis: str | tuple[str, ...],
                        state: NetworkState, *, mesh
                        ) -> tuple[NetworkState, pc.CommStats]:
    """The pipelined epilogue on this rank: drain the in-flight carry.
    Returns the state (empty carry) and the flushed block's stats
    (leading [B] axis)."""
    fabric = shard_fabric(cfg, axis, mesh=mesh)
    res = fabric.flush_pending(state.ring, state.pending, state.flow,
                               state.merge, state.sendq)
    return state._replace(ring=res.ring, merge=res.merge,
                          pending=res.pending), res.stats
