"""Multi-chip spiking network on the pulse fabric, event mode, serial
schedule (port of ``repro.snn.network``).

Per step t, chips on a leading tensor axis: pop delay-ring slot t, add
the external input, crossbar product, neuron dynamics, spikes -> events.
Every B steps (``comm.superstep``) the block's events go through
:meth:`repro_torch.core.fabric.PulseFabric.superstep` at the block-start
clock — one exchange per block.  Admission only puts events on the wire
with more slack than their remaining deferral, so no event injected in a
block is popped inside it and the schedule equals the per-step one.

The dense differentiable path, the pipelined schedule, flow control,
topologies, health masks, telemetry, the shard forms and ``run_plastic``
are later slices of the port and raise ``NotImplementedError``.
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
from repro_torch.kernels import common as kc
from repro_torch.snn import neuron as nr
from repro_torch.snn import synapse as sy

I32 = torch.int32


@dataclasses.dataclass(frozen=True)
class NetworkConfig:
    comm: pc.PulseCommConfig
    neuron_model: str = "lif"          # "lif" | "adex"
    comm_mode: str = "event"
    record_voltage: bool = True
    flow: Any = None
    topology: Any = None
    pipeline: bool = False
    healthy: Any = None
    dead_links: tuple = ()
    telemetry: Any = None

    def __post_init__(self):
        if self.neuron_model not in ("lif", "adex"):
            raise ValueError(self.neuron_model)
        if self.comm_mode not in ("event", "dense"):
            raise ValueError(self.comm_mode)
        unported = {
            "comm_mode='dense'": self.comm_mode == "dense",
            "pipeline=True": self.pipeline,
            "flow control": self.flow is not None,
            "a topology": self.topology is not None,
            "healthy / dead_links": (self.healthy is not None
                                     or bool(self.dead_links)),
            "telemetry": self.telemetry not in (None, False),
        }
        for what, asked in unported.items():
            if asked:
                raise NotImplementedError(f"{what} is not ported yet")


class NetworkParams(NamedTuple):
    crossbar: sy.Crossbar        # w: [n_chips, n_inputs, n_neurons]
    neuron: Any                  # LIFParams/AdExParams, [n_chips, n]
    table: rt.RoutingTable       # [n_chips, n_neurons, K]


class NetworkState(NamedTuple):
    neuron: Any                  # LIFState/AdExState, [n_chips, n]
    ring: dl.DelayRing           # ring [n_chips, D, n_inputs], now [n_chips]
    t: torch.Tensor              # int32[] simulation step
    merge: Any = None            # merge queue (full mode, merge_rate > 0)


class StepRecord(NamedTuple):
    spikes: torch.Tensor         # [T, n_chips, n_neurons] (f32 0/1)
    voltage: torch.Tensor        # [T, n_chips, n_neurons]
    stats: pc.CommStats          # fields [T, n_chips, ...]


def _neuron_fns(cfg: NetworkConfig):
    if cfg.neuron_model == "lif":
        return nr.lif_step, nr.lif_init
    return nr.adex_step, nr.adex_init


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


def init_state(cfg: NetworkConfig, params: NetworkParams, *,
               device="cuda") -> NetworkState:
    device = kc.resolve_device(device)
    c = cfg.comm
    _, ninit = _neuron_fns(cfg)
    fabric = fb.PulseFabric(c, device=device)
    return NetworkState(
        neuron=ninit(params.neuron),
        ring=dl.init(c.ring_depth, c.n_inputs_per_chip,
                     batch_shape=(c.n_chips,), device=device),
        t=torch.zeros((), dtype=I32, device=device),
        merge=fabric.init_merge())


def _block(cfg: NetworkConfig, fabric: fb.PulseFabric, params: NetworkParams,
           state: NetworkState, ext_block: torch.Tensor):
    """One B-step block: B substeps of [pop ring, crossbar, dynamics,
    spikes -> events], then one fabric superstep at the block-start
    clock.  Returns ``(state, spikes[B, ...], voltage[B, ...], stats)``."""
    c = cfg.comm
    b = ext_block.shape[0]
    nstep, _ = _neuron_fns(cfg)
    nstate, ring = state.neuron, state.ring
    ebs, spikes, volts = [], [], []
    for k in range(b):
        ring, in_spikes = dl.pop_current(ring)
        total_in = in_spikes.to(torch.float32) + ext_block[k]
        nstate, spk = nstep(nstate, sy.currents(params.crossbar, total_in),
                            params.neuron)
        ebs.append(ev.from_spikes(spk > 0.5, state.t + k,
                                  c.event_capacity)[0])
        ring = dl.tick(ring)
        spikes.append(spk)
        volts.append(nstate.v if cfg.record_voltage
                     else torch.zeros_like(nstate.v))
    events = ev.EventBuffer(*(torch.stack(x) for x in zip(*ebs)))
    ring0 = dl.DelayRing(ring=ring.ring, now=ring.now - b)
    res = fabric.superstep(events, params.table, ring0, None, state.merge)
    state = NetworkState(
        neuron=nstate, ring=dl.DelayRing(ring=res.ring.ring,
                                         now=res.ring.now + b),
        t=state.t + b, merge=res.merge)
    return state, torch.stack(spikes), torch.stack(volts), res.stats


def _check_device(params: NetworkParams, device: torch.device):
    if params.crossbar.w.device != device:
        raise ValueError(f"params lie on {params.crossbar.w.device}, run on "
                         f"{device}")


def step(cfg: NetworkConfig, params: NetworkParams, state: NetworkState,
         ext_input: torch.Tensor, *, device="cuda"
         ) -> tuple[NetworkState, StepRecord]:
    """One step (``comm.superstep == 1``); ``ext_input [n_chips,
    n_inputs]``.  The record has no time axis."""
    if cfg.comm.superstep != 1:
        raise ValueError(
            f"comm.superstep={cfg.comm.superstep}: drive the network with "
            "run(), which scans whole blocks")
    state, rec = run(cfg, params, state, torch.as_tensor(ext_input)[None],
                     device=device)
    return state, StepRecord(spikes=rec.spikes[0], voltage=rec.voltage[0],
                             stats=pc.CommStats(*(x[0] for x in rec.stats)))


def run(cfg: NetworkConfig, params: NetworkParams, state: NetworkState,
        ext_inputs: torch.Tensor, *, device="cuda"
        ) -> tuple[NetworkState, StepRecord]:
    """Run T steps (T a multiple of ``comm.superstep``) on ``device``;
    ``ext_inputs [T, n_chips, n_inputs]``.  Records are stacked along
    time."""
    device = kc.resolve_device(device)
    _check_device(params, device)
    b = cfg.comm.superstep
    ext_inputs = torch.as_tensor(ext_inputs, dtype=torch.float32,
                                 device=device)
    t_total = ext_inputs.shape[0]
    if t_total % b:
        raise ValueError(f"run length T={t_total} must be a multiple of "
                         f"comm.superstep={b}")
    fabric = fb.PulseFabric(cfg.comm, device=device)
    if fabric.merge_enabled and state.merge is None:
        state = state._replace(merge=fabric.init_merge())
    spikes, volts, stats = [], [], []
    for t in range(0, t_total, b):
        state, spk, volt, st = _block(cfg, fabric, params, state,
                                      ext_inputs[t:t + b])
        spikes.append(spk)
        volts.append(volt)
        stats.append(st)
    rec = StepRecord(spikes=torch.cat(spikes), voltage=torch.cat(volts),
                     stats=pc.CommStats(*(torch.cat(x) for x in zip(*stats))))
    return state, rec


def run_plastic(*args, **kwargs):
    raise NotImplementedError("run_plastic (STDP) is not ported yet")


def shard_step(*args, **kwargs):
    """The shard forms (one GPU per chip) come with the multi-GPU
    transport."""
    raise NotImplementedError("the shard forms are not ported yet")


shard_superstep = shard_pipeline_block = shard_flush_pending = shard_step
