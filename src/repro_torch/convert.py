"""Carry a network's or a language model's weights and state across
from the JAX package.

``params_from_jax`` / ``state_from_jax`` / ``stdp_state_from_jax`` take
the JAX package's ``NetworkParams`` / ``NetworkState`` / ``STDPState``
(any array type numpy can read, fields by name) and return the port's
versions on ``device``, so both packages compute from identical weights
and state; a state taken mid-run keeps its carries (credits, send
queue, merge queue, the pipeline's in-flight block, whose link leg has the
topology's ports).  A ring keeps its dtype: int32 in event mode, float32
in dense mode.  ``topology_from_jax`` rebuilds a JAX ``Topology`` as the
port's, its pod graph included.  ``metrics_from_jax`` takes a telemetry
carry (``MetricsCarry`` with its flight ring), field for field in the
same layout.  ``lm_params_from_jax`` maps a language model's parameter
tree (nested dicts) leaf by leaf, each keeping its dtype.  Nothing here
imports JAX: every leaf goes through ``numpy.asarray``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import delays as dl
from repro_torch.core import flowcontrol as fc
from repro_torch.core import merge as mg
from repro_torch.core import pulse_comm as pc
from repro_torch.core import routing as rt
from repro_torch.core import topology as tpo
from repro_torch.kernels import common as kc
from repro_torch.obs import metrics as obm
from repro_torch.snn import network as net
from repro_torch.snn import neuron as nr
from repro_torch.snn import stdp as sd
from repro_torch.snn import synapse as sy


def tensor(x, device, dtype=None) -> torch.Tensor:
    """A numpy-readable array as a contiguous tensor on ``device``."""
    return torch.as_tensor(np.array(x), dtype=dtype, device=device)


def _fields(cls, obj, device):
    return cls(*(tensor(getattr(obj, f), device) for f in cls._fields))


def table_from_jax(table, *, device="cuda") -> rt.RoutingTable:
    return _fields(rt.RoutingTable, table, kc.resolve_device(device))


def params_from_jax(params, *, device="cuda") -> net.NetworkParams:
    """Crossbar ``w``, neuron params (LIF or AdEx, told apart by their
    fields) and routing table."""
    device = kc.resolve_device(device)
    cls = nr.LIFParams if hasattr(params.neuron, "tau_m") else nr.AdExParams
    return net.NetworkParams(
        crossbar=sy.Crossbar(w=tensor(params.crossbar.w, device)),
        neuron=_fields(cls, params.neuron, device),
        table=table_from_jax(params.table, device=device))


def topology_from_jax(topo) -> tpo.Topology:
    """A JAX ``Topology`` (or anything with its fields) as the port's."""
    kw = {f.name: getattr(topo, f.name)
          for f in tpo.Topology.__dataclass_fields__.values()}
    kw["dims"] = tuple(int(k) for k in kw["dims"])
    if kw["pod_graph"] is not None:
        kw["pod_graph"] = topology_from_jax(kw["pod_graph"])
    return tpo.Topology(**kw)


def pending_from_jax(pending, *, device="cuda") -> pc.PipelineCarry:
    """The JAX local fabric's pipeline carry, its fields batched over a
    leading chip axis, as the port's: the block's stats go from ``[n_chips,
    B, ...]`` to the port's ``[B, n_chips, ...]``; the link leg is
    ``[n_chips, n_ports]`` in both."""
    device = kc.resolve_device(device)
    inject = pc.InjectStats(*(
        tensor(getattr(pending.inject, f), device).transpose(0, 1)
        .contiguous() for f in pc.InjectStats._fields))
    return pc.PipelineCarry(
        words=tensor(pending.words, device),
        link=_fields(pc.LinkStats, pending.link, device), inject=inject,
        t0=tensor(pending.t0, device, torch.int32),
        valid=tensor(pending.valid, device, torch.bool))


def metrics_from_jax(metrics, *, device="cuda") -> obm.MetricsCarry:
    """The JAX telemetry carry as the port's (the same fields, shapes and
    dtypes: int32 counters, float32 EMAs, the flight ring)."""
    device = kc.resolve_device(device)
    return obm.MetricsCarry(
        *(tensor(getattr(metrics, f), device)
          for f in obm.MetricsCarry._fields[:-1]),
        flight=_fields(obm.FlightRing, metrics.flight, device))


def state_from_jax(state, *, device="cuda") -> net.NetworkState:
    """Neuron state, delay ring and clock, step counter and the carries
    (credit state, merge queue, send queue, pipeline carry, telemetry)
    where the state has them."""
    device = kc.resolve_device(device)
    cls = nr.LIFState if not hasattr(state.neuron, "w") else nr.AdExState
    carry = lambda name, fn: (None if getattr(state, name, None) is None
                              else fn(getattr(state, name)))
    return net.NetworkState(
        neuron=_fields(cls, state.neuron, device),
        ring=_fields(dl.DelayRing, state.ring, device),
        t=tensor(state.t, device, torch.int32),
        flow=carry("flow", lambda x: _fields(fc.RingState, x, device)),
        merge=carry("merge", lambda x: mg.MergeBuffer(
            words=tensor(x.words, device))),
        sendq=carry("sendq", lambda x: _fields(fc.SendQueue, x, device)),
        pending=carry("pending",
                      lambda x: pending_from_jax(x, device=device)),
        metrics=carry("metrics",
                      lambda x: metrics_from_jax(x, device=device)))


def stdp_state_from_jax(state, *, device="cuda") -> sd.STDPState:
    """STDP traces ``x_pre [n_chips, n_inputs]``, ``x_post [n_chips,
    n_neurons]``."""
    return _fields(sd.STDPState, state, kc.resolve_device(device))


def lm_params_from_jax(params, *, device="cuda") -> dict:
    """A language model's parameter tree (nested dicts of arrays) as the
    same tree of tensors on ``device``, each leaf in its own dtype.
    numpy has no bfloat16: such a leaf goes through a float32 array (an
    exact widening) and back to ``torch.bfloat16``."""
    device = kc.resolve_device(device)

    def one(x):
        if isinstance(x, dict):
            return {k: one(v) for k, v in x.items()}
        arr = np.asarray(x)
        if arr.dtype.name == "bfloat16":
            return tensor(arr.astype(np.float32), device).to(torch.bfloat16)
        return tensor(arr, device)

    return one(params)
