"""Quickstart: a 4-chip BSS-2 network exchanging pulses over the
Extoll-like fabric, then the same network under NHTL-Extoll credit flow
control.

    PYTHONPATH=src python -m repro_torch.quickstart [--device cpu]

It runs on the card by default (the kernels) and raises without one;
``--device cpu`` runs the plain versions.  The counterpart of the JAX
package's ``examples/quickstart.py``.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import pulse_comm as pc
from repro_torch.core import routing as rt
from repro_torch.core.fabric import FlowControlConfig
from repro_torch.kernels import common as kc
from repro_torch.snn import network as net

N_CHIPS, N, T = 4, 64, 100
COMM = pc.PulseCommConfig(
    n_chips=N_CHIPS, neurons_per_chip=N, n_inputs_per_chip=N,
    event_capacity=N, bucket_capacity=16, ring_depth=16)
# A tight in-flight packet budget: withheld packets are dropped with
# explicit accounting (stats.stalled), never silently.
FLOW = FlowControlConfig(capacity=2, drain_rate=1)


def setup(device, seed: int = 0):
    """The network's params (random LUT with fan-out 2 and delays up to 6,
    random crossbars) from a CPU generator, and Poisson background input
    ``[T, n_chips, N]`` (p 0.05) from numpy."""
    cfg = net.NetworkConfig(comm=COMM, neuron_model="lif")
    gen = torch.Generator().manual_seed(seed)
    table = rt.random_table(gen, N, N_CHIPS, fanout=2, max_delay=6)
    params = net.init_params(gen, cfg, table=table, weight_scale=0.4,
                             device=device)
    ext = (np.random.default_rng(seed).random((T, N_CHIPS, N)) < 0.05
           ).astype(np.float32)
    return params, ext


def totals(rec: net.StepRecord) -> dict:
    s = rec.stats
    return dict(spikes=int(rec.spikes.sum()), sent=int(s.sent.sum()),
                overflow=int(s.overflow.sum()),
                expired=int(s.expired.sum()), stalled=int(s.stalled.sum()),
                utilization=float(s.utilization.mean()),
                wire_bytes=float(s.wire_bytes.float().mean()),
                rates=rec.spikes.mean(dim=(0, 2)).tolist())


def main(device="cuda", params=None, ext=None) -> tuple[dict, dict]:
    """Run both networks (the plain one, then under ``FLOW``) and print
    their totals; returns them.  ``params`` and ``ext`` default to
    :func:`setup`'s."""
    device = kc.resolve_device(device)
    if params is None or ext is None:
        default_params, default_ext = setup(device)
        params = default_params if params is None else params
        ext = default_ext if ext is None else ext
    out = []
    for flow in (None, FLOW):
        cfg = net.NetworkConfig(comm=COMM, neuron_model="lif", flow=flow)
        state = net.init_state(cfg, params, device=device)
        _, rec = net.run(cfg, params, state, ext, device=device)
        out.append(totals(rec))
    plain, fc = out
    print(f"total spikes on-chip      : {plain['spikes']}")
    print(f"events routed off-chip    : {plain['sent']}")
    print(f"bucket overflow (dropped) : {plain['overflow']}")
    print(f"expired in flight         : {plain['expired']}")
    print(f"mean bucket utilization   : {plain['utilization']:.3f}")
    print(f"wire bytes / step / chip  : {plain['wire_bytes']:.0f}")
    print("\nper-chip firing rates:",
          [round(r, 4) for r in plain["rates"]])
    print(f"\nwith credit flow control  : {fc['stalled']}/{fc['sent']} "
          f"events stalled at the source (back-pressure)")
    return plain, fc


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
