"""On-chip plasticity over the interconnect on the port (``examples/
stdp_learning.py`` of the JAX package): STDP learns which input pathway
causes postsynaptic firing while spikes cross the pulse fabric.

    PYTHONPATH=src python -m repro_torch.stdp_demo            # on the card
    PYTHONPATH=src python -m repro_torch.stdp_demo --device cpu
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import pulse_comm as pc
from repro_torch.core import routing as rt
from repro_torch.snn import network as net
from repro_torch.snn import stdp as sd

N, T = 16, 96
STDP = sd.STDPConfig(a_plus=0.03, a_minus=0.01, tau_minus=5.0)


def setup(device):
    """Config, params, state and external input of the demo."""
    comm = pc.PulseCommConfig(n_chips=2, neurons_per_chip=N,
                              n_inputs_per_chip=N, event_capacity=N,
                              bucket_capacity=N, ring_depth=8)
    cfg = net.NetworkConfig(comm=comm)
    table = rt.feedforward_table(N, src_chip=0, dst_chip=1, delay=2)
    params = net.init_params(torch.Generator().manual_seed(0), cfg,
                             table=table, device=device)
    params = params._replace(crossbar=params.crossbar._replace(
        w=torch.full((2, N, N), 0.3, device=params.crossbar.w.device)))
    state = net.init_state(cfg, params, device=device)
    ext = np.zeros((T, 2, N), np.float32)
    ext[::8, 0, :N // 2] = 3.0    # pathway A: causes firing
    ext[::8, 0, N // 2:] = 0.05   # pathway B: subthreshold noise
    return cfg, params, state, ext


def main(device="cuda") -> tuple[float, float]:
    """Run the demo and print its report; returns the mean weights of
    pathways A and B on chip 0."""
    cfg, params, state, ext = setup(device)
    new_params, _, rec, _ = net.run_plastic(cfg, params, state, ext, STDP,
                                            device=device)
    w = new_params.crossbar.w[0].cpu().numpy()
    a, b = float(w[:N // 2].mean()), float(w[N // 2:].mean())
    print(f"pathway A (causal)  mean weight: 0.300 -> {a:.3f}")
    print(f"pathway B (noise)   mean weight: 0.300 -> {b:.3f}")
    print(f"events routed chip0->chip1: {int(rec.stats.sent.sum())} "
          f"(stalled {int(rec.stats.stalled.sum())})")
    if not a > b:
        raise RuntimeError("STDP did not separate the causal pathway")
    print("STDP separated the causal pathway while pulses crossed the "
          "network.")
    return a, b


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
