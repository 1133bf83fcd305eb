"""The paper's NICE-2022 demonstration on the port (``examples/
feedforward_demo.py`` of the JAX package).

A population on chip 0, driven by regular background input, projects
through the pulse fabric onto chip 1, whose neurons need two input spikes
per output spike: the inter-spike interval doubles from source to target.

    PYTHONPATH=src python -m repro_torch.demo            # on the card
    PYTHONPATH=src python -m repro_torch.demo --device cpu
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import pulse_comm as pc
from repro_torch.core import routing as rt
from repro_torch.snn import network as net

N, DELAY, T = 64, 2, 48


def setup(device):
    """Config, params, state and external input of the demo."""
    comm = pc.PulseCommConfig(
        n_chips=2, neurons_per_chip=N, n_inputs_per_chip=N,
        event_capacity=N, bucket_capacity=N, ring_depth=8)
    cfg = net.NetworkConfig(comm=comm, neuron_model="lif")
    table = rt.feedforward_table(N, src_chip=0, dst_chip=1, delay=DELAY)
    params = net.init_params(torch.Generator().manual_seed(0), cfg,
                             table=table, device=device)
    w = np.zeros((2, N, N), np.float32)
    w[0] = 1.5 * np.eye(N)   # chip 0: one external spike -> one output spike
    w[1] = 0.6 * np.eye(N)   # chip 1: needs two input spikes to fire
    params = params._replace(crossbar=params.crossbar._replace(
        w=torch.as_tensor(w, device=params.crossbar.w.device)))
    state = net.init_state(cfg, params, device=device)
    ext = np.zeros((T, 2, N), np.float32)
    ext[::4, 0, :] = 1.0     # background generator: ISI = 4 on chip 0
    return cfg, params, state, ext


def main(device="cuda") -> tuple[list[int], list[int]]:
    """Run the demo and print its report; returns the source and target
    spike times of neuron 0."""
    cfg, params, state, ext = setup(device)
    _, rec = net.run(cfg, params, state, ext, device=device)
    spikes = rec.spikes.cpu().numpy()
    v = rec.voltage.cpu().numpy()
    src_t = np.nonzero(spikes[:, 0, 0])[0]
    dst_t = np.nonzero(spikes[:, 1, 0])[0]

    print("source spikes (chip 0, neuron 0):", src_t.tolist())
    print("target spikes (chip 1, neuron 0):", dst_t.tolist())
    print(f"\nISI source = {np.diff(src_t).mean():.1f}  "
          f"ISI target = {np.diff(dst_t).mean():.1f}  (doubling expected)")
    print(f"first-spike latency = {dst_t[0] - src_t[0]} steps "
          f"(axonal delay {DELAY} + 2nd-spike wait)")
    print("\ntarget neuron membrane trace (chip 1, neuron 0):")
    for t in range(0, 24):
        bar = "#" * int(max(v[t, 1, 0], 0) * 40)
        mark = " <- spike" if spikes[t, 1, 0] > 0.5 else ""
        print(f"  t={t:2d} |{bar:<28s}| v={v[t, 1, 0]:+.2f}{mark}")
    stats = rec.stats
    print(f"\nnetwork: {int(stats.sent.sum())} events routed, "
          f"{int(stats.overflow.sum())} overflow, "
          f"{int(stats.expired.sum())} expired, "
          f"{int(stats.stalled.sum())} stalled, "
          f"mean utilization {float(stats.utilization.mean()):.2f}")
    if abs(np.diff(dst_t).mean() - 2 * np.diff(src_t).mean()) >= 1e-6:
        raise RuntimeError("ISI doubling NOT reproduced")
    print("ISI doubling REPRODUCED")
    return src_t.tolist(), dst_t.tolist()


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
