#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--steps 64]

Phases, each fatal on failure:
  1. build   the CUDA kernels from ``src/repro_torch/csrc`` (nvcc, sm_90a,
             one process per source, all started together); ptxas's
             registers and spills per kernel, and no spill in the
             flash-attention instances of head size 80 and 128 (bf16 and
             float32);
  2. kernels each kernel against its plain PyTorch version on the card,
             bitwise on every output of the SNN kernels, on inputs taken
             from the first block of each path below, in every mode the
             fabric uses, and flash attention and the SSM scan at the
             serve paths' prefill shapes (each flash and scan row also
             prints its design, TFLOP/s and share of the bound, flash its
             time over SDPA's; the scan runs on the path's inputs, A per
             head, and on a general A); its time
             (CUDA events over a CUDA graph of back-to-back calls), the
             kernel's own device time (torch.profiler; the difference is
             the wrapper's tensor ops), the plain version's time (CUDA
             events), bytes, the bound at 3.35 TB/s or 67 T op/s (bf16
             flash at 989 T op/s, float32 flash in 3xTF32 at 165) and, for
             the sorts, stable ``torch.sort`` plus the gather, for flash
             attention ``scaled_dot_product_attention``.  ``bucket_pack``
             (the wafer's flush), ``lif_step`` and every case of
             ``fused_inject`` and ``fused_lif_inject`` print their launch
             plan (grid, threads, shared bytes, ptxas's registers), must
             put exactly one kernel on the card per wrapper call
             (torch.profiler), and print the host time per wrapper call
             (1,000 calls, one synchronise); beside ``lif_step``, the
             launch floor: one ``torch.add`` over the same [46, 512]
             float32, and beside ``fused_inject``, a write floor: one
             ``torch.full`` of the slab's shape with -1, each timed the
             same way.  The sorts run
             on the entry phase's merge cycle (46 x 3136 lanes; each SoA
             row prints its radix passes) and the SoA sort also on
             deadlines over the whole int32 range (4 passes).  Also the
             pipelined path's drains (rate mode, ``extra_ahead`` 8: its
             first steady stage with the gate all on, and the prologue
             with the gate all off, which must emit sentinels, keep the
             ring and the queue and expire nothing), the flow path's
             pack of one substep into column k of the slab in place (46
             rows of 512 send-queue lanes ahead of 2,048 fresh ones, its
             first and fourth substeps), and ``fused_inject`` on the
             degraded path's first block with its reach row (``lost``
             bitwise), beside the same block with a row of ones and with
             no row, and ``fused_lif_inject`` with the reach row;
  3. entry   the entry points off the network's path, counters zeroed
             first: ``merge_drain_words(use_pallas=True)`` on the first
             feedforward block's delivered words must equal
             ``fused_drain``'s rate mode (queue, words, drops);
             ``kernels.merge_sort`` on the same lanes; and
             ``fused_lif_inject`` on the feedforward cell's first block,
             whose spikes must equal the network's;
  4. wafer   ``configs/bss2.py`` as is (46 chips x 512 AdEx, fan-out 4,
             simplified, B 1): bucket_pack and fused_drain must launch and
             Σ sent == Σ (deposits + expired + overflow + merge_dropped);
  5. feedforward  the paper demo (2 x 64 LIF, fan-out 1) against its plain
             run on the CPU, then the wafer widths with fan-out 1, LIF,
             full mode, 2 buckets per chip, merge_rate 128, B 8:
             fused_inject, fused_drain and lif_step must launch;
  6. plastic ``run_plastic`` on the feedforward configuration (default
             STDPConfig): conservation, finite weights, and its first 16
             steps equal a plain run on the CPU;
  7. dense   ``comm_mode="dense"`` at the wafer widths with LIF and the
             wafer's fan-out-4 LUT: its first 16 steps equal a plain run
             on the CPU, then 3 surrogate-gradient steps of a rate loss
             (T 16) with a finite, nonzero gradient;
     pipelined  the feedforward path's widths and config on the
             pipelined schedule (``pipeline=True``), a LUT with delays 16
             to 24 (> 2B - 1): fused_inject, fused_drain and lif_step must
             launch; its first 16 steps equal a plain run on the CPU
             (spikes, integer stats, ring, merge queue); spikes, ring and
             every integer stat equal the serial run on the card; a
             streaming drive of 4 ``pipeline_block`` calls closes
             conservation with the in-flight leg, and ``flush_pending``
             empties it;
     flow    the dense path's network (wafer widths and LUT, LIF) on the
             event path under ``FlowControlConfig(capacity=16,
             drain_rate=8, retransmit_depth=512)``: bucket_pack (one launch
             per substep), fused_drain and lif_step must launch; the gate
             must bind (stalled words or a non-empty send queue); its
             first 16 steps equal a plain run on the CPU (spikes, stats,
             credits, send queue); Σ sent == deposits + expired +
             overflow + merge_dropped + stalled + queued;
     routed  the feedforward path's config and LUT through
             ``topology.switch_tree(2, 23, link_latency=1,
             trunk_latency=1)`` (chip -> FPGA -> switch: path latency 2
             within a group, 4 across): fused_inject, fused_drain and
             lif_step must launch; its first 16 steps equal a plain run
             on the CPU (spikes, every integer stat, ``link_words [B, 46,
             4]`` included, ring, merge queue); conservation closes; the
             same widths in simplified mode (1 bucket per chip) equal,
             spike for spike, a run on the dense transport whose LUT
             delays are raised by ``latency[src, dest]``;
     degraded  the same on ``topology.torus2d(2, 23, link_latency=1)``
             with chips 7 and 30 dead and link (12, 2) cut: fused_inject
             (with its reach row), fused_drain and lif_step must launch;
             ``lost_to_failure`` > 0, no traffic and no link word to or
             from a dead chip; conservation with the lost leg; its first
             16 steps equal a plain run on the CPU;
     resilient  the slice's main path: the degraded path's widths and
             LUT at B 1 through ``torus2d(2, 23, link_latency=1)`` from
             full health, telemetry ``MetricsConfig(flight_depth=16)``,
             under ``ResilientRunner(ckpt_every=4)`` for T 32 with chips
             7 and 30 killed at steps 13 and 22 (``FabricFaultInjector``:
             inputs masked, dead chips' neuron and ring rows frozen, the
             network rebuilt with ``healthy=`` on the survivors):
             fused_inject (with its reach row after the first recovery),
             fused_drain and lif_step must launch, and no kernel library
             may be built or loaded again; the recoveries must be (13,
             12, all but 7) and (22, 20, all but 7 and 30), the records
             cover T, and from each resume point spikes and every integer
             stat equal an uninterrupted run on the survivors from the
             same checkpoint; no spike from a dead chip after its kill;
             ``lost_to_failure`` > 0; two flight dumps whose blocks equal
             the failing trajectory's per-step stats; the whole drill on
             the CPU gives the same records, recoveries, final state
             (integers bitwise, voltages within 1e-5 of max(|v|, 1), the
             telemetry EMAs within 1e-6 relative) and dumps; then the
             checkpoint's bytes and ms per save and per restore;
     telemetry  the feedforward (B 8) and pipelined paths with
             ``telemetry=True``: spikes, ring and every stat equal the run
             without; the carry after 16 steps equals the CPU's (integers
             bitwise, floats within 1e-6 relative); ``check_conservation``
             closes from ``metrics_summary``'s totals with the queued and
             in-flight legs;
  8. serve-check  zamba2-2.7b at full width, one pattern repeat (6
             layers), float32, batch 1, prompt 300, 8 teacher-forced decode
             steps: the card (kernels) against the plain path on the CPU
             from the same weights and tokens, every step's logits within
             1e-3 of the largest |logit|;
  9. serve   ``launch.serve.main`` on zamba2-2.7b (54 layers) and then
             internlm2-1.8b (24 layers) at full width in bfloat16, batch 4,
             prompt 2048, 32 tokens: prefill must launch flash_attention 9
             and ssm_scan 54 times (zamba2) or flash_attention 24 times
             (internlm2); then, from the same weights, prefill + one decode
             step against a full forward at the next position, in float32
             and in bf16 (``consistency``); tok/s and peak memory;
 10. profile where a block's time goes on each path (torch.profiler):
             wall and device-busy time per step, the idle share, kernel
             launches per step, the costliest kernels and the device time
             under each phase scope (``fabric/inject``,
             ``fabric/exchange``, ``fabric/drain``,
             ``obs/metrics_update``, ...); feedforward again with
             telemetry on; 8 steps of the resilient path on its 44
             survivors; for the serve paths per prefill and per decode
             step;
 11. summary the ``kernels`` JSON line, the card's name and power limit,
             and last the ``{"ok": true, ...}`` line.

The SNN kernels are held bitwise; flash attention and the SSM scan sum in
another order than their plain versions and are held to a stated
tolerance (``lm_kernel_cases``).

It exits non-zero without a card, and without the rest of the repository.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
SIMT_OPS_PER_S = 67e12          # H100 SXM float32 rate outside tensor cores
BF16_TC_OPS_PER_S = 989e12      # H100 SXM dense bf16 tensor-core rate
# float32-accurate products on tensor cores: 3xTF32, three TF32 products
# (495 T op/s dense) for each.
TF32X3_OPS_PER_S = 495e12 / 3
REPLACES = {
    "fused_inject": "src/repro/kernels/fused_inject/kernel.py:186",
    "fused_lif_inject": "src/repro/kernels/fused_inject/kernel.py:277",
    "bucket_pack": "src/repro/kernels/bucket_pack/kernel.py:84",
    "fused_drain": "src/repro/kernels/fused_drain/kernel.py:145",
    "lif_step": "src/repro/kernels/lif_step/kernel.py:45",
    "merge_sort_words": "src/repro/kernels/merge_sort/kernel.py:84",
    "merge_sort": "src/repro/kernels/merge_sort/kernel.py:132",
    "flash_attention": "src/repro/kernels/flash_attention/kernel.py:104",
    "ssm_scan": "src/repro/kernels/ssm_scan/kernel.py:61",
}
PLAIN_CHECK_STEPS = 16
# Paths driven by one run call (deposits counted from the ring's pops),
# each also held against its first steps on the CPU.
WHOLE_RUNS = ("plastic", "dense", "pipelined", "flow", "routed", "degraded")
# The degraded path's failures: two dead chips and one cut link.
DEAD_CHIPS = (7, 30)
CUT_LINKS = ((12, 2),)


def tree_clone(x):
    if isinstance(x, torch.Tensor):
        return x.clone()
    if hasattr(x, "_fields"):
        return type(x)(*(tree_clone(v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(tree_clone(v) for v in x)
    return x


def leaves(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in leaves(v)]
    return []


def nbytes(*xs) -> int:
    return sum(t.numel() * t.element_size() for x in xs for t in leaves(x))


@contextlib.contextmanager
def capture(module, name: str, store: dict, keys=None):
    """Record the arguments of the first calls of ``module.name``: call i
    under ``keys[i]`` (default: the first call under ``name``)."""
    orig = getattr(module, name)
    keys = list(keys or (name,))

    def wrapped(*args, **kwargs):
        if keys:
            store[keys.pop(0)] = (tree_clone(args), {
                k: tree_clone(v) for k, v in kwargs.items()})
        return orig(*args, **kwargs)

    setattr(module, name, wrapped)
    try:
        yield
    finally:
        setattr(module, name, orig)


def compare(name: str, got, want) -> float:
    """Max abs difference over every output; raises unless it is 0 (all
    outputs are integers, held bitwise)."""
    g, w = leaves(got), leaves(want)
    if len(g) != len(w):
        raise AssertionError(f"{name}: {len(g)} outputs vs {len(w)}")
    err = 0.0
    for i, (a, b) in enumerate(zip(g, w)):
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"{name}: output {i} is {a.dtype}"
                                 f"{tuple(a.shape)}, plain {b.dtype}"
                                 f"{tuple(b.shape)}")
        if a.numel():
            err = max(err, float((a.double() - b.double()).abs().max()))
    if err != 0:
        raise AssertionError(f"{name}: differs from the plain version "
                             f"(max abs {err})")
    return err


def compare_close(name: str, got, want, rtol: float, atol: float) -> float:
    """Max abs difference over every output; raises where an element
    exceeds ``atol + rtol * |want|``."""
    g, w = leaves(got), leaves(want)
    if len(g) != len(w):
        raise AssertionError(f"{name}: {len(g)} outputs vs {len(w)}")
    err = 0.0
    for i, (a, b) in enumerate(zip(g, w)):
        if a.shape != b.shape:
            raise AssertionError(f"{name}: output {i} shape {tuple(a.shape)}"
                                 f", plain {tuple(b.shape)}")
        diff = (a.double() - b.double()).abs()
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"{name}: non-finite output {i}")
        err = max(err, float(diff.max()))
        if bool((diff > atol + rtol * b.double().abs()).any()):
            raise AssertionError(f"{name}: output {i} differs from the plain "
                                 f"version beyond rtol {rtol} atol {atol} "
                                 f"(max abs {err})")
    return err


def event_ms(fn, iters: int) -> float:
    """Per-call time with CUDA events over back-to-back calls."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def graph_ms(fn, iters: int = 20, reps: int = 5) -> float:
    """Per-call time with CUDA events over replays of one CUDA graph that
    holds ``iters`` back-to-back calls: the calls run without the host's
    launch gaps, so a short kernel is timed, not its Python wrapper."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (reps * iters)


def library_ms(fn) -> float:
    """A library call's time as :func:`graph_ms` takes it, or with CUDA
    events over eager calls where the call cannot be captured in a
    graph."""
    try:
        return graph_ms(fn)
    except RuntimeError as err:
        print(f"[kernel] library call not capturable ({err}); timed eagerly")
        torch.cuda.synchronize()
        return event_ms(fn, 20)


def device_ms(fn, names, iters: int) -> float | None:
    """Device time per launch of the CUDA kernels whose names contain one
    of ``names`` from torch.profiler; None if the profiler recorded no
    device time."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total, count = 0.0, 0
    for evt in prof.key_averages():
        if any(name in evt.key for name in names):
            t = getattr(evt, "device_time_total", None)
            if t is None:
                t = getattr(evt, "cuda_time_total", 0.0)
            total += t
            count += evt.count
    return total / count / 1e3 if count and total > 0 else None


def host_us(fn, calls: int = 1000) -> float:
    """Host time per call: a host clock over ``calls`` back-to-back calls,
    then one synchronise (the wrapper's Python and launch cost, where the
    card keeps up)."""
    fn()
    torch.cuda.synchronize()
    t_start = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t_start) / calls * 1e6


def ptxas_registers(log: str, kernel: str) -> int | None:
    """Registers per thread that ptxas reports for the entry function
    ``kernel`` (matched with the length prefix of its mangled name, so
    ``fused_inject_kernel`` is not ``fused_lif_inject_kernel``)."""
    mangled, hit = f"{len(kernel)}{kernel}E", False
    for line in log.splitlines():
        if "Compiling entry function" in line:
            hit = mangled in line
        m = re.search(r"Used (\d+) registers", line)
        if m and hit:
            return int(m.group(1))
    return None


def run_path(net, cfg, params, ext, device, b: int):
    """Drive ``net.run`` block by block on ``ext [T, n_chips, n_in]``;
    returns the record and the ring deposits of the run, counted as
    ring(after) - ring(before) + popped, per block."""
    state = net.init_state(cfg, params, device=device)
    deposits = torch.zeros((), dtype=torch.int64, device=device)
    spikes, volts, stats = [], [], []
    d = cfg.comm.ring_depth
    for t in range(0, ext.shape[0], b):
        before = state.ring.ring.sum(dtype=torch.int64)
        slots = (state.ring.now[:, None] + torch.arange(b, device=device)) % d
        popped = state.ring.ring.gather(
            1, slots[..., None].long().expand(-1, -1, state.ring.n_inputs))
        state, rec = net.run(cfg, params, state, ext[t:t + b], device=device)
        deposits += (state.ring.ring.sum(dtype=torch.int64) - before
                     + popped.sum(dtype=torch.int64))
        spikes.append(rec.spikes)
        volts.append(rec.voltage)
        stats.append(rec.stats)
    rec = net.StepRecord(spikes=torch.cat(spikes), voltage=torch.cat(volts),
                         stats=type(stats[0])(*(torch.cat(x)
                                                for x in zip(*stats))))
    return state, rec, deposits


def check_conservation(label: str, state, rec, deposits, carried=None):
    """Σ sent == deposits + expired + overflow + merge_dropped + stalled +
    lost_to_failure + the merge and send queues' occupancy + the in-flight
    words of a pipeline carry.  ``carried`` is a carry whose block's stats
    are not in ``rec`` yet (a run stopped between two stages): its sent
    and source-side legs are added."""
    s = rec.stats
    total = lambda x: int(x.sum(dtype=torch.int64))  # noqa: E731
    queued = sum(int(q.occupancy().sum()) for q in (state.merge, state.sendq)
                 if q is not None)
    in_flight = 0
    lhs = total(s.sent)
    legs = (total(s.expired) + total(s.overflow) + total(s.merge_dropped)
            + total(s.stalled) + total(s.lost_to_failure))
    if carried is not None:
        in_flight = int(carried.occupancy().sum())
        inj = carried.inject
        lhs += total(inj.sent)
        legs += sum(total(x) for x in (inj.overflow, inj.stalled,
                                       inj.wrap_expired, inj.lost))
    rhs = int(deposits) + legs + queued + in_flight
    print(f"[{label}] conservation: sent {lhs} == deposits {int(deposits)} "
          f"+ expired {total(s.expired)} + overflow {total(s.overflow)} + "
          f"merge_dropped {total(s.merge_dropped)} + stalled "
          f"{total(s.stalled)} + lost {total(s.lost_to_failure)} + queued "
          f"{queued} + in flight {in_flight}"
          f"{'' if carried is None else ' + the carried block legs'} "
          f"= {rhs}")
    if lhs != rhs:
        raise AssertionError(f"{label}: conservation violated")
    if lhs == 0:
        raise AssertionError(f"{label}: no event was sent")


def check_record(label: str, rec, t: int, n_chips: int, n: int):
    for name, x in (("spikes", rec.spikes), ("voltage", rec.voltage)):
        if tuple(x.shape) != (t, n_chips, n):
            raise AssertionError(f"{label}: {name} shape {tuple(x.shape)}")
        if not bool(torch.isfinite(x).all()):
            raise AssertionError(f"{label}: non-finite {name}")


@contextlib.contextmanager
def tally_pops(store: list):
    """Add up the spikes every ring pop of a run returns (the ring's
    deposits are its pops plus what it still holds)."""
    from repro_torch.core import delays as dl

    orig = dl.pop_current

    def wrapped(state):
        state, spikes = orig(state)
        store.append(spikes.sum(dtype=torch.float64))
        return state, spikes

    dl.pop_current = wrapped
    try:
        yield
    finally:
        dl.pop_current = orig


class Paths:
    """The path runs and the first-block kernel inputs of each."""

    def __init__(self, device, seed: int, steps: int):
        from repro_torch import obs
        from repro_torch.configs import bss2
        from repro_torch.core import fabric as fb
        from repro_torch.core import pulse_comm as pc
        from repro_torch.core import routing as rt
        from repro_torch.core import topology as tpo
        from repro_torch.snn import network as net
        from repro_torch.snn import synapse as sy

        self.device, self.seed, self.steps, self.net = device, seed, steps, net
        base = bss2.CONFIG
        self.wafer_cfg = net.NetworkConfig(comm=base.comm,
                                           neuron_model=base.neuron_model)
        ff_comm = dataclasses.replace(
            base.comm, fanout=1, mode="full", buckets_per_chip=2,
            merge_rate=128, superstep=8)
        self.ff_cfg = net.NetworkConfig(comm=ff_comm, neuron_model="lif")
        self.dense_cfg = net.NetworkConfig(comm=base.comm, neuron_model="lif",
                                           comm_mode="dense")
        gen = torch.Generator().manual_seed(seed)
        self.wafer_params = net.init_params(gen, self.wafer_cfg,
                                            device=device)
        c = ff_comm
        table = rt.random_table(gen, c.neurons_per_chip, c.n_chips,
                                min_delay=8, max_delay=16)
        self.ff_params = net.init_params(gen, self.ff_cfg, table=table,
                                         device=device)
        # The wafer's LUT; weights on a 1/64 grid, so the crossbar sums of
        # integer spike counts are exact in any order (card = CPU).
        dense = net.init_params(gen, self.dense_cfg,
                                table=self.wafer_params.table, device=device)
        self.dense_params = dense._replace(crossbar=sy.Crossbar(
            w=torch.round(dense.crossbar.w * 64) / 64))
        rng = np.random.default_rng(seed)
        self.wafer_ext = self._ext(rng, base.comm)
        self.ff_ext = self._ext(rng, ff_comm)
        self.dense_ext = self._ext(rng, base.comm)
        self.pc = pc
        # pipelined: the feedforward path on the pipelined schedule, with
        # delays 16 to 24 > 2B - 1, so it must equal the serial schedule.
        self.pipe_cfg = dataclasses.replace(self.ff_cfg, pipeline=True)
        self.pipe_params = self.ff_params._replace(table=rt.random_table(
            gen, c.neurons_per_chip, c.n_chips, min_delay=16, max_delay=24,
            device=device))
        # flow: the dense path's network (wafer widths and LUT, LIF,
        # weights on the 1/64 grid) on the event path under credits with
        # a send queue, and the same input.
        self.flow_cfg = net.NetworkConfig(
            comm=base.comm, neuron_model="lif", flow=fb.FlowControlConfig(
                capacity=16, drain_rate=8, retransmit_depth=512))
        # routed: the feedforward path through the paper's chip -> FPGA ->
        # switch stack; degraded: through a 2 x 23 torus with two chips
        # dead and one link cut.
        self.routed_cfg = dataclasses.replace(
            self.ff_cfg, topology=tpo.switch_tree(2, 23, link_latency=1,
                                                  trunk_latency=1))
        self.degraded_cfg = dataclasses.replace(
            self.ff_cfg, topology=tpo.torus2d(2, 23, link_latency=1),
            healthy=tuple(i for i in range(c.n_chips)
                          if i not in DEAD_CHIPS), dead_links=CUT_LINKS)
        # resilient: the degraded path's widths and LUT at B 1 through the
        # same torus at full health, with telemetry, under ResilientRunner
        # (chips 7 and 30 die mid-run).
        self.resilient_cfg = dataclasses.replace(
            self.ff_cfg, comm=dataclasses.replace(ff_comm, superstep=1),
            topology=tpo.torus2d(2, 23, link_latency=1),
            telemetry=obs.MetricsConfig(flight_depth=FLIGHT_DEPTH))

    def _ext(self, rng, comm):
        """Background input: each synapse row receives a spike with
        probability 0.02 per step."""
        x = rng.random((self.steps, comm.n_chips, comm.n_inputs_per_chip))
        return torch.as_tensor((x < 0.02).astype(np.float32),
                               device=self.device)

    def runs(self):
        """(label, cfg, params, ext, kernels that must launch, plastic)."""
        return (
            ("wafer", self.wafer_cfg, self.wafer_params, self.wafer_ext,
             ("bucket_pack", "fused_drain"), False),
            ("feedforward", self.ff_cfg, self.ff_params, self.ff_ext,
             ("fused_inject", "fused_drain", "lif_step"), False),
            ("plastic", self.ff_cfg, self.ff_params, self.ff_ext,
             ("fused_inject", "fused_drain", "lif_step"), True),
            ("dense", self.dense_cfg, self.dense_params, self.dense_ext,
             ("lif_step",), False),
            ("pipelined", self.pipe_cfg, self.pipe_params, self.ff_ext,
             ("fused_inject", "fused_drain", "lif_step"), False),
            ("flow", self.flow_cfg, self.dense_params, self.dense_ext,
             ("bucket_pack", "fused_drain", "lif_step"), False),
            ("routed", self.routed_cfg, self.ff_params, self.ff_ext,
             ("fused_inject", "fused_drain", "lif_step"), False),
            ("degraded", self.degraded_cfg, self.ff_params, self.ff_ext,
             ("fused_inject", "fused_drain", "lif_step"), False))

    def drive(self, cfg, params, state, ext, plastic: bool, device=None):
        """One ``run`` or ``run_plastic`` call; returns ``(state, record,
        params)``."""
        device = device or self.device
        if plastic:
            params, state, rec, _ = self.net.run_plastic(
                cfg, params, state, ext, device=device)
            return state, rec, params
        state, rec = self.net.run(cfg, params, state, ext, device=device)
        return state, rec, params

    def first_blocks(self) -> dict:
        """Kernel inputs of each path's first block."""
        from repro_torch.kernels.bucket_pack import ops as bp_ops
        from repro_torch.kernels.fused_drain import ops as fd_ops
        from repro_torch.kernels.fused_inject import ops as fi_ops
        from repro_torch.kernels.lif_step import ops as lif_ops

        out = {}
        for label, cfg, params, ext in (
                ("wafer", self.wafer_cfg, self.wafer_params, self.wafer_ext),
                ("feedforward", self.ff_cfg, self.ff_params, self.ff_ext),
                ("degraded", self.degraded_cfg, self.ff_params,
                 self.ff_ext)):
            store = {}
            with capture(fi_ops, "fused_inject", store), \
                    capture(fd_ops, "fused_drain", store), \
                    capture(bp_ops, "flush_pack", store), \
                    capture(lif_ops, "lif_step", store):
                state = self.net.init_state(cfg, params, device=self.device)
                _, store["record"] = self.net.run(
                    cfg, params, state, ext[:cfg.comm.superstep],
                    device=self.device)
            out[label] = store
        # The pipelined path's first two drains (the prologue, then block
        # 0 drained in stage 2), and the flow path's packs of its first
        # and fourth substeps (the queue's lanes ahead of the fresh ones).
        for label, cfg, params, ext, steps, cap in (
                ("pipelined", self.pipe_cfg, self.pipe_params, self.ff_ext,
                 2 * self.pipe_cfg.comm.superstep,
                 (fd_ops, "fused_drain", ("prologue", "steady"))),
                ("flow", self.flow_cfg, self.dense_params, self.dense_ext, 4,
                 (bp_ops, "flush_pack_column", ("first", "fourth")))):
            store = {}
            with capture(*cap[:2], store, cap[2]):
                state = self.net.init_state(cfg, params, device=self.device)
                self.net.run(cfg, params, state, ext[:steps],
                             device=self.device)
            out[label] = store
        return out


def radix_passes(key: torch.Tensor) -> torch.Tensor:
    """Passes of the SoA radix sort per row of ``key [rows, L]`` (int32):
    ceil(bits / 8) over the key bits that vary within the row."""
    diff = key ^ key[..., :1]
    bits = sum(((diff >> b) & 1).any(-1).long() for b in range(32))
    return (bits + 7) // 8


def sort_ops(lanes: int, passes: torch.Tensor) -> int:
    """Lane visits of the counting sorts: each pass counts and then ranks
    every lane of its row once (``passes`` per row)."""
    return 2 * lanes * int(passes.sum())


def merge_lanes(blocks: dict):
    """The first feedforward block's merge cycle of substep 0: queue +
    delivered lanes + ``rate`` sentinels, and the clock of each row."""
    from repro_torch.core import events as ev

    (ring, delivered, queue, t0), kw = blocks["feedforward"]["fused_drain"]
    pad = ev.sentinel_words((queue.shape[0], kw["rate"]),
                            device=queue.device)
    return torch.cat([queue, delivered[:, 0], pad], dim=-1).contiguous(), t0


def lif_inject_call(paths: Paths, device, mode: str, bpc: int, b: int):
    """``fused_lif_inject``'s arguments at the feedforward cell: the
    network's initial state and its first block's currents (the rings are
    empty in the first block, so each substep's currents are the crossbar
    of the input alone, computed as the network computes them)."""
    from repro_torch.snn import synapse as sy

    cfg, params = paths.ff_cfg, paths.ff_params
    c = cfg.comm
    state = paths.net.init_state(cfg, params, device=device)
    currents = torch.stack([sy.currents(params.crossbar,
                                        paths.ff_ext[k] + 0.0)
                            for k in range(b)])
    kw = dict(event_capacity=c.event_capacity, n_chips=c.n_chips,
              buckets_per_chip=bpc, capacity=c.bucket_capacity, mode=mode,
              time_window=c.time_window)
    return (state.neuron.v, state.neuron.refrac, currents, params.neuron,
            params.table, state.ring.now), kw


def kernel_cases(blocks: dict, paths: Paths, device) -> list[dict]:
    """Every (kernel, mode) case: the call, its plain version, bytes and
    operations."""
    from repro_torch.core import events as ev
    from repro_torch.kernels.bucket_pack import ops as bp_ops
    from repro_torch.kernels.bucket_pack.ref import bucket_pack_ref
    from repro_torch.kernels.fused_drain import ops as fd_ops
    from repro_torch.kernels.fused_drain.ref import fused_drain_ref
    from repro_torch.kernels.fused_inject import ops as fi_ops
    from repro_torch.kernels.fused_inject.ref import (fused_inject_ref,
                                                     fused_lif_inject_ref)
    from repro_torch.kernels.lif_step import ops as lif_ops
    from repro_torch.kernels.lif_step.ref import lif_step_ref
    from repro_torch.kernels.merge_sort import ops as ms_ops
    from repro_torch.kernels.merge_sort.ref import (merge_sort_ref,
                                                   merge_sort_words_ref)

    def fused_plan(plan, n, b):
        # A launch plan gives threads first and shared bytes last.
        return (f"one CTA per (chip, substep), grid ({n}, {b}), {plan[0]} "
                f"threads, {plan[-1]} B shared memory")

    cases = []
    (events, table, t0), kw = blocks["feedforward"]["fused_inject"]
    for mode, bpc in (("full", kw["buckets_per_chip"]), ("simplified", 1)):
        for b in (events.addr.shape[0], 1):
            ev_b = ev.EventBuffer(*(x[:b].contiguous() for x in events))
            kwm = dict(kw, mode=mode, buckets_per_chip=bpc)
            args = (ev_b, table, t0)
            n, lanes = ev_b.addr.shape[1], ev_b.addr.shape[2]
            nb = n * bpc
            slab = (n, nb, b, kw["capacity"])
            cases.append(dict(
                kernel="fused_inject", mode=f"{mode} B{b}",
                main=(mode == "full" and b == events.addr.shape[0]),
                run=lambda a=args, k=kwm: fi_ops.fused_inject(*a, **k),
                plain=lambda a=args, k=kwm: fused_inject_ref(*a, **k),
                inputs=(ev_b, table, t0), ops=ev_b.addr.numel(), host=True,
                sole_kernel="fused_inject_kernel",
                plan=fused_plan(fi_ops.launch_plan(lanes, n, nb,
                                                   kw["capacity"]), n, b),
                floor=(f"write floor: one torch.full of the slab {slab} "
                       f"int32 with -1",
                       lambda sh=slab: torch.full(sh, -1, dtype=torch.int32,
                                                  device=device))))

    c = paths.ff_cfg.comm
    for mode, bpc, b in (("full", c.buckets_per_chip, c.superstep),
                         ("simplified", 1, 1)):
        args, kwm = lif_inject_call(paths, device, mode, bpc, b)
        n, neurons = args[2].shape[1:]
        cases.append(dict(
            kernel="fused_lif_inject", mode=f"{mode} B{b}",
            main=mode == "full",
            run=lambda a=args, k=kwm: fi_ops.fused_lif_inject(*a, **k),
            plain=lambda a=args, k=kwm: fused_lif_inject_ref(*a, **k),
            inputs=args, ops=args[2].numel() * 12, host=True,
            sole_kernel="fused_lif_inject_kernel",
            plan=fused_plan(fi_ops.lif_launch_plan(
                neurons, n, n * bpc, c.bucket_capacity), n, b)))

    # The degraded path's first block with its reach row (lost bitwise),
    # beside the same block with a row of ones and with none (a null
    # pointer: the kernel reads nothing more).
    (events, table, t0), kw = blocks["degraded"]["fused_inject"]
    reach = kw["reach"]
    if reach is None:
        raise AssertionError("degraded: fused_inject ran without a reach row")

    def lost_check(got):
        if int(got.lost.sum()) == 0:
            raise AssertionError("fused_inject reach row: nothing culled")

    b, n, lanes = events.addr.shape
    nb = n * kw["buckets_per_chip"]
    for label, row in (("reach row", reach),
                       ("row of ones", torch.ones_like(reach)),
                       ("no reach row", None)):
        kwm = dict(kw, reach=row)
        cases.append(dict(
            kernel="fused_inject", mode=f"degraded full B{b} {label}",
            main=False,
            run=lambda a=(events, table, t0), k=kwm: fi_ops.fused_inject(
                *a, **k),
            plain=lambda a=(events, table, t0), k=kwm: fused_inject_ref(
                *a, **k),
            check=lost_check if label == "reach row" else None,
            inputs=(events, table, t0, row), ops=events.addr.numel(),
            host=True, sole_kernel="fused_inject_kernel",
            plan=fused_plan(fi_ops.launch_plan(lanes, n, nb, kw["capacity"],
                                               row is not None), n, b)))
    args, kwm = lif_inject_call(paths, device, c.mode, c.buckets_per_chip,
                                c.superstep)
    kwm = dict(kwm, reach=reach)
    n, neurons = args[2].shape[1:]
    cases.append(dict(
        kernel="fused_lif_inject", mode=f"full B{c.superstep} reach row",
        main=False,
        run=lambda a=args, k=kwm: fi_ops.fused_lif_inject(*a, **k),
        plain=lambda a=args, k=kwm: fused_lif_inject_ref(*a, **k),
        check=lambda got: lost_check(got.inject),
        inputs=args + (reach,), ops=args[2].numel() * 12, host=True,
        sole_kernel="fused_lif_inject_kernel",
        plan=fused_plan(fi_ops.lif_launch_plan(
            neurons, n, n * c.buckets_per_chip, c.bucket_capacity, True),
            n, c.superstep)))

    args, _ = blocks["feedforward"]["lif_step"]
    n = args[0].numel()
    cases.append(dict(
        kernel="lif_step", mode=f"{tuple(args[0].shape)}", main=True,
        run=lambda a=args: lif_ops.lif_step(*a),
        plain=lambda a=args: lif_step_ref(*a), inputs=args,
        ops=n * 12, host=True, sole_kernel="lif_step_kernel",
        plan=f"one neuron per thread, {-(-n // 256)} CTAs of 256 threads",
        floor=(f"launch floor: one torch.add over {tuple(args[0].shape)} "
               f"float32", lambda x=args[0], y=args[2]: torch.add(x, y))))

    words, now = merge_lanes(blocks)
    rows, lanes = words.shape
    key = ev.word_sort_key(words, now[:, None])

    def words_library(w=words, k=key):
        return w.gather(-1, torch.sort(k, dim=-1, stable=True).indices)

    cases.append(dict(
        kernel="merge_sort_words", mode=f"{rows} x {lanes}", main=True,
        run=lambda: ms_ops.merge_sort_words(words, now),
        plain=lambda: merge_sort_words_ref(words, now),
        library=words_library, inputs=(words, now),
        ops=sort_ops(lanes, torch.ones(rows))))

    # The path's lanes, then deadlines over the whole int32 range (4 radix
    # passes, the worst case).
    gen = torch.Generator(device=device).manual_seed(paths.seed)
    full = (torch.randint(0, 1 << 14, (rows, lanes), generator=gen,
                          device=device, dtype=torch.int32),
            torch.randint(-2**31, 2**31, (rows, lanes), generator=gen,
                          device=device, dtype=torch.int64).to(torch.int32),
            torch.rand((rows, lanes), generator=gen, device=device) < 0.6)
    for label, soa, main in (
            ("", (ev.word_addr(words), ev.word_deadline(words, now[:, None]),
                  ev.word_valid(words)), True),
            (" full-range", full, False)):
        soa_key = torch.where(soa[2], soa[1], 2**30)

        def soa_library(a=soa, k=soa_key):
            order = torch.sort(k, dim=-1, stable=True).indices
            return tuple(x.gather(-1, order) for x in a)

        passes = radix_passes(soa_key)
        cases.append(dict(
            kernel="merge_sort",
            mode=f"{rows} x {lanes}{label}, {int(passes.max())} passes",
            main=main, run=lambda a=soa: ms_ops.merge_sort(*a),
            plain=lambda a=soa: merge_sort_ref(*a), library=soa_library,
            inputs=soa, ops=sort_ops(lanes, passes)))

    (bid, addr, dead, valid), kw = blocks["wafer"]["flush_pack"]
    args = (bid, addr, dead, valid)
    bp_rows, bp_lanes = bid.shape[0] * bid.shape[1], bid.shape[-1]

    def bp_plain(a=args, k=kw):
        rows, counts, overflow = bucket_pack_ref(
            a[0].to(torch.int32), ev.encode_word(*a[1:]), **k)
        return rows.permute(1, 2, 0, 3).contiguous(), counts, overflow

    threads, smem = bp_ops.launch_plan(bp_lanes, kw["n_buckets"],
                                       kw["capacity"])
    cases.append(dict(
        kernel="bucket_pack", mode=f"flush B{bid.shape[0]}", main=True,
        run=lambda a=args, k=kw: bp_ops.flush_pack(*a, **k), plain=bp_plain,
        inputs=args, ops=bid.numel(), host=True,
        sole_kernel="bucket_pack_kernel",
        plan=(f"one CTA per row, {bp_rows} CTAs of {threads} threads, "
              f"{smem} B shared memory")))

    def drain_cases(label, ring, delivered, queue, t0, kw, modes):
        n, b_full = delivered.shape[:2]
        gates = (None, torch.arange(n, device=device) % 2 == 0)
        for mode in modes:
            for b in sorted({b_full, 1}, reverse=True):
                for gate in gates:
                    d = delivered[:, :b].contiguous()
                    q = queue if mode == "rate" else None
                    kwm = dict(kw, mode=mode, gate=gate)
                    if mode != "rate":
                        kwm["rate"] = 0
                    args = (ring, d, q, t0)
                    # One count and one rank visit per merged lane, one
                    # deposit per emitted word, per chip and substep: the
                    # work whatever sorts it.
                    merged = fd_ops.sort_length(
                        mode, d.shape[-1], 0 if q is None else q.shape[-1])
                    emitted = kwm["rate"] if mode == "rate" else d.shape[-1]
                    ops = n * b * (2 * merged + emitted)
                    cases.append(dict(
                        kernel="fused_drain",
                        mode=(f"{label} {mode} B{b} gate "
                              f"{'on' if gate is None else 'mixed'}"),
                        main=(label == "feedforward" and mode == "rate"
                              and b == b_full and gate is None),
                        run=lambda a=args, k=kwm: fd_ops.fused_drain(*a, **k),
                        plain=lambda a=args, k=kwm: fused_drain_ref(*a, **k),
                        inputs=(ring.ring, d, q, t0), ops=ops))

    (ring, delivered, queue, t0), kw = blocks["wafer"]["fused_drain"]
    drain_cases("wafer", ring, delivered, queue, t0, kw, ("passthrough",))
    (ring, delivered, queue, t0), kw = blocks["feedforward"]["fused_drain"]
    drain_cases("feedforward", ring, delivered, queue, t0, kw,
                ("rate", "sort", "passthrough"))

    # The pipelined schedule's drains: block 0 drained in stage 2 (deposit
    # guard widened by B, gate all on), and the prologue (gate all off).
    def prologue_check(got, q, r):
        if (bool((got.words >= 0).any()) or int(got.dep_expired.sum())
                or not torch.equal(got.queue, q)
                or not torch.equal(got.ring.ring, r.ring)):
            raise AssertionError("fused_drain prologue: the closed gate let "
                                 "words, expiries or queue changes through")

    for key, gate_open in (("steady", True), ("prologue", False)):
        (ring, delivered, queue, t0), kw = blocks["pipelined"][key]
        n, b = delivered.shape[:2]
        if (kw["extra_ahead"] != b or kw["mode"] != "rate"
                or not bool((kw["gate"] == gate_open).all())):
            raise AssertionError(f"pipelined {key} drain captured with "
                                 f"{kw}")
        args = (ring, delivered, queue, t0)
        merged = fd_ops.sort_length("rate", delivered.shape[-1],
                                    queue.shape[-1])
        cases.append(dict(
            kernel="fused_drain",
            mode=(f"pipelined rate B{b} extra_ahead {b} gate all "
                  f"{'on' if gate_open else 'off'}"), main=False,
            run=lambda a=args, k=kw: fd_ops.fused_drain(*a, **k),
            plain=lambda a=args, k=kw: fused_drain_ref(*a, **k),
            check=(None if gate_open else
                   lambda got, q=queue, r=ring: prologue_check(got, q, r)),
            inputs=(ring.ring, delivered, queue, t0),
            ops=n * b * (2 * merged + kw["rate"])))

    # The credit-gated inject's pack of one substep into column k of the
    # block's slab, in place: the send queue's lanes ahead of the fresh.
    depth = paths.flow_cfg.flow.retransmit_depth
    for key in ("first", "fourth"):
        (bid, addr, dead, valid), kw = blocks["flow"][key]
        args = (bid, addr, dead, valid)
        slab0, k, cap = kw["slab"], kw["substep"], kw["capacity"]
        target = slab0.clone()

        def column_run(a=args, s=target, k=k, cap=cap):
            counts, overflow = bp_ops.flush_pack_column(
                *a, slab=s, substep=k, capacity=cap)
            return s, counts, overflow

        def column_plain(a=args, s0=slab0, k=k, cap=cap):
            rows, counts, overflow = bucket_pack_ref(
                a[0].to(torch.int32), ev.encode_word(*a[1:]),
                n_buckets=s0.shape[1], capacity=cap)
            s = s0.clone()
            s[:, :, k] = rows
            return s, counts, overflow

        n, lanes = bid.shape
        queued = int(valid[:, :depth].sum())
        threads, smem = bp_ops.launch_plan(lanes, slab0.shape[1], cap)
        cases.append(dict(
            kernel="bucket_pack",
            mode=(f"flow column, {key} substep, {n} x {lanes} lanes "
                  f"({depth} queue lanes, {queued} valid)"), main=False,
            run=column_run, plain=column_plain, inputs=args + (slab0,),
            ops=bid.numel(), host=True, sole_kernel="bucket_pack_kernel",
            plan=(f"one CTA per row, {n} CTAs of {threads} threads, {smem} "
                  f"B shared memory, into column {k} of the slab")))
    return cases


def kernel_phase(cases: list[dict]) -> dict:
    """Compare, then time; returns the main case of each kernel.  A case
    with ``tol = (rtol, atol)`` is held to that tolerance against its
    ``want`` (default: its plain version), else bitwise."""
    from repro_torch.kernels import common as kc

    build = kc.build_dir()
    main = {}
    for case in cases:
        label = f"{case['kernel']} [{case['mode']}]"
        got = case["run"]()
        want = case.get("want", case["plain"])()
        torch.cuda.synchronize()
        tol = case.get("tol")
        err = (compare(label, got, want) if tol is None
               else compare_close(label, got, want, *tol))
        if case.get("check") is not None:
            case["check"](got)
        del want
        moved = nbytes(case["inputs"]) + nbytes(got)
        bytes_ms = moved / HBM_BYTES_PER_S * 1e3
        ops_ms = case["ops"] / case.get("ops_per_s", SIMT_OPS_PER_S) * 1e3
        library = case.get("library")
        if library is not None:
            lib_tol = case.get("library_tol")
            if lib_tol is None:
                compare(f"{label} library", got, library())
            else:
                compare_close(f"{label} library", got, library(), *lib_tol)
        del got
        row = dict(name=case["kernel"], mode=case["mode"], max_abs_err=err,
                   ms=graph_ms(case["run"]),
                   device_ms=device_ms(case["run"], case.get(
                       "device_names", (f"{case['kernel']}_kernel",)), 20),
                   plain_ms=event_ms(case["plain"], case.get("plain_iters",
                                                             5)),
                   bytes=moved, ops=case["ops"],
                   bound_ms=max(bytes_ms, ops_ms),
                   bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                   library_ms=(None if library is None
                               else library_ms(library)))
        dms, lms = row["device_ms"], row["library_ms"]
        check = ("bitwise ok" if tol is None else
                 f"within rtol {tol[0]:g} atol {tol[1]:g} (max abs "
                 f"{err:.3g})")
        print(f"[kernel] {case['kernel']:16s} {case['mode']:40s} "
              f"{check}  ms={row['ms']:.5f} device_ms="
              f"{'not measured' if dms is None else f'{dms:.5f}'} "
              f"plain_ms={row['plain_ms']:.4f} bytes={moved} "
              f"ops={case['ops']} bound_ms={row['bound_ms']:.5f} "
              f"({row['bound_by']})"
              + ("" if lms is None else f" library_ms={lms:.5f}"))
        if "sole_kernel" in case:
            _, names = kc.card_kernels(case["run"])
            if len(names) != 1 or case["sole_kernel"] not in names[0]:
                raise AssertionError(f"{label}: one call put {names} on the "
                                     f"card, not one {case['sole_kernel']}")
            src = kc.KERNELS[case["kernel"]]
            regs = ptxas_registers((build / f"{src}.log").read_text(),
                                   case["sole_kernel"])
            print(f"[kernel] {case['kernel']:16s} {case['mode']:40s} "
                  f"plan: {case['plan']}; ptxas {regs} registers; one "
                  f"kernel per call ({case['sole_kernel']})")
        if case.get("host"):
            row["host_us"] = host_us(case["run"])
            print(f"[kernel] {case['kernel']:16s} {case['mode']:40s} "
                  f"host_us per wrapper call={row['host_us']:.2f} "
                  f"(1000 calls, one synchronise)")
        if "floor" in case:
            label, floor = case["floor"]
            row["floor_ms"] = graph_ms(floor)
            row["floor_host_us"] = host_us(floor)
            print(f"[kernel] {label} ms={row['floor_ms']:.5f} host_us="
                  f"{row['floor_host_us']:.2f} (beside {case['kernel']} "
                  f"{case['mode']} ms={row['ms']:.5f})")
        if "design" in case:
            print(f"[kernel] {case['kernel']:16s} {case['mode']:40s} "
                  f"design={case['design']} TFLOP/s="
                  f"{case['ops'] / row['ms'] / 1e9:.1f} share_of_bound="
                  f"{row['bound_ms'] / row['ms']:.3f}"
                  + ("" if lms is None else
                     f" ms/library_ms={row['ms'] / lms:.3f}"))
        if case["main"]:
            main[case["kernel"]] = row
    return main


FLASH_INSTANCES = {"bf16": "flash_attention_wgmma_kernel",
                   "f32": "flash_attention_tf32x3_kernel"}


def flash_spills(log: str) -> dict[str, dict[int, int]]:
    """Spill bytes (stores + loads) of each flash-attention instance in
    ptxas's report, by type ("bf16", "f32") and DN (the largest head size
    the instance serves)."""
    spills = {kind: {} for kind in FLASH_INSTANCES}
    key = None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            key = None
            for kind, name in FLASH_INSTANCES.items():
                m = re.search(name + r"ILi(\d+)E", line)
                if m:
                    key = (kind, int(m.group(1)))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and key is not None:
            spills[key[0]][key[1]] = int(m.group(1)) + int(m.group(2))
    return spills


def causal_pairs(sq: int, skv: int, q_offset: int) -> int:
    """(query, key) pairs the causal mask lets through, per head."""
    return sum(min(skv, max(0, q_offset + r + 1)) for r in range(sq))


def lm_kernel_cases(device, seed: int) -> list[dict]:
    """flash_attention at the zamba2 and internlm2 prefill shapes (bf16),
    in f32, on a ragged length and after a cached prefix; ssm_scan at the
    zamba2 prefill shape, on inputs made as the serve path makes them (x
    bf16, dt per head from softplus, A per head of 80 channels: one exp
    per channel and step; the main case) and with f32 x and a general
    random A (an exp per state element).

    Tolerances: a bf16 output against the plain version in f32 on the
    same bf16 inputs within 2^-8 |want| + 2^-8 max|v| (half a bf16 ulp
    of the output, plus the kernel's rounding of P to bf16 before PV, at
    most 2^-9 max|v|, doubled as l sums the unrounded p); f32 outputs
    within 5e-5 (sums over up to 2048 keys in another order); the scan's
    y and final state within 1e-4 relative and absolute (the card's expf,
    64-term sums in another order, over 2048 steps).  The library call
    (``scaled_dot_product_attention``, causal from the top left, so only
    where q_offset is 0) is held to 2e-2 against the kernel."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.ssm_scan import ops as scan_ops
    from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref

    gen = torch.Generator(device=device).manual_seed(seed)
    randn = lambda *shape: torch.randn(shape, generator=gen,  # noqa: E731
                                       device=device)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    cases = []
    for label, b, hq, hkv, sq, skv, d, dtype, q_offset, main in (
            ("zamba2 prefill bf16", 4, 32, 32, 2048, 2048, 80,
             torch.bfloat16, 0, True),
            ("internlm2 prefill bf16", 4, 16, 8, 2048, 2048, 128,
             torch.bfloat16, 0, False),
            ("GQA 4 bf16", 4, 32, 8, 2048, 2048, 128, torch.bfloat16, 0,
             False),
            ("zamba2 f32, batch 1", 1, 32, 32, 2048, 2048, 80, torch.float32,
             0, False),
            ("ragged 300 f32", 1, 32, 32, 300, 300, 80, torch.float32, 0,
             False),
            ("q_offset 2048 bf16", 4, 32, 32, 64, 2112, 80, torch.bfloat16,
             2048, False)):
        q = randn(b, hq, sq, d).to(dtype)
        k, v = randn(b, hkv, skv, d).to(dtype), randn(b, hkv, skv, d).to(dtype)
        args, kw = (q, k, v), dict(causal=True, q_offset=q_offset)
        bf16 = dtype == torch.bfloat16
        library = None
        if q_offset == 0:
            library = (lambda a=args: sdpa(*a, is_causal=True,
                                           enable_gqa=True))
        cases.append(dict(
            kernel="flash_attention", mode=f"{label} {tuple(q.shape)}",
            main=main,
            run=lambda a=args, k_=kw: fa_ops.flash_attention(*a, **k_),
            plain=lambda a=args, k_=kw: attention_ref(*a, **k_),
            want=lambda a=args, k_=kw: attention_ref(
                *(x.float() for x in a), **k_),
            tol=((2**-8, 2**-8 * float(v.float().abs().max())) if bf16
                 else (0.0, 5e-5)),
            library=library, design=fa_ops.design(dtype),
            device_names=tuple(FLASH_INSTANCES.values()),
            library_tol=(0.0, 2e-2 if bf16 else 1e-4), inputs=args,
            ops=4 * d * b * hq * causal_pairs(sq, skv, q_offset),
            ops_per_s=BF16_TC_OPS_PER_S if bf16 else TF32X3_OPS_PER_S))

    b, t, di, n, head = 4, 2048, 5120, 64, 80
    softplus = torch.nn.functional.softplus
    x = randn(b, t, di)
    dt_h = softplus(randn(b, t, di // head) - 1.0)
    a_h = -torch.exp(randn(di // head) * 0.5)
    path = (x.to(torch.bfloat16), dt_h.repeat_interleave(head, dim=-1),
            a_h.repeat_interleave(head)[:, None]
            * torch.ones((1, n), device=device),
            randn(b, t, n), randn(b, t, n), randn(di))
    general = (x, softplus(randn(b, t, di) - 1.0),
               -torch.exp(randn(di, n) * 0.5), randn(b, t, n),
               randn(b, t, n), randn(di))
    # Operations per channel and step: with A per head, dt*A and its exp
    # (2) once, decay*h + u*B (3) and h*C summed (2) per state element, and
    # dt*x and D*x + y (3); with a general A, dt*A and exp per element.
    for label, args, ops, main in (
            ("zamba2 prefill, A per head, x bf16", path,
             b * t * di * (5 * n + 5), True),
            ("zamba2 prefill, general A, x f32", general,
             b * t * di * (7 * n + 3), False)):
        cases.append(dict(
            kernel="ssm_scan", mode=f"{label} {tuple(x.shape)} N {n}",
            main=main, run=lambda a=args: scan_ops.ssm_scan(*a),
            plain=lambda a=args: ssm_scan_ref(*a), tol=(1e-4, 1e-4),
            inputs=args, plain_iters=2, ops=ops,
            design="exp_per_channel_step" if main else "exp_per_state"))
    return cases


def entry_phase(blocks: dict, paths: Paths, device) -> dict:
    """The entry points off the network's path, counters zeroed just
    before; returns their launches."""
    from repro_torch.core import events as ev
    from repro_torch.core import merge as mg
    from repro_torch.kernels import common as kc
    from repro_torch.kernels.fused_drain import ops as fd_ops
    from repro_torch.kernels.fused_inject import ops as fi_ops
    from repro_torch.kernels.merge_sort import ops as ms_ops

    (ring, delivered, queue, t0), kw = blocks["feedforward"]["fused_drain"]
    record = blocks["feedforward"]["record"]
    c = paths.ff_cfg.comm
    lif_args, lif_kw = lif_inject_call(paths, device, c.mode,
                                       c.buckets_per_chip, c.superstep)
    torch.cuda.synchronize()
    kc.reset_launches()
    drains = {rate: mg.merge_drain_words(
        mg.MergeBuffer(words=queue), delivered.transpose(0, 1), now0=t0,
        rate=rate, use_pallas=True) for rate in (kw["rate"], 16)}
    merged, now = merge_lanes(blocks)
    soa = (ev.word_addr(merged), ev.word_deadline(merged, now[:, None]),
           ev.word_valid(merged))
    sorted_soa = ms_ops.merge_sort(*soa)
    lif = fi_ops.fused_lif_inject(*lif_args, **lif_kw)
    torch.cuda.synchronize()
    counts = dict(kc.launches)
    for rate, (buf, words, dropped) in drains.items():
        fused = fd_ops.fused_drain(ring, delivered, queue, t0, mode="rate",
                                   rate=rate)
        compare(f"merge_drain_words(use_pallas=True) vs fused_drain rate "
                f"{rate}", (buf.words, words, dropped),
                (fused.queue, fused.words, fused.dropped))
        print(f"[entry] merge_drain_words(use_pallas=True) equals "
              f"fused_drain rate mode at rate {rate}: "
              f"{int(buf.occupancy().sum())} queued, {int(dropped.sum())} "
              f"dropped")
    key = torch.where(sorted_soa[2], sorted_soa[1], 2**30)
    if not bool((key[..., 1:] >= key[..., :-1]).all()):
        raise AssertionError("merge_sort: rows out of order")
    compare("fused_lif_inject spikes vs the network's first block",
            lif.spikes, record.spikes)
    (events, table, t0_inject), inject_kw = blocks["feedforward"][
        "fused_inject"]
    compare("fused_lif_inject vs fused_inject of the network's first block",
            lif.inject, fi_ops.fused_inject(events, table, t0_inject,
                                            **inject_kw))
    print(f"[entry] merge_sort on {tuple(soa[0].shape)} in order; "
          f"fused_lif_inject's spikes and slab equal the network's first "
          f"block "
          f"({int(lif.spikes.sum())} spikes, {int(lif.inject.sent.sum())} "
          f"sent); launches {counts}")
    for k in ("merge_sort_words", "merge_sort", "fused_lif_inject"):
        if counts[k] == 0:
            raise AssertionError(f"entry: kernel {k} never launched")
    return counts


def path_phase(paths: Paths, device) -> dict:
    """Run every path with the launch counters zeroed just before each;
    returns launches per kernel and path."""
    from repro_torch import demo
    from repro_torch.core import topology as tpo
    from repro_torch.kernels import common as kc

    net = paths.net
    counts = {}
    for label, cfg, params, ext, needs, plastic in paths.runs():
        c = cfg.comm
        if label == "feedforward":
            print("[feedforward] paper demo (2 chips x 64 LIF, fan-out 1):")
            kc.reset_launches()
            src_t, dst_t = demo.main(device)
            demo_counts = dict(kc.launches)
            if (src_t, dst_t) != _demo_on_cpu(demo):
                raise AssertionError("demo spike times differ from the "
                                     "plain run on the CPU")
            print(f"[feedforward] demo spike times equal the plain CPU run; "
                  f"launches {demo_counts}")
        if label in WHOLE_RUNS:
            check_against_cpu(paths, label, cfg, params, ext, plastic)
        torch.cuda.synchronize()
        kc.reset_launches()
        pops = []
        t_start = time.perf_counter()
        if label in WHOLE_RUNS:
            state = net.init_state(cfg, params, device=device)
            ring0 = state.ring.ring.sum(dtype=torch.float64)
            with tally_pops(pops):
                state, rec, learnt = paths.drive(cfg, params, state, ext,
                                                 plastic)
            deposits = (state.ring.ring.sum(dtype=torch.float64) - ring0
                        + sum(pops))
        else:
            state, rec, deposits = run_path(net, cfg, params, ext, device,
                                            c.superstep)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_start
        counts[label] = dict(kc.launches)
        print(f"[{label}] {c.n_chips} chips x {c.neurons_per_chip} "
              f"{cfg.neuron_model}, {cfg.comm_mode}, fan-out {c.fanout}, "
              f"{c.mode}, bpc {c.buckets_per_chip}, merge_rate "
              f"{c.merge_rate}, B {c.superstep}, T {ext.shape[0]}"
              f"{', STDP' if plastic else ''}: {ext.shape[0] / wall:.2f} "
              f"steps/s ({wall:.3f} s); launches {counts[label]}")
        s = rec.stats
        print(f"[{label}] spikes {int(rec.spikes.sum())}, sent "
              f"{int(s.sent.sum())}, overflow {int(s.overflow.sum())}, "
              f"expired {int(s.expired.sum())}, merge_dropped "
              f"{int(s.merge_dropped.sum())}, stalled "
              f"{int(s.stalled.sum())}, mean utilization "
              f"{float(s.utilization.mean()):.4f}")
        check_record(label, rec, ext.shape[0], c.n_chips, c.neurons_per_chip)
        if label == "dense":
            check_dense_delivery(cfg, params, rec, deposits)
            gradient_steps(paths, cfg, params, ext)
        else:
            check_conservation(label, state, rec, int(deposits))
        if label == "pipelined":
            check_pipelined(paths, device, state, rec)
        if label == "flow":
            queued = int(state.sendq.occupancy().sum())
            print(f"[flow] credit gate: {int(s.stalled.sum())} words stalled "
                  f"past the send queue, {queued} still queued at the end, "
                  f"{int(state.flow.notifications.sum())} credit "
                  f"notifications")
            if int(s.stalled.sum()) == 0 and queued == 0:
                raise AssertionError("flow: the credit gate never bound")
        if cfg.topology is not None:
            plan = tpo.compile_routes(cfg.topology, cfg.healthy,
                                      cfg.dead_links)
            print(f"[{label}] {cfg.topology.kind} {cfg.topology.dims or ''}"
                  f" max path latency {int(plan.latency.max())}: "
                  f"link_words {tuple(s.link_words.shape)}, per port "
                  f"{s.link_words.sum((0, 1)).tolist()}, backlog "
                  f"{int(s.link_backlog.sum())}, lost_to_failure "
                  f"{int(s.lost_to_failure.sum())}")
        if label == "routed":
            check_compensated(paths, device)
        if label == "degraded":
            dead = list(DEAD_CHIPS)
            touching = [int(s.traffic[:, :, dead].sum()),
                        int(s.traffic[:, dead].sum()),
                        int(s.link_words[:, dead].sum())]
            print(f"[degraded] chips {dead} dead, link {CUT_LINKS} cut: "
                  f"{int(s.lost_to_failure.sum())} words lost to failure; "
                  f"traffic to / from the dead chips and their link words "
                  f"{touching}")
            if int(s.lost_to_failure.sum()) == 0 or any(touching):
                raise AssertionError("degraded: nothing lost, or traffic "
                                     "touched a dead chip")
        if plastic:
            w = learnt.crossbar.w
            if not bool(torch.isfinite(w).all()):
                raise AssertionError("plastic: non-finite weights")
            moved = float((w - params.crossbar.w).abs().max())
            print(f"[plastic] weights moved by up to {moved:.5f}, now in "
                  f"[{float(w.min()):.4f}, {float(w.max()):.4f}]")
            if moved == 0:
                raise AssertionError("plastic: STDP changed no weight")
        for k in needs:
            if counts[label][k] == 0:
                raise AssertionError(f"{label}: kernel {k} never launched")
        counts[label]["steps_per_s"] = ext.shape[0] / wall
    return counts


def check_pipelined(paths: Paths, device, state, rec, blocks: int = 4):
    """The pipelined run against the serial run of the same config and
    LUT on the card (spikes, ring, every integer stat bitwise); then a
    streaming drive of ``pipeline_block`` calls on the run's own events,
    whose conservation closes with the in-flight leg, and its flush."""
    from types import SimpleNamespace

    from repro_torch.core import delays as dl
    from repro_torch.core import events as ev
    from repro_torch.core import fabric as fb

    net, c = paths.net, paths.pipe_cfg.comm
    serial = dataclasses.replace(paths.pipe_cfg, pipeline=False)
    sstate, srec = net.run(serial, paths.pipe_params,
                           net.init_state(serial, paths.pipe_params,
                                          device=device),
                           paths.ff_ext, device=device)
    same = [torch.equal(srec.spikes, rec.spikes),
            torch.equal(sstate.ring.ring, state.ring.ring)]
    same += [torch.equal(getattr(srec.stats, f), getattr(rec.stats, f))
             for f in rec.stats._fields if f != "utilization"]
    if not all(same):
        raise AssertionError("pipelined: differs from the serial run")
    print(f"[pipelined] equals the serial run on the card: spikes, ring "
          f"and every integer stat ({int(rec.stats.sent.sum())} sent); "
          f"the carry is empty after the run "
          f"({int(state.pending.occupancy().sum())} in flight)")

    b = c.superstep
    fabric = fb.PulseFabric(c, device=device)
    ring = dl.init(c.ring_depth, c.n_inputs_per_chip,
                   batch_shape=(c.n_chips,), device=device)
    merge, pending, stats = fabric.init_merge(), None, []
    for f in range(blocks):
        bufs = [ev.from_spikes(rec.spikes[t] > 0.5, t, c.event_capacity)[0]
                for t in range(f * b, (f + 1) * b)]
        res = fabric.pipeline_block(
            ev.EventBuffer(*(torch.stack(x) for x in zip(*bufs))),
            paths.pipe_params.table, ring, None, merge, None, pending)
        ring = dl.DelayRing(ring=res.ring.ring, now=res.ring.now + b)
        merge, pending = res.merge, res.pending
        stats.append(res.stats)
    cat = lambda xs: type(xs[0])(*(torch.cat(v) for v in zip(*xs)))  # noqa
    in_flight = int(pending.occupancy().sum())
    if in_flight == 0:
        raise AssertionError("pipelined streaming: the carry is empty")
    check_conservation(
        f"pipelined streaming, {blocks} blocks",
        SimpleNamespace(merge=merge, sendq=None),
        SimpleNamespace(stats=cat(stats)), ring.ring.sum(dtype=torch.int64),
        carried=pending)
    res = fabric.flush_pending(ring, pending, None, merge)
    if int(res.pending.occupancy().sum()) != 0:
        raise AssertionError("pipelined: the flush left words in flight")
    check_conservation(
        "pipelined streaming, flushed",
        SimpleNamespace(merge=res.merge, sendq=None),
        SimpleNamespace(stats=cat(stats + [res.stats])),
        res.ring.ring.sum(dtype=torch.int64))


def check_compensated(paths: Paths, device):
    """The reference's acceptance identity at full width: the routed
    path's widths in simplified mode (1 bucket per chip) equal, spike for
    spike, a run on the dense transport whose LUT delays are raised by
    the path latency ``latency[src, dest]``."""
    from repro_torch.core import topology as tpo
    from repro_torch.snn import network as net

    topo = paths.routed_cfg.topology
    comm = dataclasses.replace(paths.ff_cfg.comm, mode="simplified",
                               buckets_per_chip=1)
    routed = dataclasses.replace(paths.routed_cfg, comm=comm)
    dense = dataclasses.replace(routed, topology=None)
    table = paths.ff_params.table
    n = comm.n_chips
    lat = torch.as_tensor(tpo.compile_routes(topo).latency, device=device)
    comp = paths.ff_params._replace(table=table._replace(
        delay=table.delay + lat[torch.arange(n, device=device)[:, None, None],
                                table.dest_chip.long()]))
    out = []
    for cfg, params in ((routed, paths.ff_params), (dense, comp)):
        _, rec = net.run(cfg, params, net.init_state(cfg, params,
                                                     device=device),
                         paths.ff_ext, device=device)
        out.append(rec)
    if not torch.equal(out[0].spikes, out[1].spikes):
        raise AssertionError("routed: spikes differ from the dense run with "
                             "latency-compensated delays")
    print(f"[routed] simplified, 1 bucket per chip: "
          f"{int(out[0].spikes.sum())} spikes equal, spike for spike, the "
          f"dense-transport run with delays raised by latency[src, dest] "
          f"({int(out[0].stats.sent.sum())} sent)")


def check_dense_delivery(cfg, params, rec, deposits):
    """Infinite capacity: every spike reaches the rings once for each LUT
    entry that is valid, in range and has a delay in [1, D]."""
    tbl, c = params.table, cfg.comm
    ok = (tbl.valid.bool() & (tbl.delay >= 1) & (tbl.delay <= c.ring_depth)
          & (tbl.dest_chip >= -c.n_chips) & (tbl.dest_chip < c.n_chips))
    want = (rec.spikes.double() * ok.sum(-1).double()).sum()
    print(f"[dense] delivered {float(deposits):.0f} spikes into the rings, "
          f"{float(want):.0f} expected from {int(rec.spikes.sum())} spikes")
    if float(deposits) != float(want) or float(want) == 0:
        raise AssertionError("dense: delivery does not match the LUT")


def check_against_cpu(paths: Paths, label, cfg, params, ext, plastic):
    """The path's first steps on the card against the plain versions on
    the CPU from the same weights: spikes equal, on the event paths every
    integer stat, the ring and the carries (credits, send and merge
    queues) bitwise, learnt weights within 1e-5, and each neuron's
    voltage within 1e-5 of the largest |v| on its own trajectory (at
    least 1).  The card's expf and the CPU's exp may
    differ in the last bit, and the card sums the crossbar in another
    order once STDP has made the weights non-dyadic; a neuron's voltage
    keeps such an ulp of its largest value through the leak and through
    cancelling currents."""
    t = PLAIN_CHECK_STEPS
    cpu = torch.device("cpu")
    cpu_params = type(params)(*(tree_to(x, cpu) for x in params))
    out = {}
    for dev, p in ((paths.device, params), (cpu, cpu_params)):
        state = paths.net.init_state(cfg, p, device=dev)
        final, rec, learnt = paths.drive(cfg, p, state, ext[:t].to(dev),
                                         plastic, device=dev)
        out[dev.type] = (rec, learnt, final)
    (grec, gp, gfinal), (crec, cp, cfinal) = out["cuda"], out["cpu"]
    if not torch.equal(grec.spikes.cpu(), crec.spikes):
        raise AssertionError(f"{label}: spikes differ from the CPU run")
    if cfg.comm_mode == "event":
        pairs = [(getattr(grec.stats, f), getattr(crec.stats, f))
                 for f in crec.stats._fields if f != "utilization"]
        for name in ("ring", "flow", "sendq", "merge"):
            if getattr(cfinal, name) is not None:
                pairs += zip(getattr(gfinal, name), getattr(cfinal, name))
        if not all(torch.equal(g.cpu(), w) for g, w in pairs):
            raise AssertionError(f"{label}: stats, ring or carries differ "
                                 f"from the CPU run")
    scale = crec.voltage.abs().amax(0, keepdim=True).clamp(min=1.0)
    rel = float(((grec.voltage.cpu() - crec.voltage).abs() / scale).max())
    dw = float((gp.crossbar.w.cpu() - cp.crossbar.w).abs().max())
    if rel > 1e-5 or dw > 1e-5:
        raise AssertionError(f"{label}: voltage {rel} (of each neuron's "
                             f"largest |v|) / weights {dw} differ from the "
                             f"CPU run")
    print(f"[{label}] first {t} steps equal the plain CPU run: "
          f"{int(crec.spikes.sum())} spikes equal"
          + (", integer stats, ring and carries bitwise"
             if cfg.comm_mode == "event" else "")
          + f", max |dv| / max|v| "
          f"{rel:.3g} (|v| up to {float(scale.max()):.4g}), max |dw| "
          f"{dw:.3g}")


def tree_to(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return type(x)(*(tree_to(v, device) for v in x))


def gradient_steps(paths: Paths, cfg, params, ext, steps: int = 3,
                   t: int = PLAIN_CHECK_STEPS, lr: float = 5.0):
    """Surrogate-gradient descent on the dense path: the squared distance
    of the mean firing rate from 0.05 over ``t`` steps, ``steps`` times."""
    from repro_torch.snn import synapse as sy

    w = params.crossbar.w.clone().requires_grad_()
    losses = []
    t_start = time.perf_counter()
    for _ in range(steps):
        p = params._replace(crossbar=sy.Crossbar(w=w))
        state = paths.net.init_state(cfg, p, device=paths.device)
        _, rec = paths.net.run(cfg, p, state, ext[:t], device=paths.device)
        loss = (rec.spikes.mean() - 0.05) ** 2
        (g,) = torch.autograd.grad(loss, w)
        if not bool(torch.isfinite(g).all()) or float(g.abs().sum()) == 0:
            raise AssertionError("dense: the gradient is not finite and "
                                 "nonzero")
        losses.append(float(loss.detach()))
        w = (w - lr * g).detach().requires_grad_()
    torch.cuda.synchronize()
    print(f"[dense] {steps} surrogate-gradient steps at T {t}: loss "
          f"{' -> '.join(f'{x:.6g}' for x in losses)}, |grad| finite and "
          f"nonzero ({(time.perf_counter() - t_start) / steps:.3f} s/step)")


RESILIENT_FAILURES = ((7, 13), (30, 22))
RESILIENT_STEPS = 32
RESILIENT_EVERY = 4
FLIGHT_DEPTH = 16
# The phase scopes (``repro_torch.obs.phase_scope``) whose device time the
# profile phase reads; their annotations are not kernels.
SCOPES = ("fabric/inject", "fabric/exchange", "fabric/drain", "fabric/flush",
          "pulse_comm/exchange_issue", "pulse_comm/exchange_complete",
          "obs/metrics_update", "fabric/recovery_dump")


def drill_fns(net, cfg, params, injector, ext, device):
    """The drill's ``(make_step, detect)``, as tests/test_resilience.py
    builds them: inputs masked by the true alive mask, the dead chips'
    neuron and ring rows frozen, the network rebuilt with ``healthy=``
    on the survivors; detection from the injector's schedule."""
    from repro_torch.core import resilience as rsl

    def make_step(healthy):
        hcfg = dataclasses.replace(cfg, healthy=tuple(healthy))

        def step_fn(state, t):
            alive = injector.alive_at(t, device=device)
            new_state, rec = net.step(hcfg, params, state,
                                      ext[t] * alive[:, None], device=device)
            fzn, fzr = rsl.freeze(alive, (state.neuron, state.ring),
                                  (new_state.neuron, new_state.ring))
            new_state = new_state._replace(neuron=fzn, ring=fzr)
            return new_state, rec._replace(
                spikes=rec.spikes * alive[:, None].to(rec.spikes.dtype))
        return step_fn

    def detect(state, t, healthy):
        surviving = tuple(c for c in injector.healthy_after(t)
                          if c in healthy)
        return surviving if surviving != tuple(healthy) else None

    return make_step, detect


def run_drill(paths: Paths, device, workdir: Path) -> dict:
    """The resilient path on ``device``: ``ResilientRunner`` over T 32
    steps with checkpoints every 4, chips 7 and 30 killed at steps 13 and
    22.  Each rebuild after a failure also restores the checkpoint it
    resumes from, for the uninterrupted reference runs."""
    from repro_torch import checkpoint as ckpt
    from repro_torch.core import resilience as rsl
    from repro_torch.runtime import ResilientRunner

    cfg = paths.resilient_cfg
    params = tree_to(paths.ff_params, device)
    injector = rsl.FabricFaultInjector(n_chips=cfg.comm.n_chips,
                                       chip_failures=RESILIENT_FAILURES)
    make_step, detect = drill_fns(paths.net, cfg, params, injector,
                                  paths.ff_ext.to(device), device)
    state0 = paths.net.init_state(cfg, params, device=device)
    ckpt_dir, flight_dir = workdir / "ckpt", workdir / "flight"
    flight_dir.mkdir(parents=True)
    resumes = {}

    def rebuild(healthy):
        last = ckpt.latest_step(str(ckpt_dir))
        if last is not None and len(healthy) < cfg.comm.n_chips:
            resumes[healthy] = (last + 1, ckpt.restore(
                str(ckpt_dir), last, ckpt.tree_map(torch.zeros_like,
                                                   state0)))
        return make_step(healthy)

    runner = ResilientRunner(
        make_step=rebuild, detect=detect, ckpt_dir=str(ckpt_dir),
        n_chips=cfg.comm.n_chips, ckpt_every=RESILIENT_EVERY,
        flight_of=lambda s: s.metrics.flight, flight_dir=str(flight_dir))
    t_start = time.perf_counter()
    final, healthy = runner.run(state0, RESILIENT_STEPS)
    if device.type == "cuda":
        torch.cuda.synchronize()
    return dict(runner=runner, final=final, healthy=healthy, state0=state0,
                resumes=resumes, make_step=make_step,
                wall=time.perf_counter() - t_start)


def _int_stats_equal(a, b) -> bool:
    return all(torch.equal(getattr(a, f).cpu(), getattr(b, f).cpu())
               for f in a._fields if f != "utilization")


def _flight_row_of(stats, t0: int) -> dict:
    """The flight-ring row a B-1 step's ``CommStats`` gives (per-chip
    fields, link words and the end-of-step backlog summed over ports)."""
    from repro_torch.obs import metrics as obm

    row = {f: getattr(stats, f).tolist() for f in obm.SCALAR_FIELDS}
    row["link_words"] = stats.link_words.sum(-1).tolist()
    row["link_backlog"] = stats.link_backlog.sum(-1).tolist()
    return row


def check_states_close(label: str, got, want):
    """Every leaf of two states: integers bitwise; voltages within 1e-5 of
    max(|v|, 1); other floats (the telemetry EMAs) within 1e-6
    relative."""
    from repro_torch import checkpoint as ckpt

    g, w = ckpt.tree_flatten_with_path(got)[0], ckpt.tree_leaves(want)
    if len(g) != len(w):
        raise AssertionError(f"{label}: {len(g)} leaves vs {len(w)}")
    worst = 0.0
    for (path, a), b in zip(g, w):
        a, b = a.cpu(), b.cpu()
        name = "/".join(map(str, path))
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"{label}: {name} {a.dtype}"
                                 f"{tuple(a.shape)} vs {b.dtype}"
                                 f"{tuple(b.shape)}")
        if not a.dtype.is_floating_point:
            if not torch.equal(a, b):
                raise AssertionError(f"{label}: {name} differs")
            continue
        scale = (b.abs().clamp(min=1.0) if name == "neuron/v"
                 else b.abs().clamp(min=1e-30))
        tol = 1e-5 if name == "neuron/v" else 1e-6
        rel = float(((a.double() - b.double()).abs() / scale).max()) \
            if a.numel() else 0.0
        worst = max(worst, rel)
        if rel > tol:
            raise AssertionError(f"{label}: {name} differs by {rel:.3g} "
                                 f"relative (tolerance {tol:g})")
    return worst


def resilient_phase(paths: Paths, device) -> dict:
    """The slice's main path: the wafer-width network under
    ``ResilientRunner`` through two chip failures, counters zeroed just
    before; then its checks against uninterrupted runs on the survivors,
    the flight dumps, the same drill on the CPU, and the checkpoint's
    cost.  Returns the drill's launches per kernel."""
    import tempfile

    from repro_torch import checkpoint as ckpt
    from repro_torch import obs
    from repro_torch.kernels import common as kc
    from repro_torch.kernels.fused_inject import ops as fi_ops
    from repro_torch.runtime import RecoveryEvent

    cfg, c = paths.resilient_cfg, paths.resilient_cfg.comm
    n = c.n_chips
    libs = dict(kc._libs)
    built = {p: p.stat().st_mtime_ns for p in kc.build_dir().glob("*.so")}
    reach_calls = []
    orig_inject = fi_ops.fused_inject

    def inject(*args, **kwargs):
        reach_calls.append(kwargs.get("reach") is not None)
        return orig_inject(*args, **kwargs)

    with tempfile.TemporaryDirectory() as tmp:
        workdir = Path(tmp)
        torch.cuda.synchronize()
        kc.reset_launches()
        fi_ops.fused_inject = inject
        try:
            card = run_drill(paths, device, workdir / "card")
        finally:
            fi_ops.fused_inject = orig_inject
        counts = dict(kc.launches)
        runner = card["runner"]
        steps_run = RESILIENT_STEPS + sum(
            r.detected_at - r.resumed_from + 1 for r in runner.recoveries)
        print(f"[resilient] {n} chips x {c.neurons_per_chip} "
              f"{cfg.neuron_model}, {cfg.topology.kind} "
              f"{cfg.topology.dims}, {c.mode}, bpc {c.buckets_per_chip}, "
              f"merge_rate {c.merge_rate}, B {c.superstep}, T "
              f"{RESILIENT_STEPS}, checkpoints every {RESILIENT_EVERY}, "
              f"chips killed {RESILIENT_FAILURES}: {steps_run} steps run "
              f"in {card['wall']:.3f} s; launches {counts}; fused_inject "
              f"with a reach row {sum(reach_calls)} of {len(reach_calls)} "
              f"calls")
        for k in ("fused_inject", "fused_drain", "lif_step"):
            if counts[k] == 0:
                raise AssertionError(f"resilient: kernel {k} never launched")
        if not any(reach_calls):
            raise AssertionError("resilient: fused_inject never ran with a "
                                 "reach row")
        if dict(kc._libs) != libs or {
                p: p.stat().st_mtime_ns
                for p in kc.build_dir().glob("*.so")} != built:
            raise AssertionError("resilient: a rebuild of the fabric built "
                                 "or loaded a kernel library again")

        h1 = tuple(i for i in range(n) if i != 7)
        h2 = tuple(i for i in range(n) if i not in (7, 30))
        want = [RecoveryEvent(13, 12, h1), RecoveryEvent(22, 20, h2)]
        print(f"[resilient] recoveries (detected at, resumed from, "
              f"survivors): {[(r.detected_at, r.resumed_from, len(r.healthy)) for r in runner.recoveries]}")
        if runner.recoveries != want or card["healthy"] != h2:
            raise AssertionError(f"resilient: recoveries "
                                 f"{runner.recoveries}, not {want}")
        if sorted(runner.records) != list(range(RESILIENT_STEPS)):
            raise AssertionError("resilient: records do not cover T")

        # From each resume point: an uninterrupted run on the survivors
        # from the same checkpoint; its steps up to the next resume point
        # are the records (the failing trajectory's later steps feed the
        # second flight dump).
        make_step = card["make_step"]
        records, ref_stats = runner.records, {}
        state = card["state0"]
        full = make_step(tuple(range(n)))
        for t in range(13 + 1):
            state, rec = full(state, t)
            ref_stats[("full", t)] = rec.stats
        ends = {h1: (20, 22), h2: (RESILIENT_STEPS, RESILIENT_STEPS - 1)}
        for healthy, (resume, state) in card["resumes"].items():
            step_fn = make_step(healthy)
            upto, last = ends[healthy]
            for t in range(resume, last + 1):
                state, rec = step_fn(state, t)
                ref_stats[(healthy, t)] = rec.stats
                if t < upto and not (
                        torch.equal(rec.spikes, records[t].spikes)
                        and _int_stats_equal(rec.stats, records[t].stats)):
                    raise AssertionError(f"resilient: step {t} differs from "
                                         f"the uninterrupted run on "
                                         f"{len(healthy)} chips")
            print(f"[resilient] steps {resume} to {upto - 1} equal an "
                  f"uninterrupted run on {len(healthy)} chips from the "
                  f"step-{resume - 1} checkpoint (spikes, every integer "
                  f"stat)")
        check_states_close("resilient final state vs the uninterrupted run",
                           card["final"], state)
        for chip, kill in RESILIENT_FAILURES:
            late = sum(int(records[t].spikes[chip].sum())
                       for t in range(kill, RESILIENT_STEPS))
            if late:
                raise AssertionError(f"resilient: chip {chip} spiked after "
                                     f"its kill at {kill}")
        s = {f: sum(int(getattr(records[t].stats, f).sum())
                    for t in records) for f in ("sent", "lost_to_failure",
                                                "expired", "merge_dropped")}
        spikes = sum(int(records[t].spikes.sum()) for t in records)
        print(f"[resilient] {spikes} spikes, {s['sent']} sent, "
              f"{s['lost_to_failure']} lost to failure, {s['expired']} "
              f"expired, {s['merge_dropped']} merge_dropped over the "
              f"records; no spike from a dead chip after its kill")
        if s["lost_to_failure"] == 0:
            raise AssertionError("resilient: nothing lost to failure")

        dumps = [obs.load_flight(p) for p in runner.flight_dumps]
        if len(dumps) != 2:
            raise AssertionError(f"resilient: {len(dumps)} flight dumps")
        for dump, failure, trail in zip(dumps, want, (("full",) * 14,
                                                      ("full",) * 12
                                                      + (h1,) * 11)):
            seqs = [b["seq"] for b in dump["blocks"]]
            first = failure.detected_at + 1 - min(FLIGHT_DEPTH,
                                                 failure.detected_at + 1)
            if seqs != list(range(first, failure.detected_at + 1)):
                raise AssertionError(f"resilient: dump blocks {seqs}")
            for b in dump["blocks"]:
                key = (trail[b["seq"]], b["seq"])
                if b["per_chip"] != _flight_row_of(ref_stats[key], b["seq"]):
                    raise AssertionError(f"resilient: flight block "
                                         f"{b['seq']} differs from the "
                                         f"failing trajectory")
            print(f"[resilient] flight dump at step {dump['failure']['step']}"
                  f": blocks {seqs[0]} to {seqs[-1]} equal the failing "
                  f"trajectory's per-step stats; "
                  f"{len(dump['recoveries'])} earlier recoveries")

        t_start = time.perf_counter()
        cpu = run_drill(paths, torch.device("cpu"), workdir / "cpu")
        cpu_s = time.perf_counter() - t_start
        if cpu["runner"].recoveries != runner.recoveries:
            raise AssertionError("resilient: CPU recoveries differ")
        vmax = 0.0
        for t in range(RESILIENT_STEPS):
            g, w = records[t], cpu["runner"].records[t]
            if not (torch.equal(g.spikes.cpu(), w.spikes)
                    and _int_stats_equal(g.stats, w.stats)):
                raise AssertionError(f"resilient: step {t} differs from the "
                                     f"CPU run")
            vmax = max(vmax, float(((g.voltage.cpu() - w.voltage).abs()
                                    / w.voltage.abs().clamp(min=1.0)).max()))
        if vmax > 1e-5:
            raise AssertionError(f"resilient: voltages differ from the CPU "
                                 f"run by {vmax:.3g}")
        worst = check_states_close("resilient final state vs the CPU run",
                                   card["final"], cpu["final"])
        cpu_dumps = [obs.load_flight(p) for p in cpu["runner"].flight_dumps]
        if cpu_dumps != dumps:
            raise AssertionError("resilient: flight dumps differ from the "
                                 "CPU run's")
        print(f"[resilient] the drill on the CPU ({cpu_s:.1f} s): the same "
              f"records (spikes, every integer stat; voltages within "
              f"{vmax:.3g} of max(|v|, 1)), recoveries and final state "
              f"(floats within {worst:.3g} relative); flight dumps equal "
              f"row for row")

        final = card["final"]
        size = nbytes(ckpt.tree_leaves(final))
        save_ms, restore_ms = [], []
        for i in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ckpt.save(final, str(workdir / "timing"), i)
            save_ms.append((time.perf_counter() - t0) * 1e3)
            target = ckpt.tree_map(torch.zeros_like, final)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            back = ckpt.restore(str(workdir / "timing"), i, target)
            torch.cuda.synchronize()
            restore_ms.append((time.perf_counter() - t0) * 1e3)
        compare("checkpoint round trip", back, final)
        on_disk = sum(p.stat().st_size for p in
                      Path(ckpt.step_dir(str(workdir / "timing"), 0)).iterdir())
        print(f"[resilient] checkpoint of the network state: {size} bytes "
              f"in {len(ckpt.tree_leaves(final))} leaves ({on_disk} on "
              f"disk); save ms {[round(x, 3) for x in save_ms]}, restore "
              f"onto the card ms {[round(x, 3) for x in restore_ms]}")
    counts["steps_per_s"] = steps_run / card["wall"]
    counts["checkpoint"] = dict(bytes=size, save_ms=save_ms,
                                restore_ms=restore_ms)
    return counts


def telemetry_phase(paths: Paths, device) -> dict:
    """Telemetry on the feedforward (B 8) and pipelined paths: on equals
    off on the card (spikes, ring, every stat), the carry after 16 steps
    equals the CPU's, and ``check_conservation`` closes from
    ``metrics_summary``'s totals with the queued and in-flight legs."""
    from repro_torch import obs

    net, out = paths.net, {}
    for label, cfg, params in (
            ("feedforward", paths.ff_cfg, paths.ff_params),
            ("pipelined", paths.pipe_cfg, paths.pipe_params)):
        on = dataclasses.replace(cfg, telemetry=True)
        ext = paths.ff_ext
        runs = {}
        for name, ccfg in (("off", cfg), ("on", on)):
            state = net.init_state(ccfg, params, device=device)
            ring0 = state.ring.ring.sum(dtype=torch.float64)
            pops = []
            with tally_pops(pops):
                final, rec = net.run(ccfg, params, state, ext, device=device)
            deposits = (final.ring.ring.sum(dtype=torch.float64) - ring0
                        + sum(pops))
            runs[name] = (final, rec, deposits)
        (foff, roff, _), (fon, ron, deposits) = runs["off"], runs["on"]
        same = [torch.equal(roff.spikes, ron.spikes),
                torch.equal(foff.ring.ring, fon.ring.ring)]
        same += [torch.equal(getattr(roff.stats, f), getattr(ron.stats, f))
                 for f in roff.stats._fields]
        if not all(same):
            raise AssertionError(f"telemetry {label}: the run with "
                                 f"telemetry differs from the run without")
        summary = obs.metrics_summary(fon.metrics)
        queued = fon.merge.occupancy() if fon.merge is not None else 0
        in_flight = (fon.pending.occupancy() if fon.pending is not None
                     else 0)
        report = obs.check_conservation(
            summary["totals"], delivered=int(deposits), queued=queued,
            in_flight=in_flight)
        carries = []
        for dev in (device, torch.device("cpu")):
            p = tree_to(params, dev)
            final, _ = net.run(on, p, net.init_state(on, p, device=dev),
                               ext[:PLAIN_CHECK_STEPS].to(dev), device=dev)
            carries.append(final.metrics)
        worst = check_states_close(f"telemetry {label}: carry vs the CPU",
                                   *carries)
        print(f"[telemetry] {label}: telemetry on equals off on the card "
              f"(spikes, ring, every stat); {summary['steps']} substeps in "
              f"{summary['blocks']} fabric calls; conservation from the "
              f"carry's totals: injected {report.injected} == delivered "
              f"{report.delivered} + queued {report.queued} + in flight "
              f"{report.in_flight} + dropped {sum(report.legs.values())}; "
              f"the carry after {PLAIN_CHECK_STEPS} steps equals the CPU's "
              f"(integers bitwise, floats within {worst:.3g} relative)")
        out[label] = dict(totals=summary["totals"], ema=summary["ema"])
        if label == "feedforward":
            out["ab"] = telemetry_ab(paths, device, cfg, on, params, ext,
                                     fon, ron)
    return out


def telemetry_ab(paths: Paths, device, off, on, params, ext, state,
                 rec) -> dict:
    """Wall ms per step of the feedforward path without and with
    telemetry, in turns (off, on, on, off, after a warm-up of each), and
    the host µs of one ``metrics_update`` call on a block's stats."""
    from repro_torch import obs

    net, walls = paths.net, {"off": [], "on": []}
    for name, ccfg in (("off", off), ("on", on)):
        net.run(ccfg, params, net.init_state(ccfg, params, device=device),
                ext[:16], device=device)
    for name in ("off", "on", "on", "off"):
        ccfg = on if name == "on" else off
        state0 = net.init_state(ccfg, params, device=device)
        torch.cuda.synchronize()
        t_start = time.perf_counter()
        net.run(ccfg, params, state0, ext, device=device)
        torch.cuda.synchronize()
        walls[name].append((time.perf_counter() - t_start) * 1e3
                           / ext.shape[0])
    b = off.comm.superstep
    stats = type(rec.stats)(*(x[:b] for x in rec.stats))
    mcfg = obs.MetricsConfig()
    us = host_us(lambda: obs.metrics_update(mcfg, state.metrics, stats,
                                            merge=state.merge))
    print(f"[telemetry] feedforward wall ms/step in turns: off "
          f"{walls['off'][0]:.4f}, on {walls['on'][0]:.4f}, on "
          f"{walls['on'][1]:.4f}, off {walls['off'][1]:.4f}; host µs per "
          f"metrics_update call {us:.2f} (1000 calls, one synchronise)")
    return dict(wall_ms_per_step=walls, metrics_update_host_us=us)


def profile_row(prof, wall: float, units: float) -> dict:
    """Per unit (a step, a prefill, a decode step) of a profiled window:
    wall and device busy time (sum of kernel times on the one stream),
    the idle share, kernel launches and the costliest kernels."""
    kernels = [e for e in prof.key_averages()
               if str(getattr(e, "device_type", "")).endswith("CUDA")
               and e.key not in SCOPES and not e.key.startswith("serve/")]
    dev_us = lambda e: (getattr(e, "self_device_time_total", None)  # noqa: E731
                        or getattr(e, "device_time_total", 0.0))
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3
    top = sorted(kernels, key=dev_us, reverse=True)[:5]
    return dict(
        wall_ms_per_step=wall * 1e3 / units,
        device_busy_ms_per_step=busy_ms / units,
        idle_share=1.0 - busy_ms / (wall * 1e3),
        kernel_launches_per_step=sum(e.count for e in kernels) / units,
        top_kernels=[(e.key[:60], dev_us(e) / 1e3 / units) for e in top],
        scopes=scope_ms(prof, units))


def scope_ms(prof, units: float) -> dict:
    """Device ms and launches per unit under each phase scope that ran,
    from the profile's trace: every kernel, copy or fill whose launch
    (the CUDA runtime or driver call, matched to it by its correlation
    id) lies inside one of the scope's host-side ranges.  The kernels of
    the ctypes launchers belong to no PyTorch op, so the annotations'
    own ``device_time_total`` misses them."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        trace = json.loads(path.read_text())
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    ranges, calls, device_us = {}, [], {}
    for e in events:
        cat, args = e.get("cat", ""), e.get("args") or {}
        if e.get("ph") != "X":
            continue
        if cat == "user_annotation" and e.get("name") in SCOPES:
            ranges.setdefault(e["name"], []).append(
                (e.get("tid"), e["ts"], e["ts"] + e.get("dur", 0.0)))
        elif cat in ("cuda_runtime", "cuda_driver") and "correlation" in args:
            calls.append((e.get("tid"), e["ts"], args["correlation"]))
        elif cat in ("kernel", "gpu_memcpy", "gpu_memset") \
                and "correlation" in args:
            c = args["correlation"]
            device_us[c] = device_us.get(c, 0.0) + e.get("dur", 0.0)
    out = {}
    for name, spans in ranges.items():
        us, n = 0.0, 0
        for tid, t0, t1 in spans:
            for ctid, ts, corr in calls:
                if ctid == tid and t0 <= ts <= t1 and corr in device_us:
                    us += device_us[corr]
                    n += 1
        out[name] = dict(ms=us / 1e3 / units, launches=n / units)
    return {name: out[name] for name in SCOPES if name in out}


def print_profile(label: str, row: dict, unit: str = "step") -> None:
    print(f"[profile] {label}: {row['wall_ms_per_step']:.4f} ms/{unit} "
          f"wall, device busy {row['device_busy_ms_per_step']:.4f} "
          f"ms/{unit}, idle share {row['idle_share']:.4f}, "
          f"{row['kernel_launches_per_step']:.1f} kernel launches/{unit}")
    for name, ms in row["top_kernels"]:
        print(f"[profile] {label}:   {ms:.5f} ms/{unit}  {name}")
    for name, sc in row.get("scopes", {}).items():
        print(f"[profile] {label}:   scope {name}: {sc['ms']:.5f} ms/{unit} "
              f"device, {sc['launches']:.1f} launches/{unit}")


PROFILER_ACTS = [torch.profiler.ProfilerActivity.CPU,
                 torch.profiler.ProfilerActivity.CUDA]


def profile_phase(paths: Paths, device, blocks: int = 4) -> dict:
    """Where a block's time goes: torch.profiler over ``blocks`` blocks of
    each path (after one warm-up block), per step; the feedforward path
    again with telemetry on; and 8 steps of the resilient path on the
    survivors of both failures."""
    from repro_torch.core import resilience as rsl

    net = paths.net
    out = {}
    runs = list(paths.runs())
    ff = next(r for r in runs if r[0] == "feedforward")
    runs.append(("feedforward+telemetry",
                 dataclasses.replace(ff[1], telemetry=True)) + ff[2:])
    for label, cfg, params, ext, _, plastic in runs:
        b = cfg.comm.superstep if cfg.comm_mode == "event" else 8
        n_blocks = min(blocks, ext.shape[0] // b - 1)
        state = net.init_state(cfg, params, device=device)
        state, _, params = paths.drive(cfg, params, state, ext[:b], plastic)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=PROFILER_ACTS) as prof:
            t_start = time.perf_counter()
            # A pipelined run is one call (its stages, then one flush);
            # the others take a call per block.
            for i, j in ([(1, n_blocks + 1)] if cfg.pipeline else
                         [(i, i + 1) for i in range(1, n_blocks + 1)]):
                state, _, params = paths.drive(cfg, params, state,
                                               ext[i * b:j * b], plastic)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t_start
        out[label] = profile_row(prof, wall, n_blocks * b)
        print_profile(label, out[label])

    cfg = paths.resilient_cfg
    survivors = tuple(i for i in range(cfg.comm.n_chips)
                      if i not in (7, 30))
    injector = rsl.FabricFaultInjector(n_chips=cfg.comm.n_chips,
                                       chip_failures=RESILIENT_FAILURES)
    step_fn = drill_fns(net, cfg, paths.ff_params, injector, paths.ff_ext,
                        device)[0](survivors)
    state = net.init_state(cfg, paths.ff_params, device=device)
    state, _ = step_fn(state, 23)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=PROFILER_ACTS) as prof:
        t_start = time.perf_counter()
        for t in range(24, 32):
            state, _ = step_fn(state, t)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_start
    out["resilient"] = profile_row(prof, wall, 8)
    print_profile("resilient (44 survivors)", out["resilient"])
    return out


def serve_check(device, seed: int, prompt: int = 300,
                steps: int = 8) -> dict:
    """zamba2-2.7b at full width, one pattern repeat (6 layers: five
    Mamba-2 blocks, then the shared attention+MLP block and a sixth),
    float32, batch 1: prefill and ``steps`` teacher-forced decode steps on
    the card (kernels) and on the CPU (plain versions) from the same
    weights and tokens.  Every step's logits agree within 1e-3 of the
    largest |logit| (f32 sums in another order through six layers)."""
    from repro_torch import configs as C
    from repro_torch.kernels import common as kc
    from repro_torch.models import lm
    from repro_torch.models import spec as sp

    cfg = dataclasses.replace(C.get("zamba2-2.7b"), n_layers=6,
                              dtype="float32")
    params = lm.init(torch.Generator().manual_seed(seed), cfg, device="cpu")
    rng = np.random.default_rng(seed)
    tokens = torch.as_tensor(rng.integers(
        0, cfg.vocab_size, (1, prompt + steps)).astype(np.int32))
    out = {}
    for dev in (device, torch.device("cpu")):
        p = sp.tree_map(lambda x: x.to(dev), params)
        tk = tokens.to(dev)
        torch.cuda.synchronize()
        kc.reset_launches()
        t_start = time.perf_counter()
        with torch.no_grad():
            last, cache = lm.prefill(cfg, p, {"tokens": tk[:, :prompt]})
            cache = lm.pad_cache(cfg, cache, prompt + steps)
            rows = [last]
            for i in range(steps):
                lg, cache = lm.decode(cfg, p, tk[:, prompt + i], cache,
                                      prompt + i)
                rows.append(lg)
        logits = torch.cat(rows).float().cpu()
        out[dev.type] = (logits, time.perf_counter() - t_start,
                         dict(kc.launches))
        del p, cache
    (gpu, t_gpu, counts), (cpu, t_cpu, _) = out["cuda"], out["cpu"]
    if counts["flash_attention"] != 1 or counts["ssm_scan"] != 6:
        raise AssertionError(f"serve-check: launches {counts}")
    scale = float(cpu.abs().max())
    err = (gpu - cpu).abs().amax(dim=-1)
    agree = int((gpu.argmax(-1) == cpu.argmax(-1)).sum())
    print(f"[serve-check] zamba2-2.7b full width, 6 layers, f32, batch 1, "
          f"prompt {prompt}, {steps} teacher-forced steps: card "
          f"{t_gpu:.2f} s, CPU {t_cpu:.2f} s; max |dlogit| per step "
          f"{[float(f'{e:.3g}') for e in err]} vs max |logit| "
          f"{scale:.4g} (rel {float(err.max()) / scale:.3g}); greedy tokens "
          f"equal {agree}/{steps + 1}; launches flash_attention "
          f"{counts['flash_attention']}, ssm_scan {counts['ssm_scan']}")
    if not bool(torch.isfinite(gpu).all()) or float(err.max()) > 1e-3 * scale:
        raise AssertionError("serve-check: the card's logits differ from "
                             "the CPU's beyond 1e-3 of the largest |logit|")
    return dict(max_rel_err=float(err.max()) / scale, greedy_equal=agree,
                steps=steps + 1, launches=counts)


SERVE_RUNS = (("zamba2-2.7b", 9, 54), ("internlm2-1.8b", 24, 0))
SERVE_ARGS = dict(batch=4, prompt=2048, gen=32)


def serve_phase(device, seed: int) -> tuple[dict, dict, dict]:
    """``launch.serve.main`` at full width and depth on each serve arch,
    then, from the same weights, prefill + one decode step against a full
    forward at the next position, and a profile of one prefill and of 4
    decode steps.  Returns (launches, metrics, profile) by path."""
    import io
    import re

    from repro_torch import configs as C
    from repro_torch.kernels import common as kc
    from repro_torch.launch import serve
    from repro_torch.models import lm

    b, s, n_gen = SERVE_ARGS["batch"], SERVE_ARGS["prompt"], SERVE_ARGS["gen"]
    counts, metrics, profile = {}, {}, {}
    for arch, n_flash, n_scan in SERVE_RUNS:
        label = f"serve {arch}"
        cfg = C.get(arch)
        argv = ["--arch", arch, "--batch", str(b), "--prompt-len", str(s),
                "--gen", str(n_gen), "--seed", str(seed)]
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        kc.reset_launches()
        buf = io.StringIO()
        t_start = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            ids = serve.main(argv)
        wall = time.perf_counter() - t_start
        counts[label] = dict(kc.launches)
        peak = torch.cuda.max_memory_allocated()
        text = buf.getvalue()
        for line in text.splitlines():
            print(f"[{label}] {line}")
        pre_ms = float(re.search(r"prefill: \S+ in ([\d.]+) ms", text)[1])
        dec_ms = float(re.search(r"decode: .* in ([\d.]+) ms", text)[1])
        row = dict(prefill_ms=pre_ms, prefill_tok_s=b * s / pre_ms * 1e3,
                   decode_ms=dec_ms, decode_tok_s=b * n_gen / dec_ms * 1e3,
                   peak_bytes=peak, wall_s=wall)
        print(f"[{label}] {cfg.n_layers} layers, d_model {cfg.d_model}, "
              f"bf16, batch {b}, prompt {s}, {n_gen} tokens: prefill "
              f"{row['prefill_tok_s']:.1f} tok/s, decode "
              f"{row['decode_tok_s']:.2f} tok/s, peak memory {peak} B "
              f"({peak / 2**30:.2f} GiB), {wall:.1f} s in all; launches "
              f"flash_attention {counts[label]['flash_attention']}, "
              f"ssm_scan {counts[label]['ssm_scan']}")
        if (counts[label]["flash_attention"] != n_flash
                or counts[label]["ssm_scan"] != n_scan):
            raise AssertionError(f"{label}: prefill launched "
                                 f"{counts[label]}, expected flash_attention "
                                 f"{n_flash} and ssm_scan {n_scan}")
        if tuple(ids.shape) != (b, n_gen) or not bool(
                ((ids >= 0) & (ids < cfg.vocab_size)).all()):
            raise AssertionError(f"{label}: generated ids {ids.shape}")
        del ids
        # Same weights as serve.main drew (same generator and seed).
        params = lm.init(torch.Generator(device=device).manual_seed(seed),
                         cfg, device=device)
        tokens = torch.randint(
            0, cfg.vocab_size, (b, s + 1), device=device, dtype=torch.int32,
            generator=torch.Generator(device=device).manual_seed(seed + 1))
        consistency(label, cfg, params, tokens)
        profile.update(serve_profile(label, cfg, params, tokens[:, :s]))
        metrics[label] = row
        del params
    return counts, metrics, profile


def next_token_logits(cfg, params, tokens):
    """A full forward's logits at the last two positions S - 1 and S,
    and those of prefill over the first S tokens and one decode step with
    the last token, float32 on the card."""
    from repro_torch.models import lm
    from repro_torch.models import transformer as tfm

    s = tokens.shape[1] - 1
    with torch.no_grad():
        full = tfm.forward(cfg, params, tokens).logits[:, s - 1:].float()
        last, cache = lm.prefill(cfg, params, {"tokens": tokens[:, :s]})
        cache = lm.pad_cache(cfg, cache, s + 1)
        dec, _ = lm.decode(cfg, params, tokens[:, s], cache, s)
    for name, x in (("forward", full), ("prefill", last), ("decode", dec)):
        if not bool(torch.isfinite(x).all()):
            raise AssertionError(f"{cfg.name}: non-finite {name} logits")
    return full, last.float(), dec.float()


def consistency(label: str, cfg, params, tokens) -> None:
    """Prefill + one decode step against a full forward at positions S - 1
    and S, as ``tests/test_models_smoke.py`` checks the JAX model: in
    float32 (the bf16 weights widened, exactly) within 1e-3 of the largest
    |logit| (sums in another order through every layer); in the serving
    type, bf16, within 0.1 of the largest |logit| or within the distance
    of the bf16 forward from the float32 forward at position S, whichever
    is larger.  With random weights a deep model can amplify bf16 rounding
    to differences of the order of the logits themselves (54-layer zamba2
    on an H100 80GB HBM3 at 700 W: 1.05 x max |logit| between the bf16
    and the float32 forward at the next position): two bf16 paths that
    round at other places (cuBLAS picks other kernels for 4 rows than for
    8192; decode attends from the bf16 cache in f32 and steps the SSM
    state in f32) cannot be held closer to each other than either is to
    the exact function."""
    from repro_torch.models import spec as sp

    f16, l16, d16 = next_token_logits(cfg, params, tokens)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p32 = sp.tree_map(lambda x: x.float(), params)
    f32, l32, d32 = next_token_logits(cfg32, p32, tokens)
    del p32
    torch.cuda.empty_cache()
    scale = float(f32.abs().max())
    err = lambda a, b: float((a - b).abs().max())  # noqa: E731
    agree = lambda a, b: int((a.argmax(-1) == b.argmax(-1)).sum())  # noqa: E731
    e32 = max(err(l32, f32[:, 0]), err(d32, f32[:, 1]))
    e16 = max(err(l16, f16[:, 0]), err(d16, f16[:, 1]))
    drift = err(f16[:, 1], f32[:, 1])
    n = tokens.shape[0]
    print(f"[{label}] consistency with a full forward, max |logit| "
          f"{scale:.4g}: float32 prefill {err(l32, f32[:, 0]):.4g}, decode "
          f"{err(d32, f32[:, 1]):.4g} (rel {e32 / scale:.3g}); bf16 prefill "
          f"{err(l16, f16[:, 0]):.4g}, decode {err(d16, f16[:, 1]):.4g} "
          f"(rel {e16 / scale:.3g}); bf16 forward vs float32 forward "
          f"{drift:.4g} (rel {drift / scale:.3g}); argmax equal: bf16 "
          f"decode/forward {agree(d16, f16[:, 1])}/{n}, float32 "
          f"{agree(d32, f32[:, 1])}/{n}, bf16/float32 forward "
          f"{agree(f16[:, 1], f32[:, 1])}/{n}")
    if e32 > 1e-3 * scale:
        raise AssertionError(f"{label}: float32 prefill/decode differ from "
                             f"the full forward beyond 1e-3 of max |logit|")
    if e16 > max(0.1 * scale, drift):
        raise AssertionError(f"{label}: bf16 prefill/decode differ from the "
                             f"bf16 forward beyond both 0.1 of max |logit| "
                             f"and the bf16 forward's distance from float32")


def serve_profile(label: str, cfg, params, tokens, steps: int = 4) -> dict:
    """torch.profiler over one prefill, then over ``steps`` decode steps
    (after one warm-up step)."""
    from repro_torch.models import lm

    s = tokens.shape[1]
    out = {}
    with torch.no_grad():
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=PROFILER_ACTS) as prof:
            t_start = time.perf_counter()
            logits, cache = lm.prefill(cfg, params, {"tokens": tokens})
            torch.cuda.synchronize()
            wall = time.perf_counter() - t_start
        out[f"{label} prefill"] = profile_row(prof, wall, 1)
        cache = lm.pad_cache(cfg, cache, s + steps + 1)
        tok = logits.argmax(-1).to(torch.int32)
        logits, cache = lm.decode(cfg, params, tok, cache, s)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=PROFILER_ACTS) as prof:
            t_start = time.perf_counter()
            for i in range(steps):
                tok = logits.argmax(-1).to(torch.int32)
                logits, cache = lm.decode(cfg, params, tok, cache, s + 1 + i)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t_start
        out[f"{label} decode"] = profile_row(prof, wall, steps)
    print_profile(f"{label} prefill", out[f"{label} prefill"], "prefill")
    print_profile(f"{label} decode", out[f"{label} decode"], "decode step")
    return out


def _demo_on_cpu(demo):
    """The demo's spike times from the plain versions on the CPU."""
    import io

    with contextlib.redirect_stdout(io.StringIO()):
        return demo.main("cpu")


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=64)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import common as kc

    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}")
    t_start = time.perf_counter()
    build = kc.build()
    print(f"[build] {len(kc.SOURCES)} sources, {len(kc.KERNELS)} kernels in "
          f"{time.perf_counter() - t_start:.1f} s into {build}")
    for name in kc.SOURCES:
        log = build / f"{name}.log"
        if log.exists():
            for line in log.read_text().splitlines():
                if any(w in line for w in ("registers", "spill", "smem",
                                          "entry function")):
                    print(f"[build] {name}: {line.strip()}")
    spills = flash_spills((build / "flash_attention.log").read_text())
    for kind, by_dn in spills.items():
        print(f"[build] flash_attention {kind} spill bytes by DN: {by_dn}")
        for dn in (80, 128):
            if by_dn.get(dn, 1):
                raise AssertionError(f"flash_attention {kind} DN {dn}: "
                                     f"ptxas spills {by_dn.get(dn)} bytes "
                                     f"(or no report)")

    paths = Paths(device, args.seed, args.steps)
    blocks = paths.first_blocks()
    cases = kernel_cases(blocks, paths, device) + lm_kernel_cases(
        device, args.seed)
    main_rows = kernel_phase(cases)
    del cases
    entry = entry_phase(blocks, paths, device)
    counts = path_phase(paths, device)
    counts["entry"] = entry
    counts["resilient"] = resilient_phase(paths, device)
    telemetry = telemetry_phase(paths, device)
    check = serve_check(device, args.seed)
    counts["serve-check"] = check["launches"]
    serve_counts, serve_metrics, serve_profiles = serve_phase(device,
                                                              args.seed)
    counts.update(serve_counts)
    profile = profile_phase(paths, device)
    profile.update(serve_profiles)

    kernels = []
    for name, src in kc.KERNELS.items():
        row = main_rows[name]
        launches = {p: c[name] for p, c in counts.items() if c[name]}
        kernels.append(dict(
            name=name, route="cuda", source=f"src/repro_torch/csrc/{src}.cu",
            replaces=REPLACES[name], launches=sum(launches.values()),
            max_abs_err=row["max_abs_err"], ms=row["ms"],
            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=row["library_ms"],
            mode=row["mode"], device_ms=row["device_ms"],
            bytes=row["bytes"], ops=row["ops"], launches_by=launches,
            **{k: row[k] for k in ("host_us", "floor_ms") if k in row}))
        if not launches:
            raise AssertionError(f"kernel {name} launched on no path or "
                                 f"entry point")
        print(f"[kernel-summary] {name}: launches {launches} "
              f"ms={row['ms']:.5f} plain_ms={row['plain_ms']:.4f} "
              f"bytes={row['bytes']} bound_ms={row['bound_ms']:.5f} "
              f"({row['bound_by']}) library_ms={row['library_ms']} "
              f"[{row['mode']}]")
    summary = dict(
        launches={p: {k: v for k, v in c.items() if k in kc.KERNELS}
                  for p, c in counts.items()},
        steps_per_s={p: c["steps_per_s"] for p, c in counts.items()
                     if "steps_per_s" in c},
        serve=serve_metrics,
        serve_check={k: v for k, v in check.items() if k != "launches"},
        checkpoint=counts["resilient"]["checkpoint"], telemetry=telemetry,
        profile=profile)
    print(f"[summary] {json.dumps(summary)}")
    print(json.dumps({"kernels": kernels}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
