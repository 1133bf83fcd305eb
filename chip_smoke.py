#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--steps 64]

Phases, each fatal on failure:
  1. build   the three CUDA kernels from ``src/repro_torch/csrc`` (nvcc,
             sm_90a, one process per source);
  2. kernels each kernel against its plain PyTorch version on the card,
             bitwise on every output, on inputs taken from the first block
             of each path below, in every mode the fabric uses; its time
             (CUDA events over a CUDA graph of back-to-back calls), the
             kernel's own device time (torch.profiler; the difference is
             the wrapper's tensor ops), the plain version's time (CUDA
             events), bytes and the bound at 3.35 TB/s;
  3. wafer   ``configs/bss2.py`` as is (46 chips x 512 AdEx, fan-out 4,
             simplified, B 1): bucket_pack and fused_drain must launch and
             Σ sent == Σ (deposits + expired + overflow + merge_dropped);
  4. feedforward  the paper demo (2 x 64 LIF, fan-out 1) against its plain
             run on the CPU, then the wafer widths with fan-out 1, LIF,
             full mode, 2 buckets per chip, merge_rate 128, B 8:
             fused_inject and fused_drain must launch;
  5. profile where a block's time goes on each path (torch.profiler):
             wall and device-busy time per step, the idle share, kernel
             launches per step and the costliest kernels.  The kernels are
             a small part of a step; this phase shows what the rest is,
             for PERF.md's breakdown;
  6. summary the ``kernels`` JSON line, the card's name and power limit,
             and last the ``{"ok": true, ...}`` line.

It exits non-zero without a card, and without the rest of the repository.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
SIMT_OPS_PER_S = 67e12          # H100 SXM float32 rate outside tensor cores
REPLACES = {
    "fused_inject": "src/repro/kernels/fused_inject/kernel.py:186",
    "bucket_pack": "src/repro/kernels/bucket_pack/kernel.py:84",
    "fused_drain": "src/repro/kernels/fused_drain/kernel.py:145",
}


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
def capture(module, name: str, store: dict):
    """Record the arguments of the first call of ``module.name``."""
    orig = getattr(module, name)

    def wrapped(*args, **kwargs):
        store.setdefault(name, (tree_clone(args), dict(kwargs)))
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


def device_ms(fn, kernel: str, iters: int) -> float | None:
    """Device time per launch of the CUDA kernel named ``kernel`` from
    torch.profiler; None if the profiler recorded no device time."""
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
        if f"{kernel}_kernel" in evt.key:
            t = getattr(evt, "device_time_total", None)
            if t is None:
                t = getattr(evt, "cuda_time_total", 0.0)
            total += t
            count += evt.count
    return total / count / 1e3 if count and total > 0 else None


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


def check_conservation(label: str, state, rec, deposits):
    s = rec.stats
    total = lambda x: int(x.sum(dtype=torch.int64))
    queued = 0 if state.merge is None else int(state.merge.occupancy().sum())
    lhs = total(s.sent)
    rhs = (int(deposits) + total(s.expired) + total(s.overflow)
           + total(s.merge_dropped) + queued)
    print(f"[{label}] conservation: sent {lhs} == deposits {int(deposits)} "
          f"+ expired {total(s.expired)} + overflow {total(s.overflow)} + "
          f"merge_dropped {total(s.merge_dropped)} + queued {queued} "
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


class Paths:
    """The two path runs and the first-block kernel inputs of each."""

    def __init__(self, device, seed: int, steps: int):
        from repro_torch.configs import bss2
        from repro_torch.core import pulse_comm as pc
        from repro_torch.core import routing as rt
        from repro_torch.snn import network as net

        self.device, self.seed, self.steps, self.net = device, seed, steps, net
        base = bss2.CONFIG
        self.wafer_cfg = net.NetworkConfig(comm=base.comm,
                                           neuron_model=base.neuron_model)
        ff_comm = dataclasses.replace(
            base.comm, fanout=1, mode="full", buckets_per_chip=2,
            merge_rate=128, superstep=8)
        self.ff_cfg = net.NetworkConfig(comm=ff_comm, neuron_model="lif")
        gen = torch.Generator().manual_seed(seed)
        self.wafer_params = net.init_params(gen, self.wafer_cfg,
                                            device=device)
        c = ff_comm
        table = rt.random_table(gen, c.neurons_per_chip, c.n_chips,
                                min_delay=8, max_delay=16)
        self.ff_params = net.init_params(gen, self.ff_cfg, table=table,
                                         device=device)
        rng = np.random.default_rng(seed)
        self.wafer_ext = self._ext(rng, base.comm)
        self.ff_ext = self._ext(rng, ff_comm)
        self.pc = pc

    def _ext(self, rng, comm):
        """Background input: each synapse row receives a spike with
        probability 0.02 per step."""
        x = rng.random((self.steps, comm.n_chips, comm.n_inputs_per_chip))
        return torch.as_tensor((x < 0.02).astype(np.float32),
                               device=self.device)

    def first_blocks(self) -> dict:
        """Kernel inputs of each path's first block."""
        from repro_torch.kernels.bucket_pack import ops as bp_ops
        from repro_torch.kernels.fused_drain import ops as fd_ops
        from repro_torch.kernels.fused_inject import ops as fi_ops

        out = {}
        for label, cfg, params, ext in (
                ("wafer", self.wafer_cfg, self.wafer_params, self.wafer_ext),
                ("feedforward", self.ff_cfg, self.ff_params, self.ff_ext)):
            store = {}
            with capture(fi_ops, "fused_inject", store), \
                    capture(fd_ops, "fused_drain", store), \
                    capture(bp_ops, "flush_pack", store):
                state = self.net.init_state(cfg, params, device=self.device)
                self.net.run(cfg, params, state, ext[:cfg.comm.superstep],
                             device=self.device)
            out[label] = store
        return out


def kernel_cases(blocks: dict, device) -> list[dict]:
    """Every (kernel, mode) case: the call, its plain version, bytes and
    operations."""
    from repro_torch.core import events as ev
    from repro_torch.kernels.bucket_pack import ops as bp_ops
    from repro_torch.kernels.bucket_pack.ref import bucket_pack_ref
    from repro_torch.kernels.fused_drain import ops as fd_ops
    from repro_torch.kernels.fused_drain.ref import fused_drain_ref
    from repro_torch.kernels.fused_inject import ops as fi_ops
    from repro_torch.kernels.fused_inject.ref import fused_inject_ref

    cases = []
    (events, table, t0), kw = blocks["feedforward"]["fused_inject"]
    for mode, bpc in (("full", kw["buckets_per_chip"]), ("simplified", 1)):
        for b in (events.addr.shape[0], 1):
            ev_b = ev.EventBuffer(*(x[:b].contiguous() for x in events))
            kwm = dict(kw, mode=mode, buckets_per_chip=bpc)
            args = (ev_b, table, t0)
            lanes = ev_b.addr.numel()
            cases.append(dict(
                kernel="fused_inject", mode=f"{mode} B{b}",
                main=(mode == "full" and b == events.addr.shape[0]),
                run=lambda a=args, k=kwm: fi_ops.fused_inject(*a, **k),
                plain=lambda a=args, k=kwm: fused_inject_ref(*a, **k),
                inputs=(ev_b, table, t0), ops=lanes))

    (bid, addr, dead, valid), kw = blocks["wafer"]["flush_pack"]
    args = (bid, addr, dead, valid)

    def bp_plain(a=args, k=kw):
        rows, counts, overflow = bucket_pack_ref(
            a[0].to(torch.int32), ev.encode_word(*a[1:]), **k)
        return rows.permute(1, 2, 0, 3).contiguous(), counts, overflow

    cases.append(dict(
        kernel="bucket_pack", mode=f"flush B{bid.shape[0]}", main=True,
        run=lambda a=args, k=kw: bp_ops.flush_pack(*a, **k), plain=bp_plain,
        inputs=args, ops=bid.numel()))

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
                    sort_n = fd_ops.sort_length(
                        mode, d.shape[-1], 0 if q is None else q.shape[-1],
                        kwm.get("rate", 0))
                    stages = 0
                    if sort_n:
                        lg = sort_n.bit_length() - 1
                        stages = lg * (lg + 1) // 2
                    ops = n * b * (sort_n // 2 * stages + d.shape[-1])
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
    return cases


def kernel_phase(cases: list[dict]) -> dict:
    """Compare, then time; returns the main case of each kernel."""
    main = {}
    for case in cases:
        got = case["run"]()
        want = case["plain"]()
        torch.cuda.synchronize()
        err = compare(f"{case['kernel']} [{case['mode']}]", got, want)
        moved = nbytes(case["inputs"]) + nbytes(got)
        bytes_ms = moved / HBM_BYTES_PER_S * 1e3
        ops_ms = case["ops"] / SIMT_OPS_PER_S * 1e3
        row = dict(name=case["kernel"], mode=case["mode"], max_abs_err=err,
                   ms=graph_ms(case["run"]),
                   device_ms=device_ms(case["run"], case["kernel"], 20),
                   plain_ms=event_ms(case["plain"], 5), bytes=moved,
                   ops=case["ops"], bound_ms=max(bytes_ms, ops_ms),
                   bound_by="bytes" if bytes_ms >= ops_ms else "operations")
        dms = row["device_ms"]
        print(f"[kernel] {case['kernel']:12s} {case['mode']:40s} "
              f"bitwise ok  ms={row['ms']:.4f} device_ms="
              f"{'not measured' if dms is None else f'{dms:.4f}'} "
              f"plain_ms={row['plain_ms']:.4f} bytes={moved} "
              f"bound_ms={row['bound_ms']:.5f} ({row['bound_by']})")
        if case["main"]:
            main[case["kernel"]] = row
    return main


def path_phase(paths: Paths, device) -> dict:
    """Run both paths with the launch counters zeroed just before each;
    returns launches per kernel and path."""
    from repro_torch import demo
    from repro_torch.kernels import common as kc

    net = paths.net
    counts = {}
    for label, cfg, params, ext, needs in (
            ("wafer", paths.wafer_cfg, paths.wafer_params, paths.wafer_ext,
             ("bucket_pack", "fused_drain")),
            ("feedforward", paths.ff_cfg, paths.ff_params, paths.ff_ext,
             ("fused_inject", "fused_drain"))):
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
        torch.cuda.synchronize()
        kc.reset_launches()
        t_start = time.perf_counter()
        state, rec, deposits = run_path(net, cfg, params, ext, device,
                                        c.superstep)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_start
        counts[label] = dict(kc.launches)
        print(f"[{label}] {c.n_chips} chips x {c.neurons_per_chip} "
              f"{cfg.neuron_model}, fan-out {c.fanout}, {c.mode}, "
              f"bpc {c.buckets_per_chip}, merge_rate {c.merge_rate}, "
              f"B {c.superstep}, T {ext.shape[0]}: {ext.shape[0] / wall:.2f} "
              f"steps/s ({wall:.3f} s); launches {counts[label]}")
        s = rec.stats
        print(f"[{label}] spikes {int(rec.spikes.sum())}, sent "
              f"{int(s.sent.sum())}, overflow {int(s.overflow.sum())}, "
              f"expired {int(s.expired.sum())}, merge_dropped "
              f"{int(s.merge_dropped.sum())}, mean utilization "
              f"{float(s.utilization.mean()):.4f}")
        check_record(label, rec, ext.shape[0], c.n_chips, c.neurons_per_chip)
        check_conservation(label, state, rec, deposits)
        for k in needs:
            if counts[label][k] == 0:
                raise AssertionError(f"{label}: kernel {k} never launched")
        counts[label]["steps_per_s"] = ext.shape[0] / wall
    return counts


def profile_phase(paths: Paths, device, blocks: int = 4) -> dict:
    """Where a block's time goes: torch.profiler over ``blocks`` blocks of
    each path (after one warm-up block).  Per step: wall time, device busy
    time (sum of kernel times on the one stream), kernel launches, and
    the kernels that take the most device time."""
    net = paths.net
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    out = {}
    for label, cfg, params, ext in (
            ("wafer", paths.wafer_cfg, paths.wafer_params, paths.wafer_ext),
            ("feedforward", paths.ff_cfg, paths.ff_params, paths.ff_ext)):
        b = cfg.comm.superstep
        n_blocks = min(blocks, ext.shape[0] // b - 1)
        state = net.init_state(cfg, params, device=device)
        state, _ = net.run(cfg, params, state, ext[:b], device=device)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            t_start = time.perf_counter()
            for i in range(1, n_blocks + 1):
                state, _ = net.run(cfg, params, state,
                                   ext[i * b:(i + 1) * b], device=device)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t_start
        steps = n_blocks * b
        kernels = [e for e in prof.key_averages()
                   if str(getattr(e, "device_type", "")).endswith("CUDA")]
        dev_us = lambda e: (getattr(e, "self_device_time_total", None)
                            or getattr(e, "device_time_total", 0.0))
        busy_ms = sum(dev_us(e) for e in kernels) / 1e3
        top = sorted(kernels, key=dev_us, reverse=True)[:5]
        row = dict(
            wall_ms_per_step=wall * 1e3 / steps,
            device_busy_ms_per_step=busy_ms / steps,
            idle_share=1.0 - busy_ms / (wall * 1e3),
            kernel_launches_per_step=sum(e.count for e in kernels) / steps,
            top_kernels=[(e.key[:60], dev_us(e) / 1e3 / steps)
                         for e in top])
        print(f"[profile] {label}: {row['wall_ms_per_step']:.4f} ms/step "
              f"wall, device busy {row['device_busy_ms_per_step']:.4f} "
              f"ms/step, idle share {row['idle_share']:.4f}, "
              f"{row['kernel_launches_per_step']:.1f} kernel launches/step")
        for name, ms in row["top_kernels"]:
            print(f"[profile] {label}:   {ms:.5f} ms/step  {name}")
        out[label] = row
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
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}")
    t_start = time.perf_counter()
    build = kc.build()
    print(f"[build] {len(kc.KERNELS)} kernels in "
          f"{time.perf_counter() - t_start:.1f} s into {build}")
    for name in kc.KERNELS:
        log = build / f"{name}.log"
        if log.exists():
            for line in log.read_text().splitlines():
                if any(w in line for w in ("registers", "spill", "smem")):
                    print(f"[build] {name}: {line.strip()}")

    paths = Paths(device, args.seed, args.steps)
    cases = kernel_cases(paths.first_blocks(), device)
    main_rows = kernel_phase(cases)
    counts = path_phase(paths, device)
    profile = profile_phase(paths, device)

    kernels = []
    for name in kc.KERNELS:
        row = main_rows[name]
        kernels.append(dict(
            name=name, route="cuda",
            source=f"src/repro_torch/csrc/{name}.cu",
            replaces=REPLACES[name],
            launches=sum(counts[p][name] for p in counts),
            max_abs_err=row["max_abs_err"], ms=row["ms"],
            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=None, mode=row["mode"],
            device_ms=row["device_ms"], bytes=row["bytes"]))
        print(f"[kernel-summary] {name}: launches "
              f"{ {p: counts[p][name] for p in counts} } ms={row['ms']:.5f} "
              f"plain_ms={row['plain_ms']:.4f} bytes={row['bytes']} "
              f"bound_ms={row['bound_ms']:.5f} ({row['bound_by']}) "
              f"[{row['mode']}]")
    summary = dict(
        launches={p: {k: v for k, v in c.items() if k in kc.KERNELS}
                  for p, c in counts.items()},
        steps_per_s={p: c["steps_per_s"] for p, c in counts.items()},
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
