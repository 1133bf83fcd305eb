"""Fabric telemetry monitor (port of ``repro.launch.monitor``).

* ``--demo`` — a short fabric run with telemetry (superstep blocks over
  a ring topology), a :class:`repro_torch.obs.MetricsCarry` folded in on
  the device after every block; then the conservation identity, the
  per-chip, per-port link heatmap and the drop-bucket histograms.
  ``--jsonl PATH`` writes the dump (meta, summary, conservation, the
  flight ring's blocks); ``--check`` reads it back and exits non-zero
  unless it parses and the identity closes.
* ``--dump PATH`` — render a recorded dump (a ``--demo`` dump, or a
  ``ResilientRunner`` flight-recorder post-mortem of either package)
  without running anything.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.monitor --demo \\
        --steps 64 --jsonl metrics_dump.jsonl --check
    PYTHONPATH=src python -m repro_torch.launch.monitor --demo --device cpu
    PYTHONPATH=src python -m repro_torch.launch.monitor \\
        --dump flight_000007_0.jsonl

The demo runs on ``--device`` (default the card).  Its LUT and spikes
come from a ``torch.Generator`` seeded with ``--seed``, so they differ
from ``repro.launch.monitor``'s for the same seed.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

SHADES = " .:-=+*#%@"


def _heatmap(matrix, row_label: str = "chip") -> str:
    """ASCII shade map of a [rows, cols] count matrix."""
    m = np.asarray(matrix, np.float64)
    hi = m.max() if m.size else 0.0
    lines = []
    for r in range(m.shape[0]):
        cells = "".join(
            SHADES[min(int(m[r, c] / hi * (len(SHADES) - 1)), len(SHADES) - 1)]
            if hi > 0 else SHADES[0]
            for c in range(m.shape[1]))
        lines.append(f"  {row_label} {r:3d} |{cells}| {int(m[r].sum())}")
    return "\n".join(lines)


def _buckets(summary: dict) -> str:
    edges = summary["hist_edges"]
    labels = (["0"] + [f"[{lo},{hi})" for lo, hi in zip(edges, edges[1:])]
              + [f">={edges[-1]}"])
    lines = ["  " + " ".join(f"{v:>8}" for v in ["field"] + labels)]
    for field in ("sent", "overflow", "merge_dropped", "expired", "stalled",
                  "lost_to_failure"):
        row = summary["hist"][field]
        lines.append("  " + " ".join(
            f"{v:>8}" for v in [field[:8]] + [str(c) for c in row]))
    return "\n".join(lines)


def render_summary(summary: dict, report=None) -> str:
    out = [f"telemetry: {summary['steps']} substeps over "
           f"{summary['blocks']} fabric calls"]
    if report is not None:
        out += ["", "conservation identity:", report.render()]
    out += ["", "per-substep fleet EMAs:"]
    for field, val in summary["ema"].items():
        out.append(f"  {field:<16} ema={val:10.2f}  "
                   f"max={summary['max'][field]:<8d} "
                   f"total={summary['totals'][field]}")
    out += ["", "link word heatmap [chip x port]:",
            _heatmap(summary["link"]["words"])]
    out += ["", "drop buckets (substeps per fleet-count bucket):",
            _buckets(summary)]
    out += ["", f"merge queue:  ema={summary['merge']['occ_ema']:.2f} "
                f"max={summary['merge']['occ_max']}",
            f"in-flight:    ema={summary['inflight']['occ_ema']:.2f} "
                f"max={summary['inflight']['occ_max']}"]
    return "\n".join(out)


def demo(steps: int = 64, n_chips: int = 4, superstep: int = 4,
         n_neurons: int = 64, rate: float = 0.25, merge_rate: int = 2,
         seed: int = 0, jsonl: str | None = None,
         device="cuda") -> dict:
    """Run the telemetry demo; returns {"summary", "report", "rows"}."""
    import torch

    from repro_torch import obs
    from repro_torch.core import delays as dl
    from repro_torch.core import events as ev
    from repro_torch.core import pulse_comm as pc
    from repro_torch.core import routing as rt
    from repro_torch.core import topology as tpo
    from repro_torch.core.fabric import PulseFabric
    from repro_torch.kernels import common as kc

    device = kc.resolve_device(device)
    if steps % superstep:
        raise SystemExit(f"--steps {steps} must be a multiple of "
                         f"--superstep {superstep}")
    n_blocks = steps // superstep
    cfg = pc.PulseCommConfig(
        n_chips=n_chips, neurons_per_chip=n_neurons,
        n_inputs_per_chip=n_neurons, event_capacity=n_neurons,
        ring_depth=32, superstep=superstep,
        mode="full" if merge_rate else "simplified", merge_rate=merge_rate)
    topo = tpo.ring(n_chips, link_latency=1, link_bandwidth=0)
    fab = PulseFabric(cfg, transport=topo, device=device)
    gen = torch.Generator().manual_seed(seed)
    table = rt.random_table(gen, n_neurons, n_chips, fanout=1,
                            max_delay=cfg.ring_depth // 2 - 1,
                            min_delay=superstep + 2)
    table = rt.RoutingTable(*(
        x.expand((n_chips,) + x.shape).contiguous().to(device)
        for x in table))
    ring = dl.init(cfg.ring_depth, n_neurons, batch_shape=(n_chips,),
                   device=device)

    mcfg = obs.MetricsConfig(flight_depth=n_blocks)
    metrics = obs.metrics_init(mcfg, n_chips, topo.n_ports, device=device)
    merge = fab.init_merge()
    timer = obs.SpanTimer()
    sp = (torch.rand((n_blocks, superstep, n_chips, n_neurons),
                     generator=gen) < rate).to(device)
    deposited0 = int(ring.ring.sum())
    for f in range(n_blocks):
        t0 = f * superstep
        bufs = [ev.from_spikes(sp[f, k], t0 + k, n_neurons)[0]
                for k in range(superstep)]
        ebs = ev.EventBuffer(*(torch.stack(x) for x in zip(*bufs)))
        with timer.span("monitor/block"):
            res = fab.superstep(ebs, table, ring, None, merge, None)
            metrics = obs.metrics_update(mcfg, metrics, res.stats,
                                         merge=res.merge)
            ring = dl.DelayRing(ring=res.ring.ring,
                                now=res.ring.now + superstep)
            merge = res.merge
    if device.type == "cuda":
        torch.cuda.synchronize(device)

    summary = obs.metrics_summary(metrics, mcfg)
    deposited = int(ring.ring.sum()) - deposited0
    queued = int(merge.occupancy().sum()) if merge is not None else 0
    report = obs.check_conservation(summary["totals"], delivered=deposited,
                                    queued=queued, strict=False)

    rows = [{"kind": "meta", "schema": "repro.monitor/1",
             "n_chips": n_chips, "superstep": superstep, "steps": steps},
            {"kind": "summary", **summary},
            {"kind": "conservation", "injected": report.injected,
             "delivered": report.delivered, "queued": report.queued,
             "in_flight": report.in_flight, "legs": report.legs,
             "residual": report.residual}]
    rows.extend(obs.flight_rows(metrics.flight))
    if jsonl:
        obs.write_jsonl(jsonl, rows)
    print(render_summary(summary, report))
    print()
    print(timer.report())
    return {"summary": summary, "report": report, "rows": rows}


def check_dump(path: str) -> int:
    """Validate a dump: it parses as JSONL, has blocks, the identity
    closes and each block's fleet totals equal its per-chip sums."""
    from repro_torch import obs

    rows = list(obs.read_jsonl(path))
    kinds = [r.get("kind") for r in rows]
    blocks = [r for r in rows if r.get("kind") == "block"]
    errors = []
    if not blocks:
        errors.append("no block rows in dump")
    cons = [r for r in rows if r.get("kind") == "conservation"]
    if cons and cons[0]["residual"] != 0:
        errors.append(f"conservation residual {cons[0]['residual']} != 0")
    for r in blocks:
        for field, fleet in r["fleet"].items():
            if fleet != sum(r["per_chip"][field]):
                errors.append(f"block {r.get('seq')}: {field} fleet "
                              f"{fleet} != per-chip sum")
    if errors:
        for e in errors:
            print(f"CHECK FAIL: {e}", file=sys.stderr)
        return 1
    print(f"# dump OK: {len(rows)} rows ({len(blocks)} blocks, "
          f"kinds: {sorted(set(kinds))})")
    return 0


def render_dump(path: str) -> None:
    from repro_torch import obs

    rows = list(obs.read_jsonl(path))
    summary = next((r for r in rows if r.get("kind") == "summary"), None)
    if summary is not None:
        print(render_summary(summary))
    blocks = [r for r in rows if r.get("kind") == "block"]
    if blocks:
        print(f"\nflight ring — last {len(blocks)} blocks "
              "(fleet sent/stalled/lost per block):")
        for r in blocks:
            f = r["fleet"]
            print(f"  seq {r['seq']:5d} t0={r['t0']:6d}  "
                  f"sent={f.get('sent', 0):<6d} "
                  f"stalled={f.get('stalled', 0):<6d} "
                  f"backlog={f.get('link_backlog', 0):<6d} "
                  f"lost={f.get('lost_to_failure', 0)}")
        chips = np.array([r["per_chip"]["sent"] for r in blocks])
        print("\nper-chip sent heatmap [block x chip]:")
        print(_heatmap(chips, row_label="blk"))
    for r in rows:
        if r.get("kind") == "recovery":
            print(f"recovery: detected_at={r['detected_at']} "
                  f"resumed_from={r['resumed_from']} "
                  f"healthy={r['healthy']}")
        elif r.get("kind") == "failure":
            print(f"FAILURE: step={r['step']} surviving={r['surviving']}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--demo", action="store_true",
                   help="run a short telemetry-enabled fabric demo")
    p.add_argument("--dump", help="render a recorded JSONL dump")
    p.add_argument("--steps", type=int, default=64)
    p.add_argument("--chips", type=int, default=4)
    p.add_argument("--superstep", type=int, default=4)
    p.add_argument("--neurons", type=int, default=64)
    p.add_argument("--rate", type=float, default=0.25)
    p.add_argument("--merge-rate", type=int, default=2)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--jsonl", help="write the structured dump here")
    p.add_argument("--check", action="store_true",
                   help="validate the dump (with --demo: after writing)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    if args.dump:
        if args.check:
            return check_dump(args.dump)
        render_dump(args.dump)
        return 0
    if args.demo:
        res = demo(steps=args.steps, n_chips=args.chips,
                   superstep=args.superstep, n_neurons=args.neurons,
                   rate=args.rate, merge_rate=args.merge_rate,
                   seed=args.seed, jsonl=args.jsonl, device=args.device)
        if args.check:
            if args.jsonl:
                return check_dump(args.jsonl)
            return 0 if res["report"].ok else 1
        return 0
    p.print_help()
    return 2


if __name__ == "__main__":
    sys.exit(main())
