"""Host-side flight-recorder snapshot and dump (port of
``repro.obs.recorder``; the same schema, so either package reads the
other's dumps).

The device side (``FlightRing``, updated in-scan) lives in
:mod:`repro_torch.obs.metrics`; this module turns a ring into chronological
rows and writes the structured JSONL post-mortem artifact that
``ResilientRunner`` emits when a ``ChipFailure`` fires.

Dump format (one JSON object per line)::

    {"kind": "meta", "schema": "repro.flight/1", "n_chips": ..,
     "depth": .., "blocks_recorded": .., ...}
    {"kind": "block", "seq": .., "t0": .., "per_chip": {field: [..]},
     "fleet": {field: ..}}
    {"kind": "recovery", "detected_at": .., "resumed_from": ..,
     "healthy": [..]}
    {"kind": "failure", "step": .., "surviving": [..]}
"""

from __future__ import annotations

from typing import Any, Iterable

import numpy as np

import torch

from repro_torch.obs.export import read_jsonl, write_jsonl
from repro_torch.obs.metrics import FLIGHT_FIELDS, FlightRing


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def flight_rows(flight: FlightRing) -> list[dict]:
    """Recorded blocks, oldest -> newest (at most ring depth)."""
    blocks = _host(flight.blocks)
    t0 = _host(flight.t0)
    idx = int(_host(flight.idx))
    depth = blocks.shape[0]
    n = min(idx, depth)
    rows = []
    for j in range(n):
        seq = idx - n + j
        slot = seq % depth
        per_chip = {f: [int(v) for v in blocks[slot, i]]
                    for i, f in enumerate(FLIGHT_FIELDS)}
        rows.append({
            "kind": "block",
            "seq": seq,
            "t0": int(t0[slot]),
            "per_chip": per_chip,
            "fleet": {f: int(blocks[slot, i].sum())
                      for i, f in enumerate(FLIGHT_FIELDS)},
        })
    return rows


def dump_flight(path: str, flight: FlightRing, *,
                recoveries: Iterable[Any] = (),
                failure: Any = None,
                meta: dict | None = None) -> str:
    """Write the flight ring + recovery log as a JSONL artifact."""
    blocks = _host(flight.blocks)
    header = {
        "kind": "meta",
        "schema": "repro.flight/1",
        "depth": int(blocks.shape[0]),
        "n_chips": int(blocks.shape[2]),
        "blocks_recorded": int(_host(flight.idx)),
        "fields": list(FLIGHT_FIELDS),
    }
    if meta:
        header.update(meta)
    rows: list[dict] = [header]
    rows.extend(flight_rows(flight))
    for ev in recoveries:
        rows.append({"kind": "recovery",
                     "detected_at": int(ev.detected_at),
                     "resumed_from": int(ev.resumed_from),
                     "healthy": [int(h) for h in np.asarray(ev.healthy)]})
    if failure is not None:
        rows.append({"kind": "failure",
                     "step": int(failure.step),
                     "surviving": [int(s)
                                   for s in np.asarray(failure.surviving)]})
    write_jsonl(path, rows)
    return path


def load_flight(path: str) -> dict:
    """Parse a dump back into {"meta", "blocks", "recoveries", "failure"}."""
    out: dict[str, Any] = {"meta": None, "blocks": [],
                           "recoveries": [], "failure": None}
    for row in read_jsonl(path):
        kind = row.get("kind")
        if kind == "meta":
            out["meta"] = row
        elif kind == "block":
            out["blocks"].append(row)
        elif kind == "recovery":
            out["recoveries"].append(row)
        elif kind == "failure":
            out["failure"] = row
    return out
