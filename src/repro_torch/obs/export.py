"""Telemetry exporters: JSONL event logs and Prometheus-style text
exposition (port of ``repro.obs.export``; the same output strings).

Standard library only: exporters run on hosts where the accelerator
stack may be absent.
"""

from __future__ import annotations

import json
from typing import Any, Iterable, Iterator


def write_jsonl(path: str, rows: Iterable[dict]) -> str:
    with open(path, "w") as f:
        for row in rows:
            f.write(json.dumps(row, sort_keys=True) + "\n")
    return path


def read_jsonl(path: str) -> Iterator[dict]:
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                yield json.loads(line)


class JsonlLogger:
    """Append-mode structured event log (one JSON object per line)."""

    def __init__(self, path: str) -> None:
        self.path = path
        self._f = open(path, "a")

    def emit(self, kind: str, **fields: Any) -> None:
        self._f.write(json.dumps({"kind": kind, **fields},
                                 sort_keys=True) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()

    def __enter__(self) -> "JsonlLogger":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()


def _prom_name(name: str) -> str:
    return "".join(c if c.isalnum() or c == "_" else "_" for c in name)


def prometheus_text(metrics: dict[str, Any], *, prefix: str = "repro",
                    labels: dict[str, str] | None = None) -> str:
    """Render a flat {name: number} dict as Prometheus exposition text.

    Non-numeric values are skipped; nested structure should be
    flattened by the caller (see :func:`summary_exposition`).
    """
    label_str = ""
    if labels:
        inner = ",".join(f'{_prom_name(k)}="{v}"'
                         for k, v in sorted(labels.items()))
        label_str = "{" + inner + "}"
    lines = []
    for name, value in sorted(metrics.items()):
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            continue
        full = f"{prefix}_{_prom_name(name)}"
        lines.append(f"# TYPE {full} gauge")
        lines.append(f"{full}{label_str} {value}")
    return "\n".join(lines) + "\n"


def summary_exposition(summary: dict, *, prefix: str = "repro_fabric",
                       labels: dict[str, str] | None = None) -> str:
    """Flatten a ``metrics_summary`` dict into Prometheus text.

    Emits the fleet totals/EMA/max per CommStats field, the occupancy
    gauges, and scalar run counters; the per-chip/per-port matrices and
    histograms stay in the JSONL dump (they are post-mortem data, not
    scrape targets).
    """
    flat: dict[str, Any] = {
        "steps_total": summary.get("steps", 0),
        "blocks_total": summary.get("blocks", 0),
        "bucket_utilization_ema": summary.get("util_ema", 0.0),
        "merge_occupancy_ema": summary.get("merge", {}).get("occ_ema", 0.0),
        "merge_occupancy_max": summary.get("merge", {}).get("occ_max", 0),
        "inflight_words_ema": summary.get("inflight", {}).get("occ_ema", 0.0),
        "inflight_words_max": summary.get("inflight", {}).get("occ_max", 0),
    }
    for field, value in summary.get("totals", {}).items():
        flat[f"{field}_total"] = value
    for field, value in summary.get("ema", {}).items():
        flat[f"{field}_per_step_ema"] = value
    for field, value in summary.get("max", {}).items():
        flat[f"{field}_per_step_max"] = value
    return prometheus_text(flat, prefix=prefix, labels=labels)
