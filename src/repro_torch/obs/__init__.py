"""repro_torch.obs — fabric telemetry (port of ``repro.obs``): metrics
aggregated on the device during the run, phase tracing, the conservation
check, exporters and the failure flight recorder.

The package imports nothing from ``repro_torch.core``, so the fabric can
import :mod:`repro_torch.obs.trace` for its phase scopes without a cycle.
Everything on the device (``MetricsCarry``, ``FlightRing``) is a
NamedTuple of tensors updated with tensor ops and no host sync, and is
saved with the state.
"""

from repro_torch.obs.conservation import ConservationReport, check_conservation
from repro_torch.obs.export import (JsonlLogger, prometheus_text, read_jsonl,
                                    summary_exposition, write_jsonl)
from repro_torch.obs.metrics import (HIST_EDGES, SCALAR_FIELDS, FlightRing,
                                     MetricsCarry, MetricsConfig, flight_init,
                                     metrics_init, metrics_summary,
                                     metrics_update)
from repro_torch.obs.recorder import dump_flight, flight_rows, load_flight
from repro_torch.obs.trace import SpanTimer, phase_scope

__all__ = [
    "ConservationReport", "check_conservation",
    "JsonlLogger", "prometheus_text", "read_jsonl",
    "summary_exposition", "write_jsonl",
    "HIST_EDGES", "SCALAR_FIELDS", "FlightRing",
    "MetricsCarry", "MetricsConfig", "flight_init",
    "metrics_init", "metrics_summary", "metrics_update",
    "dump_flight", "flight_rows", "load_flight",
    "SpanTimer", "phase_scope",
]
