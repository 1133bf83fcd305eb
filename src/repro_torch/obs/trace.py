"""Phase tracing: named scopes for device profiles and a host-side span
timer for drivers (port of ``repro.obs.trace``).

``phase_scope(name)`` is ``torch.profiler.record_function(name)`` while a
profiler is recording: the kernels launched inside it are attributed to
the scope in ``key_averages()`` and in the trace.  With no profiler
recording it does nothing, so it costs the paths no host time.  It never
raises: tracing must not break the run.
"""

from __future__ import annotations

import contextlib
import time
from typing import Iterator

import torch


def _profiling() -> bool:
    return getattr(torch.autograd.profiler, "_is_profiler_enabled", True)


@contextlib.contextmanager
def phase_scope(name: str) -> Iterator[None]:
    """Annotate a fabric phase for device and host profiles."""
    with contextlib.ExitStack() as stack:
        if _profiling():
            try:
                stack.enter_context(torch.profiler.record_function(name))
            except Exception:
                pass  # profiling unavailable: tracing never breaks the run
        yield


class SpanTimer:
    """Host-side wall-clock span accumulator for serve and benchmark
    drivers: times host-visible phases (a synchronised prefill, a decode
    step's dispatch).  Spans nest freely; each named span accumulates its
    count and total and keeps its maximum."""

    def __init__(self) -> None:
        self._spans: dict[str, dict[str, float]] = {}

    @contextlib.contextmanager
    def span(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            with phase_scope(name):
                yield
        finally:
            dt_ms = (time.perf_counter() - t0) * 1e3
            s = self._spans.setdefault(
                name, {"count": 0, "total_ms": 0.0, "max_ms": 0.0})
            s["count"] += 1
            s["total_ms"] += dt_ms
            s["max_ms"] = max(s["max_ms"], dt_ms)

    def summary(self) -> dict[str, dict[str, float]]:
        """name -> {count, total_ms, mean_ms, max_ms}."""
        out = {}
        for name, s in self._spans.items():
            out[name] = {
                "count": int(s["count"]),
                "total_ms": s["total_ms"],
                "mean_ms": s["total_ms"] / max(1, s["count"]),
                "max_ms": s["max_ms"],
            }
        return out

    def report(self) -> str:
        lines = [f"{'span':<28} {'count':>6} {'mean_ms':>9} "
                 f"{'max_ms':>9} {'total_ms':>10}"]
        for name, s in sorted(self.summary().items()):
            lines.append(f"{name:<28} {s['count']:>6d} {s['mean_ms']:>9.3f} "
                         f"{s['max_ms']:>9.3f} {s['total_ms']:>10.3f}")
        return "\n".join(lines)
