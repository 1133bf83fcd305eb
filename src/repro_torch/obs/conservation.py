"""Reusable event-conservation check for fabric stats (port of
``repro.obs.conservation``).

Every injected event must be accounted for exactly once::

    injected == delivered + queued + in_flight
                + overflow + merge_dropped + expired + stalled
                + lost_to_failure (+ wrap_expired + lost)

``injected`` is the summed ``sent`` counter; the drop legs are read off
the stats object (or mapping) with missing fields defaulting to 0, so
the same call works on ``CommStats`` rows, ``InjectStats``, hand-built
totals dicts, and a ``MetricsCarry`` summary's ``totals`` dict.  ``delivered``/``queued``/``in_flight`` are supplied
by the caller because they live outside the stats counters (ring
deposits, flow/merge/send-queue occupancy, pipeline carry).
"""

from __future__ import annotations

from typing import Any, Mapping, NamedTuple

import numpy as np
import torch

# Loss/accounting legs, in the order they are reported.  ``wrap_expired``
# and ``lost`` only exist on InjectStats (CommStats folds them into
# ``expired``/``lost_to_failure``); absent fields contribute 0.
LEG_FIELDS = ("overflow", "merge_dropped", "expired", "stalled",
              "lost_to_failure", "wrap_expired", "lost")


def _sum(v: Any) -> int:
    """The sum of a number, an array or a tensor (on any device)."""
    if isinstance(v, torch.Tensor):
        return int(v.sum(dtype=torch.int64))
    return int(np.asarray(v).sum())


def _tot(stats: Any, field: str) -> int:
    if isinstance(stats, Mapping):
        v = stats.get(field, 0)
    else:
        v = getattr(stats, field, 0)
    return _sum(v)


class ConservationReport(NamedTuple):
    injected: int
    delivered: int
    queued: int
    in_flight: int
    legs: dict
    residual: int

    @property
    def ok(self) -> bool:
        return self.residual == 0

    def render(self) -> str:
        legs = " + ".join(f"{k}={v}" for k, v in self.legs.items() if v)
        lines = [
            f"injected   = {self.injected}",
            f"delivered  = {self.delivered}",
            f"queued     = {self.queued}",
            f"in_flight  = {self.in_flight}",
            f"dropped    = {sum(self.legs.values())}"
            + (f"  ({legs})" if legs else ""),
            f"residual   = {self.residual}"
            + ("  [closed]" if self.ok else "  [LEAK]"),
        ]
        return "\n".join(lines)


def check_conservation(stats: Any, *, delivered: Any = 0, queued: Any = 0,
                       in_flight: Any = 0, extra_injected: Any = 0,
                       extra_accounted: Any = 0,
                       strict: bool = True) -> ConservationReport:
    """Verify the conservation identity over summed stats counters.

    ``delivered`` — events deposited into delivery rings; ``queued`` —
    events still parked in flow/merge/send-queue carries; ``in_flight``
    — words in an un-drained pipeline slab.  ``extra_injected`` /
    ``extra_accounted`` let pipelined callers add the carried block's
    contributions.  Any argument may be an array or a tensor; it is summed.

    Returns a :class:`ConservationReport`; with ``strict`` (default)
    raises ``AssertionError`` carrying the rendered breakdown when the
    identity does not close.
    """
    injected = _tot(stats, "sent") + _sum(extra_injected)
    legs = {f: _tot(stats, f) for f in LEG_FIELDS}
    delivered = _sum(delivered)
    queued = _sum(queued)
    in_flight = _sum(in_flight)
    accounted = (delivered + queued + in_flight + sum(legs.values())
                 + _sum(extra_accounted))
    report = ConservationReport(injected=injected, delivered=delivered,
                                queued=queued, in_flight=in_flight,
                                legs=legs, residual=injected - accounted)
    if strict and not report.ok:
        raise AssertionError(
            "event conservation violated:\n" + report.render())
    return report
