"""Device-resident metrics of the pulse fabric (port of
``repro.obs.metrics``).

``MetricsCarry`` is a NamedTuple of tensors threaded through the run like
the merge and send queues: updated once per fabric call with tensor ops
and no host sync (no ``.item()``, no branch on a tensor's value; the
flight ring's slot is a tensor used as an index), carried across blocks,
saved with the state, and ``None`` when telemetry is off.  The delivered
spike path never reads it, so a run is the same with telemetry on or
off.

Aggregates, per ``CommStats`` scalar field (fleet = summed over chips):

* cumulative totals (fleet and per chip),
* an exponential moving average of the per-substep fleet value,
* the per-substep fleet maximum,
* a histogram over power-of-two edges,

plus per-port link word and backlog totals and utilization EMAs, the
merge queue's and the pipeline's in-flight occupancy (EMA and maximum),
and a **flight ring** of the last K blocks' per-chip stats that
``ResilientRunner`` dumps on a ``ChipFailure``.

Counters are int32 and wrap as the reference's do (after about 2^31
events); the EMAs are float32.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.kernels import common as kc

I32 = torch.int32
F32 = torch.float32

# CommStats scalar fields aggregated per chip.  ``utilization`` (a float
# ratio) and the array fields (traffic, link_*) are handled apart.
SCALAR_FIELDS = ("sent", "overflow", "merge_dropped", "expired",
                 "stalled", "wire_bytes", "lost_to_failure")
N_FIELDS = len(SCALAR_FIELDS)

# Power-of-two histogram edges over per-substep fleet values: bucket 0
# counts substeps with value 0, bucket k values in [EDGES[k-1],
# EDGES[k]), the last bucket is unbounded.
HIST_EDGES = (1, 2, 4, 8, 16, 32, 64)
N_BUCKETS = len(HIST_EDGES) + 1

# Flight-ring rows: the CommStats scalars plus each chip's link word
# volume and end-of-block link backlog.
FLIGHT_FIELDS = SCALAR_FIELDS + ("link_words", "link_backlog")
N_FLIGHT_FIELDS = len(FLIGHT_FIELDS)


@dataclasses.dataclass(frozen=True)
class MetricsConfig:
    """``ema_alpha`` — per-substep EMA decay (state' = a*state +
    (1-a)*x).  ``flight_depth`` — K, blocks kept in the flight ring.
    ``link_capacity`` — words a link carries per substep (0 = unknown:
    the link utilization EMA then tracks raw words per substep);
    ``snn.network`` fills it from the topology's ``link_bandwidth`` when
    left at 0."""

    ema_alpha: float = 0.9
    flight_depth: int = 16
    link_capacity: int = 0


class FlightRing(NamedTuple):
    """The last K blocks' per-chip stats.

    ``blocks`` — int32[K, N_FLIGHT_FIELDS, n_chips], rows ordered as
    ``FLIGHT_FIELDS`` (block sums; ``link_backlog`` is the end-of-block
    level).  ``t0`` — int32[K] substep at block start.  ``idx`` — int32[]
    blocks ever recorded (the write slot is idx % K).
    """

    blocks: torch.Tensor
    t0: torch.Tensor
    idx: torch.Tensor


def flight_init(depth: int, n_chips: int, *, device="cuda") -> FlightRing:
    device = kc.resolve_device(device)
    return FlightRing(
        blocks=torch.zeros((depth, N_FLIGHT_FIELDS, n_chips), dtype=I32,
                           device=device),
        t0=torch.zeros((depth,), dtype=I32, device=device),
        idx=torch.zeros((), dtype=I32, device=device))


class MetricsCarry(NamedTuple):
    steps: torch.Tensor          # i32[]  substeps aggregated
    blocks: torch.Tensor         # i32[]  fabric calls aggregated
    totals: torch.Tensor         # i32[N_FIELDS]           fleet cumulative
    chip_totals: torch.Tensor    # i32[N_FIELDS, n_chips]  per chip
    ema: torch.Tensor            # f32[N_FIELDS]  EMA of per-substep fleet
    maxima: torch.Tensor         # i32[N_FIELDS]  max per-substep fleet
    hist: torch.Tensor           # i32[N_FIELDS, N_BUCKETS]
    util_ema: torch.Tensor       # f32[]  EMA of mean bucket utilization
    link_words: torch.Tensor     # i32[n_chips, n_ports]  cumulative
    link_backlog: torch.Tensor   # i32[n_chips, n_ports]  backlog-steps
    link_util_ema: torch.Tensor  # f32[n_chips, n_ports]  words/substep(/cap)
    merge_occ_ema: torch.Tensor  # f32[]  EMA of fleet merge occupancy
    merge_occ_max: torch.Tensor  # i32[]
    inflight_ema: torch.Tensor   # f32[]  EMA of fleet in-flight words
    inflight_max: torch.Tensor   # i32[]
    flight: FlightRing


def metrics_init(mcfg: MetricsConfig, n_chips: int, n_ports: int = 1, *,
                 device="cuda") -> MetricsCarry:
    device = kc.resolve_device(device)
    i32 = lambda *s: torch.zeros(s, dtype=I32, device=device)  # noqa: E731
    f32 = lambda *s: torch.zeros(s, dtype=F32, device=device)  # noqa: E731
    return MetricsCarry(
        steps=i32(), blocks=i32(),
        totals=i32(N_FIELDS), chip_totals=i32(N_FIELDS, n_chips),
        ema=f32(N_FIELDS), maxima=i32(N_FIELDS),
        hist=i32(N_FIELDS, N_BUCKETS), util_ema=f32(),
        link_words=i32(n_chips, n_ports), link_backlog=i32(n_chips, n_ports),
        link_util_ema=f32(n_chips, n_ports),
        merge_occ_ema=f32(), merge_occ_max=i32(),
        inflight_ema=f32(), inflight_max=i32(),
        flight=flight_init(mcfg.flight_depth, n_chips, device=device))


def _block(x: torch.Tensor, step_ndim: int) -> torch.Tensor:
    """A stats field in block shape [B, ...]: ``step_ndim`` is its rank on
    a single step (1 for per-chip scalars, 2 for per-port link fields)."""
    return x[None] if x.dim() == step_ndim else x


def _f32_pow(a: np.float32, n: int) -> np.float32:
    """``a ** n`` for an int ``n`` by square-and-multiply in float32, as
    XLA's ``integer_pow`` computes the reference's ``alpha ** B``."""
    acc = None
    while n > 0:
        if n & 1:
            acc = a if acc is None else np.float32(acc * a)
        n >>= 1
        if n > 0:
            a = np.float32(a * a)
    return np.float32(1.0) if acc is None else acc


# Constants are made once per device: a copy from host memory on every
# call would cost the path a transfer.

@functools.lru_cache(maxsize=None)
def _ema_weights(alpha: float, b: int,
                 device: torch.device) -> tuple[float, torch.Tensor]:
    """``(alpha ** b, (1 - alpha) * alpha ** k for k = b-1 .. 0)``, the
    closed form's coefficients in float32."""
    a = np.float32(alpha)
    k = np.arange(b - 1, -1, -1, dtype=np.float32)
    w = (np.float32(1.0) - a) * a ** k
    return float(_f32_pow(a, b)), torch.as_tensor(w, device=device)


@functools.lru_cache(maxsize=None)
def _hist_bins(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """The histogram's edges and bucket indices."""
    return (torch.tensor(HIST_EDGES, dtype=I32, device=device),
            torch.arange(N_BUCKETS, dtype=I32, device=device))


def _ema_block(alpha: float, state: torch.Tensor,
               xs: torch.Tensor) -> torch.Tensor:
    """Fold a length-B substep sequence into an EMA state at once: equal
    to ``for x in xs: state = a*state + (1-a)*x``, as ``a^B * state +
    (1-a) * sum_k a^(B-1-k) * xs[k]``.  ``xs`` is [B, ...]."""
    b = xs.shape[0]
    ab, w = _ema_weights(alpha, b, xs.device)
    w = w.reshape((b,) + (1,) * (xs.dim() - 1))
    return ab * state + (w * xs.to(F32)).sum(0)


def metrics_update(mcfg: MetricsConfig, m: MetricsCarry, stats: Any, *,
                   merge: Any = None, pending: Any = None) -> MetricsCarry:
    """Fold one fabric call's ``CommStats`` into the carry, with no host
    sync.  ``stats`` fields are per step ``[n_chips]`` or per block ``[B,
    n_chips]`` (link fields with a trailing port axis).  ``merge`` /
    ``pending`` are the carries after the call, whose occupancy is
    sampled once per block."""
    a = float(np.float32(mcfg.ema_alpha))
    one_minus_a = float(np.float32(1.0) - np.float32(mcfg.ema_alpha))

    per_chip = torch.stack(
        [_block(getattr(stats, f), 1).to(I32)
         for f in SCALAR_FIELDS])                    # [N_FIELDS, B, n_chips]
    fleet = per_chip.sum(-1, dtype=I32)              # [N_FIELDS, B]
    n_sub = fleet.shape[1]
    block_sums = per_chip.sum(1, dtype=I32)          # [N_FIELDS, n_chips]

    totals = m.totals + fleet.sum(-1, dtype=I32)
    chip_totals = m.chip_totals + block_sums
    maxima = torch.maximum(m.maxima, fleet.amax(-1))

    edges, buckets = _hist_bins(m.totals.device)
    bucket = (fleet[..., None] >= edges).sum(-1, dtype=I32)  # [N_FIELDS, B]
    hist = m.hist + (bucket[..., None] == buckets).sum(1, dtype=I32)

    ema = _ema_block(mcfg.ema_alpha, m.ema, fleet.T)  # fold over substeps

    util = _block(stats.utilization, 1).to(F32)
    util_ema = _ema_block(mcfg.ema_alpha, m.util_ema, util.mean(-1))

    lw = _block(stats.link_words, 2)                  # [B, n_chips, n_ports]
    lb = _block(stats.link_backlog, 2)
    link_words = m.link_words + lw.sum(0, dtype=I32)
    link_backlog = m.link_backlog + lb.sum(0, dtype=I32)
    cap = float(mcfg.link_capacity) if mcfg.link_capacity > 0 else 1.0
    link_util_ema = _ema_block(mcfg.ema_alpha, m.link_util_ema,
                               lw.to(F32) / cap)

    merge_occ_ema, merge_occ_max = m.merge_occ_ema, m.merge_occ_max
    if merge is not None:
        occ = merge.occupancy().sum(dtype=I32)
        merge_occ_ema = a * merge_occ_ema + one_minus_a * occ.to(F32)
        merge_occ_max = torch.maximum(merge_occ_max, occ)
    inflight_ema, inflight_max = m.inflight_ema, m.inflight_max
    if pending is not None:
        occ = pending.occupancy().sum(dtype=I32)
        inflight_ema = a * inflight_ema + one_minus_a * occ.to(F32)
        inflight_max = torch.maximum(inflight_max, occ)

    # Flight ring: one row per fabric call, the per-chip block sums plus
    # the link word volume and the end-of-block backlog level.
    row = torch.cat([
        block_sums,
        lw.sum((0, 2), dtype=I32)[None],
        lb[-1].sum(-1, dtype=I32)[None],
    ])
    depth = m.flight.blocks.shape[0]
    slot = torch.remainder(m.blocks, depth).reshape(1).long()
    flight = FlightRing(
        blocks=m.flight.blocks.index_copy(0, slot, row[None]),
        t0=m.flight.t0.index_copy(0, slot, m.steps.reshape(1)),
        idx=m.flight.idx + 1)

    return MetricsCarry(
        steps=m.steps + n_sub,
        blocks=m.blocks + 1,
        totals=totals, chip_totals=chip_totals, ema=ema, maxima=maxima,
        hist=hist, util_ema=util_ema,
        link_words=link_words, link_backlog=link_backlog,
        link_util_ema=link_util_ema,
        merge_occ_ema=merge_occ_ema, merge_occ_max=merge_occ_max,
        inflight_ema=inflight_ema, inflight_max=inflight_max,
        flight=flight)


def metrics_summary(m: MetricsCarry,
                    mcfg: MetricsConfig | None = None) -> dict:
    """The carry as plain nested dicts on the host: the one host sync,
    which exporters and the monitor read instead of the carry."""
    host = type(m)(*(x.cpu().numpy() for x in m[:-1]), None)
    out: dict[str, Any] = {
        "steps": int(host.steps),
        "blocks": int(host.blocks),
        "hist_edges": list(HIST_EDGES),
        "totals": {}, "ema": {}, "max": {}, "hist": {}, "chip_totals": {},
    }
    for i, f in enumerate(SCALAR_FIELDS):
        out["totals"][f] = int(host.totals[i])
        out["ema"][f] = float(host.ema[i])
        out["max"][f] = int(host.maxima[i])
        out["hist"][f] = [int(v) for v in host.hist[i]]
        out["chip_totals"][f] = [int(v) for v in host.chip_totals[i]]
    out["util_ema"] = float(host.util_ema)
    out["link"] = {
        "words": host.link_words.tolist(),
        "backlog": host.link_backlog.tolist(),
        "util_ema": [[float(v) for v in row]
                     for row in host.link_util_ema],
        "capacity": int(mcfg.link_capacity) if mcfg else 0,
    }
    out["merge"] = {"occ_ema": float(host.merge_occ_ema),
                    "occ_max": int(host.merge_occ_max)}
    out["inflight"] = {"occ_ema": float(host.inflight_ema),
                       "occ_max": int(host.inflight_max)}
    return out
