"""Resilience: chip-failure injection, detection and the freeze of dead
chips' state (port of ``repro.core.resilience``).

Four layers (this module is layer 1):

1. **Health model** (here).  A per-chip bool alive mask is ordinary
   state.  :class:`FabricFaultInjector` kills chip c at step t through
   masks, never exceptions: a dead chip stops emitting events
   (:meth:`FabricFaultInjector.mask_events`) and its per-chip carries
   stop evolving (:func:`freeze`), which is how a real dead chip looks
   from the fabric.  Detection reads two observables: the heartbeat
   (:func:`beats_local` folded in by :func:`observe`) and the credit
   protocol, where a chip with traffic outstanding whose notification
   counter stops advancing for more than ``credit_timeout`` steps is
   suspected (:func:`credit_watch`).
2. **Degraded routing** (:mod:`repro_torch.core.topology`,
   ``PulseFabric(healthy=, dead_links=)`` and ``degrade()``).
3. **Recovery orchestration** (:class:`repro_torch.runtime.
   ResilientRunner`): detection, checkpoint restore, a fabric rebuilt on
   the survivors, replay.
4. The one-``psum`` heartbeat inside ``shard_map`` comes with the
   multi-GPU transport (ROADMAP section 1, item 7).

Conservation with failures::

    injected == delivered + queued + stalled + expired + lost_to_failure
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.checkpoint.store import tree_map
from repro_torch.core import flowcontrol as fc
from repro_torch.kernels import common as kc

I32 = torch.int32


@dataclasses.dataclass(frozen=True)
class HealthConfig:
    """Detection parameters.

    ``credit_timeout`` — steps a chip may go without a heartbeat (or, for
    :func:`credit_watch`, without credit-protocol progress while traffic
    is outstanding) before it is declared dead.  0 declares on the first
    missed beat.
    """

    n_chips: int
    credit_timeout: int = 4


class HealthState(NamedTuple):
    """Per-chip liveness belief.  ``alive`` is sticky-false: a chip
    declared dead stays dead until a recovery rebuilds the fabric on the
    survivors."""

    alive: torch.Tensor       # bool[n_chips]
    last_heard: torch.Tensor  # int32[n_chips] last step each chip beat


def health_init(cfg: HealthConfig, *, device="cuda") -> HealthState:
    device = kc.resolve_device(device)
    return HealthState(
        alive=torch.ones((cfg.n_chips,), dtype=torch.bool, device=device),
        last_heard=torch.zeros((cfg.n_chips,), dtype=I32, device=device))


def beats_local(alive_bits: torch.Tensor) -> torch.Tensor:
    """Heartbeat vector with the chips on a leading axis: each chip's
    alive bit is its beat, ``int32[n_chips]``."""
    return alive_bits.to(I32)


def heartbeat(transport, alive_bit):
    """The one-``psum`` heartbeat of the shard forms."""
    raise NotImplementedError(
        "heartbeat() sums alive bits across ranks, which needs the "
        "multi-GPU transport; it is not ported yet (ROADMAP section 1, "
        "item 7).  With the chips on one device use beats_local()")


def _step(t, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(t, dtype=I32, device=like.device)


def observe(cfg: HealthConfig, state: HealthState, beats: torch.Tensor,
            t) -> HealthState:
    """Fold one step's heartbeat vector into the belief: a chip silent
    for more than ``credit_timeout`` steps is declared dead."""
    t = _step(t, state.last_heard)
    last = torch.where(beats.to(state.last_heard.device) > 0, t,
                       state.last_heard)
    alive = state.alive & ((t - last) <= cfg.credit_timeout)
    return HealthState(alive=alive, last_heard=last)


class CreditWatch(NamedTuple):
    """Credit-protocol progress tracker (the notification packets as a
    liveness observable)."""

    last_notif: torch.Tensor  # int32[n_chips] counters last seen
    last_step: torch.Tensor   # int32[n_chips] last step a counter advanced


def credit_watch_init(cfg: HealthConfig, *, device="cuda") -> CreditWatch:
    device = kc.resolve_device(device)
    z = torch.zeros((cfg.n_chips,), dtype=I32, device=device)
    return CreditWatch(last_notif=z, last_step=z.clone())


def credit_watch(cfg: HealthConfig, watch: CreditWatch, flow: fc.RingState,
                 t) -> tuple[CreditWatch, torch.Tensor]:
    """Suspect chips whose credits never return: packets outstanding
    (``head > tail``) but no notification for more than
    ``credit_timeout`` steps.  ``flow`` is the per-chip credit state.
    Returns ``(watch', suspected bool[n_chips])``."""
    t = _step(t, watch.last_step)
    progressed = flow.notifications != watch.last_notif
    last = torch.where(progressed, t, watch.last_step)
    outstanding = (flow.head - flow.tail) > 0
    suspected = outstanding & ((t - last) > cfg.credit_timeout)
    return CreditWatch(last_notif=flow.notifications, last_step=last), \
        suspected


def freeze(alive: torch.Tensor, old_tree, new_tree):
    """Pin dead chips' rows of a per-chip state tree: every leaf has a
    leading ``[n_chips]`` axis; rows of dead chips keep their old value,
    so the dead chip's clocks, queues and counters all stop."""
    def pick(o, n):
        mask = alive.to(n.device).reshape((-1,) + (1,) * (n.dim() - 1))
        return torch.where(mask, n, o)
    return tree_map(pick, old_tree, new_tree)


@dataclasses.dataclass(frozen=True)
class FabricFaultInjector:
    """A deterministic fault schedule.

    ``chip_failures`` — (chip, step) pairs: chip c is dead from step t on.
    ``link_failures`` — (chip, port, step) triples: the link behind that
    port is cut from step t on (routes are static per fabric, so a link
    kill takes effect at the next rebuild; chip kills act at once through
    the masks).

    Per step use :meth:`alive_at` / :meth:`mask_events`; at a recovery
    boundary :meth:`healthy_after` / :meth:`dead_links_after` give the
    health to rebuild the fabric with.
    """

    n_chips: int
    chip_failures: tuple = ()
    link_failures: tuple = ()

    def __post_init__(self):
        object.__setattr__(
            self, "chip_failures",
            tuple(sorted((int(c), int(t)) for c, t in self.chip_failures)))
        object.__setattr__(
            self, "link_failures",
            tuple(sorted((int(c), int(p), int(t))
                         for c, p, t in self.link_failures)))
        for c, _ in self.chip_failures:
            if not 0 <= c < self.n_chips:
                raise ValueError(f"chip {c} out of range")

    def alive_at(self, t, *, device=None) -> torch.Tensor:
        """bool[n_chips], the true alive mask at step ``t`` (an int; a
        tensor is read on the host), on ``device`` (default the CPU)."""
        alive = np.ones((self.n_chips,), bool)
        for c, s in self.chip_failures:
            if int(t) >= s:
                alive[c] = False
        return torch.as_tensor(alive, device=device)

    def mask_events(self, events, t):
        """Silence dead chips' event streams (chips on the leading axis,
        ``t`` as for :meth:`alive_at`)."""
        alive = self.alive_at(t, device=events.valid.device)
        shape = (self.n_chips,) + (1,) * (events.valid.dim() - 1)
        return events._replace(valid=events.valid & alive.reshape(shape))

    def healthy_after(self, t: int) -> tuple:
        """The chips still alive after step ``t``: the ``healthy`` a
        rebuilt fabric is given."""
        dead = {c for c, s in self.chip_failures if s <= t}
        return tuple(c for c in range(self.n_chips) if c not in dead)

    def dead_links_after(self, t: int) -> tuple:
        """((chip, port), ...) of links cut at or before ``t``."""
        return tuple((c, p) for c, p, s in self.link_failures if s <= t)
