"""Fault-tolerant run loop: checkpoint and restart, failure injection,
straggler detection, chip-failure recovery (port of
``repro.runtime.fault``).

* **Restart determinism.**  All run state is one tree, and the inputs
  are a pure function of the step.  ``TrainRunner.run`` therefore
  survives a kill at any point: on restart it restores the newest
  COMMITTED checkpoint and replays, and ends with the same state as an
  uninterrupted run, bit for bit.
* **Failure domains.**  :class:`FailureInjector` simulates a host
  failure by raising at a chosen step.  ``resume_or(..., device=)``
  restores onto a given device.
* **Stragglers.**  :class:`StepTimer` keeps an EWMA of the step's wall
  time and records steps over ``threshold`` times it.
* **Chip failure.**  :class:`ResilientRunner` closes the loop with the
  fabric (:mod:`repro_torch.core.resilience`): the per-step detector
  reports the surviving chips; on a new death the runner unwinds through
  :class:`ChipFailure`, restores the newest committed checkpoint,
  rebuilds the step function on the survivors (a fabric with
  ``healthy=``, its routes recompiled around the dead chips) and replays.
  Words in flight ride in the checkpointed merge and send queues; those
  bound for a dead chip are culled into ``CommStats.lost_to_failure``.
  The replayed trajectory equals an uninterrupted run on the survivors
  from the same checkpoint, bit for bit.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, NamedTuple

from repro_torch import checkpoint as ckpt


class InjectedFailure(RuntimeError):
    """Simulated node failure (for tests and drills)."""


@dataclasses.dataclass
class FailureInjector:
    fail_at_step: int | None = None
    fired: bool = False

    def check(self, step: int) -> None:
        if (self.fail_at_step is not None and step == self.fail_at_step
                and not self.fired):
            self.fired = True
            raise InjectedFailure(f"injected node failure at step {step}")


@dataclasses.dataclass
class StepTimer:
    """EWMA of the step's wall time on the host clock; a step over
    ``threshold`` times the mean is recorded in ``stragglers``.

    On the card a step that does not synchronise is timed at dispatch
    (the host returns before the card has finished)."""

    ewma: float = 0.0
    beta: float = 0.9
    threshold: float = 2.0
    stragglers: list = dataclasses.field(default_factory=list)
    _last: float = 0.0

    def start(self) -> None:
        self._last = time.monotonic()

    def stop(self, step: int) -> float:
        dt = time.monotonic() - self._last
        if self.ewma == 0.0:
            self.ewma = dt
        if dt > self.threshold * self.ewma:
            self.stragglers.append((step, dt, self.ewma))
        self.ewma = self.beta * self.ewma + (1 - self.beta) * dt
        return dt


@dataclasses.dataclass
class TrainRunner:
    """Checkpointed step loop: ``step_fn(state, step) -> state``, the
    state any tree of tensors."""

    step_fn: Callable[[Any, int], Any]
    ckpt_dir: str
    ckpt_every: int = 10
    keep: int = 3
    async_ckpt: bool = True
    injector: FailureInjector | None = None
    timer: StepTimer = dataclasses.field(default_factory=StepTimer)

    def resume_or(self, init_state: Any, *,
                  device=None) -> tuple[Any, int]:
        """Restore the newest committed checkpoint into the structure of
        ``init_state`` (each leaf on its device, or on ``device``), or
        fall back to ``init_state``."""
        last = ckpt.latest_step(self.ckpt_dir)
        if last is None:
            return init_state, 0
        state = ckpt.restore(self.ckpt_dir, last, init_state, device=device)
        return state, last + 1

    def run(self, init_state: Any, n_steps: int) -> Any:
        state, start = self.resume_or(init_state)
        writer = (ckpt.AsyncCheckpointer(self.ckpt_dir) if self.async_ckpt
                  else None)
        try:
            for step in range(start, n_steps):
                if self.injector is not None:
                    self.injector.check(step)
                self.timer.start()
                state = self.step_fn(state, step)
                self.timer.stop(step)
                if (step + 1) % self.ckpt_every == 0 or step == n_steps - 1:
                    if writer is not None:
                        writer.save(state, step)
                    else:
                        ckpt.save(state, self.ckpt_dir, step)
        finally:
            if writer is not None:
                writer.close()
            ckpt.gc_old(self.ckpt_dir, keep=self.keep)
        return state


class ChipFailure(RuntimeError):
    """A chip death detected mid-run, with the step it was detected at and
    the surviving chips; raised inside :class:`ResilientRunner`'s step
    wrapper to unwind to the recovery boundary."""

    def __init__(self, step: int, surviving: tuple):
        self.step = int(step)
        self.surviving = tuple(surviving)
        super().__init__(
            f"chip failure detected at step {self.step}; "
            f"{len(self.surviving)} chips surviving")


class RecoveryEvent(NamedTuple):
    """One completed recovery: failure detected at ``detected_at``,
    resumed from step ``resumed_from`` (the newest committed checkpoint's
    step + 1, or 0) on the surviving ``healthy`` chips."""

    detected_at: int
    resumed_from: int
    healthy: tuple


@dataclasses.dataclass
class ResilientRunner:
    """Chip-failure recovery on top of :class:`TrainRunner`: freeze,
    restore, rebuild, replay, resume.

    * ``make_step(healthy)`` builds the step function for a set of healthy
      chips (a rebuild is where routes are recompiled:
      ``NetworkConfig(healthy=...)``).  It returns ``step_fn(state, step)
      -> (state, record)``; records land in ``self.records[step]``, and
      those of replayed steps are replaced, so the final records are
      exactly the degraded run's.
    * ``detect(state, step, healthy)`` reads the state after a step and
      returns the surviving chips, or ``None`` for no change.  A strict
      shrink raises :class:`ChipFailure`.
    * On a failure: unwind, restore the newest committed checkpoint,
      rebuild the step function on the survivors, replay.  Checkpoints
      are written synchronously here: a recovery must only ever see
      committed state.
    * **Flight recorder.**  With ``flight_of`` and ``flight_dir`` set,
      every :class:`ChipFailure` takes the telemetry flight ring from the
      failing state (``flight_of(state)``, e.g. ``lambda s:
      s.metrics.flight``) and dumps it, with the recoveries so far, as a
      JSONL post-mortem ``flight_dir/flight_<step>_<n>.jsonl`` (paths in
      ``self.flight_dumps``).  The dump comes before the
      ``max_recoveries`` check, so the last failure is dumped too.
    """

    make_step: Callable[[tuple], Callable[[Any, int], tuple]]
    detect: Callable[[Any, int, tuple], tuple | None]
    ckpt_dir: str
    n_chips: int
    ckpt_every: int = 10
    keep: int = 3
    max_recoveries: int = 4
    flight_of: Callable[[Any], Any] | None = None
    flight_dir: str | None = None
    records: dict = dataclasses.field(default_factory=dict)
    recoveries: list = dataclasses.field(default_factory=list)
    flight_dumps: list = dataclasses.field(default_factory=list)
    _last_state: Any = dataclasses.field(default=None, repr=False)

    def _dump_flight(self, failure: ChipFailure) -> None:
        if (self.flight_of is None or self.flight_dir is None
                or self._last_state is None):
            return
        from repro_torch.obs import dump_flight, phase_scope

        flight = self.flight_of(self._last_state)
        if flight is None:
            return
        with phase_scope("fabric/recovery_dump"):
            path = (f"{self.flight_dir}/flight_{failure.step:06d}"
                    f"_{len(self.flight_dumps)}.jsonl")
            dump_flight(path, flight, recoveries=self.recoveries,
                        failure=failure,
                        meta={"n_steps_detected_at": failure.step,
                              "recoveries_so_far": len(self.recoveries)})
            self.flight_dumps.append(path)

    def run(self, init_state: Any, n_steps: int,
            healthy: tuple | None = None) -> tuple:
        """Run to ``n_steps``, recovering from chip deaths on the way.
        Returns ``(final_state, healthy)``; raises the last
        :class:`ChipFailure` once more than ``max_recoveries`` recoveries
        would be needed."""
        healthy = (tuple(range(self.n_chips)) if healthy is None
                   else tuple(sorted(healthy)))
        while True:
            inner = self.make_step(healthy)

            def step_fn(state, step, _inner=inner, _healthy=healthy):
                state, record = _inner(state, step)
                self.records[step] = record
                self._last_state = state
                surviving = self.detect(state, step, _healthy)
                if surviving is not None:
                    surviving = tuple(sorted(surviving))
                    if surviving != _healthy:
                        raise ChipFailure(step, surviving)
                return state

            runner = TrainRunner(
                step_fn=step_fn, ckpt_dir=self.ckpt_dir,
                ckpt_every=self.ckpt_every, keep=self.keep,
                async_ckpt=False)
            try:
                return runner.run(init_state, n_steps), healthy
            except ChipFailure as failure:
                self._dump_flight(failure)
                if len(self.recoveries) >= self.max_recoveries:
                    raise
                last = ckpt.latest_step(self.ckpt_dir)
                resume_at = 0 if last is None else last + 1
                for s in [s for s in self.records if s >= resume_at]:
                    del self.records[s]
                healthy = failure.surviving
                self.recoveries.append(RecoveryEvent(
                    detected_at=failure.step, resumed_from=resume_at,
                    healthy=healthy))
