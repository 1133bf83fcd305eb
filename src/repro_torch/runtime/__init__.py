"""Fault-tolerant run loop and chip-failure recovery (port of
``repro.runtime``)."""

from repro_torch.runtime.fault import (
    ChipFailure,
    FailureInjector,
    InjectedFailure,
    RecoveryEvent,
    ResilientRunner,
    StepTimer,
    TrainRunner,
)

__all__ = [
    "ChipFailure",
    "FailureInjector",
    "InjectedFailure",
    "RecoveryEvent",
    "ResilientRunner",
    "StepTimer",
    "TrainRunner",
]
