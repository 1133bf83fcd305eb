"""Pulse-communication core on one device, chips on a leading axis."""

from repro_torch.core import resilience
from repro_torch.core.resilience import (
    FabricFaultInjector,
    HealthConfig,
    HealthState,
)

__all__ = ["resilience", "FabricFaultInjector", "HealthConfig",
           "HealthState"]
