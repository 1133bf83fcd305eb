"""The paper's own system config: a BSS-2 wafer module (copy of
``repro.configs.bss2``).

46 HICANN-X chips x 512 AdEx neurons x 256 synapse rows; the per-step
event budget is sized for full-chip bursts.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.pulse_comm import PulseCommConfig


@dataclasses.dataclass(frozen=True)
class BSS2Config:
    name: str = "bss2"
    comm: PulseCommConfig = dataclasses.field(
        default_factory=lambda: PulseCommConfig(
            n_chips=46,                # one wafer module
            neurons_per_chip=512,      # HICANN-X AdEx circuits
            n_inputs_per_chip=256,     # synapse rows
            event_capacity=512,        # full-chip burst per step
            fanout=4,
            bucket_capacity=32,
            buckets_per_chip=1,
            ring_depth=32,
            mode="simplified",
        )
    )
    neuron_model: str = "adex"

    def reduced(self) -> "BSS2Config":
        return dataclasses.replace(
            self,
            name="bss2-reduced",
            comm=dataclasses.replace(
                self.comm, n_chips=4, neurons_per_chip=64,
                n_inputs_per_chip=64, event_capacity=64,
                bucket_capacity=16, ring_depth=16,
            ),
        )


CONFIG = BSS2Config()
