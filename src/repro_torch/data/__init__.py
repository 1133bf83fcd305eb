"""Deterministic data streams and background prefetch
(``repro.data``)."""

from repro_torch.data.pipeline import (Prefetcher, batch_at, poisson_inputs,
                                       stream)

__all__ = ["Prefetcher", "batch_at", "poisson_inputs", "stream"]
