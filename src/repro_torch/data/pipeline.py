"""Data pipeline: deterministic synthetic streams and background
prefetch (``repro.data.pipeline``).

Determinism is the fault-tolerance contract: ``batch_at(seed, step)`` is a
pure function with the reference's numpy generator and seed formula, so
its batches are bitwise the reference's, and a restart at step N replays
exactly the batches an uninterrupted run would have seen (no loader state
to checkpoint beyond the step counter).

The prefetcher is the host-side analogue of the paper's host ring buffer:
a bounded queue between a producer thread and the device consumer, the
credit count being ``queue.Queue(maxsize=depth)`` (back-pressure when
full, a stall when empty), cf. ``repro_torch.core.flowcontrol``.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterator

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.kernels import common as kc


def batch_at(cfg: ArchConfig, shape: ShapeConfig, seed: int, step: int,
             *, batch_override: int | None = None) -> dict:
    """Pure function (seed, step) -> host batch (numpy int32 tokens and
    targets; float32 frames for an encoder-decoder)."""
    rng = np.random.default_rng(np.uint64(seed * 1_000_003 + step))
    gb = batch_override or shape.global_batch
    s = shape.seq_len
    if cfg.is_encdec:
        frames = rng.standard_normal((gb, s, cfg.d_model), dtype=np.float32)
        toks = rng.integers(0, cfg.vocab_size, (gb, cfg.max_target_len + 1),
                            dtype=np.int32)
        return {"frames": frames, "tokens": toks[:, :-1],
                "targets": toks[:, 1:]}
    toks = rng.integers(0, cfg.vocab_size, (gb, s + 1), dtype=np.int32)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def stream(cfg: ArchConfig, shape: ShapeConfig, seed: int,
           start_step: int = 0, **kw) -> Iterator[tuple[int, dict]]:
    step = start_step
    while True:
        yield step, batch_at(cfg, shape, seed, step, **kw)
        step += 1


def to_device(batch: dict, device) -> dict:
    """A host batch as tensors on ``device``: integer arrays as int64 (the
    index type of embedding lookups and ``gather``), others in their own
    type; on a CUDA device through pinned host memory, without blocking
    the host."""
    device = kc.resolve_device(device)
    out = {}
    for name, arr in batch.items():
        x = torch.from_numpy(np.ascontiguousarray(arr))
        if not x.is_floating_point():
            x = x.to(torch.int64)
        if device.type == "cuda":
            x = x.pin_memory().to(device, non_blocking=True)
        out[name] = x.to(device)
    return out


class Prefetcher:
    """Bounded background prefetch + device placement.

    depth = the credit count; a slow host (straggler) is absorbed up to
    ``depth`` steps before the device stalls.  ``place`` turns a host
    batch into what the step takes; by default :func:`to_device` on
    ``device``.  Placement runs on the consumer's thread, as in the
    reference.
    """

    def __init__(self, it: Iterator[Any], *, depth: int = 2,
                 place: Callable[[Any], Any] | None = None,
                 device="cuda"):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._place = place or (lambda b: to_device(b, device))
        self._it = it
        self._done = object()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        try:
            for item in self._it:
                self._q.put(item)
        finally:
            self._q.put(self._done)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._done:
            raise StopIteration
        step, batch = item
        return step, self._place(batch)


def poisson_inputs(seed: int, n_steps: int, n_chips: int, n_inputs: int,
                   rate: float) -> np.ndarray:
    """Spike-source stream for SNN experiments: [T, n_chips, n_inputs]
    float32.  It takes the integer seed of its numpy generator, where the
    reference takes a JAX key and draws that integer from it
    (``jax.random.randint(key, (), 0, 2**31)``): the same integer gives
    the reference's stream bitwise."""
    rng = np.random.default_rng(int(seed))
    return (rng.random((n_steps, n_chips, n_inputs)) < rate).astype(np.float32)
