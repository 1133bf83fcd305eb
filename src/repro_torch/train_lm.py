"""End-to-end training run: train a ~100M-parameter LM for a few
hundred steps with the full substrate (deterministic data pipeline,
AdamW, async checkpointing, crash-resumable); the port's counterpart of
``examples/train_lm.py``, with its two presets.

``tiny`` (~2M parameters) is sized for the CPU tests; ``100m`` is the
run for the card.  Both resume from ``--ckpt-dir`` if interrupted.

  PYTHONPATH=src python -m repro_torch.train_lm --device cpu --steps 60
  PYTHONPATH=src python -m repro_torch.train_lm --preset 100m --steps 300
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

import torch

from repro_torch import checkpoint as ckpt
from repro_torch import configs as C
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import Prefetcher, stream
from repro_torch.kernels import common as kc
from repro_torch.launch.train import build_train_state, make_step
from repro_torch.models import lm
from repro_torch.models.spec import count_params

PRESETS = {
    # ~2M params: runs everywhere
    "tiny": dict(d_model=128, n_layers=4, n_heads=4, n_kv_heads=2,
                 d_ff=512, vocab_size=2048, batch=8, seq=64),
    # ~100M params: the deliverable-scale config (the card)
    "100m": dict(d_model=768, n_layers=12, n_heads=12, n_kv_heads=4,
                 d_ff=2048, vocab_size=32000, batch=32, seq=512),
}


def preset_config(name: str):
    """internlm2-1.8b's family at a preset's widths, in float32."""
    p = PRESETS[name]
    return dataclasses.replace(
        C.get("internlm2-1.8b"), name=f"lm-{name}", d_model=p["d_model"],
        n_layers=p["n_layers"], n_heads=p["n_heads"],
        n_kv_heads=p["n_kv_heads"], d_head=p["d_model"] // p["n_heads"],
        d_ff=p["d_ff"], vocab_size=p["vocab_size"], dtype="float32")


def main(argv=None) -> dict:
    """Train; returns the final state."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", choices=PRESETS, default="tiny")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch_train_lm"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = kc.resolve_device(args.device)

    p = PRESETS[args.preset]
    cfg = preset_config(args.preset)
    shape = ShapeConfig("train", p["seq"], p["batch"], "train")
    n_params = count_params(lm.model_spec(cfg))
    print(f"config {cfg.name}: {n_params/1e6:.1f}M params, "
          f"batch {p['batch']}x{p['seq']}")

    gen = torch.Generator(device=device).manual_seed(args.seed)
    state = build_train_state(gen, cfg, device=device)
    start = 0
    last = ckpt.latest_step(args.ckpt_dir)
    if last is not None:
        state = ckpt.restore(args.ckpt_dir, last, state)
        start = last + 1
        print(f"resumed from checkpoint at step {last}")

    step_fn = make_step(cfg, peak_lr=args.lr, total_steps=args.steps,
                        remat=False, warmup_steps=20)

    writer = ckpt.AsyncCheckpointer(args.ckpt_dir)
    t0, tokens = time.time(), 0
    try:
        for step, batch in Prefetcher(stream(cfg, shape, args.seed,
                                             start_step=start),
                                      device=device):
            if step >= args.steps:
                break
            state, metrics = step_fn(state, batch)
            tokens += p["batch"] * p["seq"]
            if step % 10 == 0 or step == args.steps - 1:
                print(f"step {step:4d}  loss {float(metrics['loss']):.4f}  "
                      f"gnorm {float(metrics['grad_norm']):.2f}  "
                      f"{tokens/(time.time()-t0):,.0f} tok/s", flush=True)
            if (step + 1) % 20 == 0 or step == args.steps - 1:
                writer.save(state, step)
    finally:
        writer.close()
        ckpt.gc_old(args.ckpt_dir, keep=2)
    if device.type == "cuda":
        print(f"peak device memory {torch.cuda.max_memory_allocated(device)} "
              f"B")
    print("done — rerun the same command to resume from the last checkpoint")
    return state


if __name__ == "__main__":
    main()
