"""Training entry point: checkpointed, fault-tolerant, resumable
(``repro.launch.train`` on one device).

Runs the trainer's step against the synthetic deterministic data stream,
on the card by default (``--device cpu`` runs the plain versions).  On
the CPU use ``--reduced`` (the tiny same-family config).

  PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \\
      --reduced --steps 50 --device cpu --ckpt-dir ckpt
  # kill it mid-run, rerun the same command: it resumes from the last
  # committed checkpoint and reproduces the uninterrupted run exactly.

Weights come from a ``torch.Generator`` seeded with ``--seed``, so they
differ from the reference's for the same seed; the batches are the
reference's, bitwise.  The attention's gradient comes from the
flash-attention backward kernels, zamba2's scan's from the chunked scan
backward kernel (``csrc/ssm_scan_bwd_chunked.cu``) and falcon-mamba's
(Mamba-1, a general [di, N] A) from the per-channel one
(``csrc/ssm_scan_bwd.cu``), so every ported arch trains on the card
(falcon-mamba-7b at full depth needs more memory than one 80 GB card
holds; ``chip_smoke.py`` trains 16 of its 64 layers; llama4 runs only at
reduced size).  An MoE arch (granite-moe-1b-a400m) adds its routing
metrics to each logged step: ``aux`` (the load-balancing loss, weighted
into the loss), ``drop`` (the share of token-expert lanes past capacity)
and ``util`` (the bucket fill):

  PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-2.7b \
      --batch 4 --seq 512 --steps 20

An encoder-decoder (whisper-medium) takes the reference's training
layout: ``--seq`` frames for the encoder (the stream's float32
``frames`` leaf, moved by the ``Prefetcher`` with the tokens) and
``max_target_len`` (448) decoder tokens; the printed tok/s counts batch
x seq, the frames, as the reference does:

  PYTHONPATH=src python -m repro_torch.launch.train --arch whisper-medium \
      --batch 4 --seq 1500 --steps 20

``make_compressed_step`` is the reference's data-parallel trainer: each
rank of a ``torch.distributed`` group takes its share of the batch, and
the gradients cross the ranks through the error-feedback codecs of
``optim/compression.py`` (int8, top-k or none) on the mesh's ``"data"``
group.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from repro_torch import checkpoint as ckpt
from repro_torch import configs as C
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.data import pipeline as dp
from repro_torch.kernels import common as kc
from repro_torch.models import lm
from repro_torch.models.spec import tree_leaves, tree_map
from repro_torch.optim import adamw, compression, schedules


def build_train_state(gen: torch.Generator, cfg: ArchConfig, *,
                      device="cuda") -> dict:
    """``{"params": random weights from gen, "opt": adamw.init(...)}`` on
    ``device``."""
    params = lm.init(gen, cfg, device=device)
    return {"params": params, "opt": adamw.init(params)}


def _loss_and_grads(cfg, params: dict, batch: dict, rules, remat: bool):
    """(metrics detached, gradients) of ``lm.loss_fn`` with respect to
    fresh leaves of ``params`` (so no gradient carries over from an
    earlier step)."""
    params = tree_map(lambda x: x.detach().requires_grad_(True), params)
    loss, metrics = lm.loss_fn(cfg, params, batch, rules=rules, remat=remat)
    grads = iter(torch.autograd.grad(loss, tree_leaves(params)))
    # Detached, so the metrics hold no graph past the step.
    return ({k: v.detach() for k, v in metrics.items()},
            tree_map(lambda _: next(grads), params))


def make_step(cfg: ArchConfig, rules=None, *, peak_lr: float,
              total_steps: int, remat: bool = True,
              warmup_steps: int | None = None):
    """``step(state, batch) -> (state, metrics)``: the loss and its
    gradients (``rules`` passed to ``lm.loss_fn``), then ``adamw.update``
    without autograd at the warm-up/cosine rate of the step count
    (``warmup_steps`` defaults to a twentieth of ``total_steps``).  The
    state passed in is not changed."""
    if warmup_steps is None:
        warmup_steps = max(total_steps // 20, 1)

    def step(state, batch):
        metrics, grads = _loss_and_grads(cfg, state["params"], batch, rules,
                                         remat)
        lr = schedules.warmup_cosine(
            state["opt"].count, peak_lr=peak_lr,
            warmup_steps=warmup_steps, total_steps=total_steps)
        new_params, new_opt, om = adamw.update(grads, state["opt"],
                                               state["params"], lr=lr)
        metrics.update(om)
        return {"params": new_params, "opt": new_opt}, metrics

    return step


def make_compressed_step(cfg: ArchConfig, mesh, *, peak_lr: float,
                         total_steps: int, method: str = "int8",
                         topk_frac: float = 0.01):
    """The data-parallel trainer with error-feedback compressed gradients:
    ``step(state, batch, gen) -> (state, metrics)`` over ``state =
    {"params", "opt", "ef"}`` (``ef`` a ``compression.EFState``), run on
    every rank of ``mesh`` (a ``DeviceMesh`` with a ``"data"`` axis, e.g.
    ``launch.mesh.make_host_mesh()``) with the rank's share of the batch.

    Each rank computes its local loss and gradients (no rules, no remat,
    as the reference's ``local_step``), then ``compressed_psum`` over the
    data group with ``method`` (``gen``, seeded alike on every rank, draws
    int8's noise); the metrics are averaged over the group, and
    ``adamw.update`` runs at the warm-up/cosine rate.  Parameters and
    moments stay replicated and equal on every rank.  ``ef`` is each
    rank's own residual, one float32 tensor a parameter: error feedback
    is per worker.  (The reference declares ``ef`` as ``P("data")``,
    which splits the first dimension of each param-shaped residual over
    the data axis, so its layout holds only at data size 1.)"""
    import torch.distributed as dist

    group = mesh.get_group("data")
    warmup_steps = max(total_steps // 20, 1)

    def step(state, batch, gen):
        metrics, grads = _loss_and_grads(cfg, state["params"], batch, None,
                                         False)
        reduced, ef = compression.compressed_psum(
            grads, state["ef"], gen, mesh, "data", method=method,
            topk_frac=topk_frac)
        del grads
        # The metrics' mean over the group, one all-reduce for all.
        names = sorted(metrics)
        mean = torch.stack([metrics[k] for k in names])
        dist.all_reduce(mean, op=dist.ReduceOp.SUM, group=group)
        mean = mean / dist.get_world_size(group)
        metrics = {k: mean[i] for i, k in enumerate(names)}
        lr = schedules.warmup_cosine(
            state["opt"].count, peak_lr=peak_lr,
            warmup_steps=warmup_steps, total_steps=total_steps)
        new_params, new_opt, om = adamw.update(reduced, state["opt"],
                                               state["params"], lr=lr)
        metrics.update(om)
        return {"params": new_params, "opt": new_opt, "ef": ef}, metrics

    return step


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Train; returns the final state."""
    args = parse_args(argv)
    device = kc.resolve_device(args.device)
    cfg = C.get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    shape = ShapeConfig("cli", args.seq, args.batch, "train")

    gen = torch.Generator(device=device).manual_seed(args.seed)
    state = build_train_state(gen, cfg, device=device)
    start = 0
    last = ckpt.latest_step(args.ckpt_dir)
    if last is not None:
        state = ckpt.restore(args.ckpt_dir, last, state)
        start = last + 1
        print(f"resumed from step {last}")

    step_fn = make_step(cfg, peak_lr=args.lr, total_steps=args.steps,
                        remat=False)
    writer = ckpt.AsyncCheckpointer(args.ckpt_dir)
    it = dp.Prefetcher(dp.stream(cfg, shape, args.seed, start_step=start),
                       device=device)
    t0 = time.time()
    try:
        for step, batch in it:
            if step >= args.steps:
                break
            state, metrics = step_fn(state, batch)
            if step % args.log_every == 0 or step == args.steps - 1:
                loss = float(metrics["loss"])
                toks = (step - start + 1) * args.batch * args.seq
                rate = toks / max(time.time() - t0, 1e-9)
                moe = "".join(
                    f"{name} {float(metrics[key]):.4f}  " for key, name in (
                        ("aux_loss", "aux"), ("drop_fraction", "drop"),
                        ("bucket_utilization", "util")) if key in metrics)
                print(f"step {step:5d}  loss {loss:.4f}  "
                      f"gnorm {float(metrics['grad_norm']):.3f}  {moe}"
                      f"{rate:,.0f} tok/s", flush=True)
            if (step + 1) % args.ckpt_every == 0 or step == args.steps - 1:
                writer.save(state, step)
    finally:
        writer.close()
        ckpt.gc_old(args.ckpt_dir, keep=3)
    print("done")
    return state


if __name__ == "__main__":
    main()
