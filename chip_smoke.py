#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--steps 64]

Phases, each fatal on failure:
  1. build   the CUDA kernels from ``src/repro_torch/csrc`` (nvcc, sm_90a,
             one process per source, all started together); ptxas's
             registers and spills per kernel, and no spill in the
             flash-attention instances of head size 80 and 128 (bf16 and
             float32) nor in any backward instance; the backward's SASS
             holds HMMA in every instance (TF32 in each float32 one)
             and no atomic; no spill in any instance of the scan's
             general-A backward (``csrc/ssm_scan_bwd.cu``: the chunk
             form's 10 ``ssm_scan_bwd_chunk_kernel`` and 5
             ``ssm_scan_bwd_carry_kernel`` instances, the walk form's 6
             ``ssm_scan_bwd_kernel``); the per-head
             backward's 3 instances (``ssm_scan_bwd_chunked.cu``) with no
             spill and no stack frame, TF32 HMMA in the SASS of each and
             no atomic;
  2. kernels each kernel against its plain PyTorch version on the card,
             bitwise on every output of the SNN kernels, on inputs taken
             from the first block of each path below, in every mode the
             fabric uses, and flash attention and the SSM scan at the
             serve paths' prefill shapes (flash at granite-moe's head
             size 64 too; each flash and scan row also
             prints its design, TFLOP/s and share of the bound, flash its
             time over SDPA's; the scan runs on the path's inputs, A per
             head, and on a general A); its time
             (CUDA events over a CUDA graph of back-to-back calls), the
             kernel's own device time (torch.profiler; the difference is
             the wrapper's tensor ops), the plain version's time (CUDA
             events), bytes, the bound at 3.35 TB/s or 67 T op/s (bf16
             flash at 989 T op/s, float32 flash in 3xTF32 at 165) and, for
             the sorts, stable ``torch.sort`` plus the gather, for flash
             attention ``scaled_dot_product_attention``; the training
             path's attention kernels (``flash_train_cases``): the forward
             with lse and ``flash_attention_bwd`` (its two kernels, dQ and
             dK/dV, timed together and apart; bf16 on ``mma.sync``,
             float32 in 3xTF32 on ``mma.sync``, each case with its route
             and its kernels' registers and spill bytes) at internlm2's,
             zamba2's and granite-moe's training heads, in f32 and after
             cached keys, and at whisper-medium's training shapes (the
             encoder's 1500 x 1500 and the cross-attention's 448 x 1500
             without the mask, the decoder's 448 x 448; the forward also
             at the encoder's and both cross shapes, 8 and 448 rows over
             1500 frames, beside SDPA without the mask),
             elementwise within ``attention_bwd_bounds`` (a peaked f32
             softmax within ``tf32x3_bwd_bounds``), beside SDPA's
             backward; the scan with its state checkpoints (at the
             prefill and at zamba2's training shape, [4, 512, 5120] N 64)
             and ``ssm_scan_bwd`` at the training shape (x bf16, A per
             head), with a general A and x f32 and on a ragged shape (N
             100: the walk form), each gradient within 1e-4 of its
             largest against ``ssm_scan_bwd_ref``, two calls the same
             bits, each case with its form, time over bound, resident
             warps an SM of each kernel
             (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), its
             kernels' device times and the kernels one call launches; the
             per-head (chunked) backward ``ssm_scan_heads_bwd`` at the
             same shape (the main case), on a ragged shape with a
             final-state gradient and with x f32, each gradient within
             1e-4 of its largest against ``ssm_scan_heads_bwd_ref``, two
             calls the same bits, its bound by 3xTF32 operations and by
             bytes, and its time beside the per-channel backward's;
             falcon-mamba's general routes with its published A
             (A[d, n] = -(n + 1)), x bf16: ``ssm_scan`` at its prefill,
             [4, 2048, 8192] N 16, within 1e-4, its bound by bytes and
             operations beside its exp floor (one MUFU.EX2 per state
             element and step, 16 a clock on each SM), and
             ``ssm_scan_bwd`` at its training shape, [4, 512, 8192] N
             16 (the backward's main case), within 1e-4 of each
             gradient's largest, two calls the same bits.
             zamba2's long context: ``flash_attention`` with the sliding
             window (bf16 and f32 at [1, 32, 32768, 80], window 4096,
             against the plain version on blocks of query rows, SDPA with
             the window as a boolean mask beside it; the windowed bf16
             call must take at most ``WINDOW_SHARE`` of the same call
             without the window; ragged cases, GQA 2, causal and not) and
             ``ssd_chunked`` (x bf16 [1, 32768, 5120], 80 heads of 64, N
             64, chunk 256, the main case; in f32; at [4, 2048, 5120];
             ragged with an initial state), within 2^-7 (bf16) or 1e-4
             (f32) of each output's largest, its three kernels' device
             times and its exp floor.
             ``bucket_pack``
             (the wafer's flush), ``lif_step`` and every case of
             ``fused_inject`` and ``fused_lif_inject`` print their launch
             plan (grid, threads, shared bytes, ptxas's registers), must
             put exactly one kernel on the card per wrapper call
             (torch.profiler), and print the host time per wrapper call
             (1,000 calls, one synchronise); beside ``lif_step``, the
             launch floor: one ``torch.add`` over the same [46, 512]
             float32, and beside ``fused_inject``, a write floor: one
             ``torch.full`` of the slab's shape with -1, each timed the
             same way.  The sorts run
             on the entry phase's merge cycle (46 x 3136 lanes; each SoA
             row prints its radix passes) and the SoA sort also on
             deadlines over the whole int32 range (4 passes).  Also the
             pipelined path's drains (rate mode, ``extra_ahead`` 8: its
             first steady stage with the gate all on, and the prologue
             with the gate all off, which must emit sentinels, keep the
             ring and the queue and expire nothing), the flow path's
             pack of one substep into column k of the slab in place (46
             rows of 512 send-queue lanes ahead of 2,048 fresh ones, its
             first and fourth substeps), and ``fused_inject`` on the
             degraded path's first block with its reach row (``lost``
             bitwise), beside the same block with a row of ones and with
             no row, and ``fused_lif_inject`` with the reach row;
  3. entry   the entry points off the network's path, counters zeroed
             first: ``merge_drain_words(use_pallas=True)`` on the first
             feedforward block's delivered words must equal
             ``fused_drain``'s rate mode (queue, words, drops);
             ``kernels.merge_sort`` on the same lanes; and
             ``fused_lif_inject`` on the feedforward cell's first block,
             whose spikes must equal the network's;
  4. wafer   ``configs/bss2.py`` as is (46 chips x 512 AdEx, fan-out 4,
             simplified, B 1): bucket_pack and fused_drain must launch and
             Σ sent == Σ (deposits + expired + overflow + merge_dropped);
  5. feedforward  the paper demo (2 x 64 LIF, fan-out 1) against its plain
             run on the CPU, then the wafer widths with fan-out 1, LIF,
             full mode, 2 buckets per chip, merge_rate 128, B 8:
             fused_inject, fused_drain and lif_step must launch;
  6. plastic ``run_plastic`` on the feedforward configuration (default
             STDPConfig): conservation, finite weights, and its first 16
             steps equal a plain run on the CPU;
  7. dense   ``comm_mode="dense"`` at the wafer widths with LIF and the
             wafer's fan-out-4 LUT: its first 16 steps equal a plain run
             on the CPU, then 3 surrogate-gradient steps of a rate loss
             (T 16) with a finite, nonzero gradient;
     pipelined  the feedforward path's widths and config on the
             pipelined schedule (``pipeline=True``), a LUT with delays 16
             to 24 (> 2B - 1): fused_inject, fused_drain and lif_step must
             launch; its first 16 steps equal a plain run on the CPU
             (spikes, integer stats, ring, merge queue); spikes, ring and
             every integer stat equal the serial run on the card; a
             streaming drive of 4 ``pipeline_block`` calls closes
             conservation with the in-flight leg, and ``flush_pending``
             empties it;
     flow    the dense path's network (wafer widths and LUT, LIF) on the
             event path under ``FlowControlConfig(capacity=16,
             drain_rate=8, retransmit_depth=512)``: bucket_pack (one launch
             per substep), fused_drain and lif_step must launch; the gate
             must bind (stalled words or a non-empty send queue); its
             first 16 steps equal a plain run on the CPU (spikes, stats,
             credits, send queue); Σ sent == deposits + expired +
             overflow + merge_dropped + stalled + queued;
     routed  the feedforward path's config and LUT through
             ``topology.switch_tree(2, 23, link_latency=1,
             trunk_latency=1)`` (chip -> FPGA -> switch: path latency 2
             within a group, 4 across): fused_inject, fused_drain and
             lif_step must launch; its first 16 steps equal a plain run
             on the CPU (spikes, every integer stat, ``link_words [B, 46,
             4]`` included, ring, merge queue); conservation closes; the
             same widths in simplified mode (1 bucket per chip) equal,
             spike for spike, a run on the dense transport whose LUT
             delays are raised by ``latency[src, dest]``;
     degraded  the same on ``topology.torus2d(2, 23, link_latency=1)``
             with chips 7 and 30 dead and link (12, 2) cut: fused_inject
             (with its reach row), fused_drain and lif_step must launch;
             ``lost_to_failure`` > 0, no traffic and no link word to or
             from a dead chip; conservation with the lost leg; its first
             16 steps equal a plain run on the CPU;
     resilient  the slice's main path: the degraded path's widths and
             LUT at B 1 through ``torus2d(2, 23, link_latency=1)`` from
             full health, telemetry ``MetricsConfig(flight_depth=16)``,
             under ``ResilientRunner(ckpt_every=4)`` for T 32 with chips
             7 and 30 killed at steps 13 and 22 (``FabricFaultInjector``:
             inputs masked, dead chips' neuron and ring rows frozen, the
             network rebuilt with ``healthy=`` on the survivors):
             fused_inject (with its reach row after the first recovery),
             fused_drain and lif_step must launch, and no kernel library
             may be built or loaded again; the recoveries must be (13,
             12, all but 7) and (22, 20, all but 7 and 30), the records
             cover T, and from each resume point spikes and every integer
             stat equal an uninterrupted run on the survivors from the
             same checkpoint; no spike from a dead chip after its kill;
             ``lost_to_failure`` > 0; two flight dumps whose blocks equal
             the failing trajectory's per-step stats; the whole drill on
             the CPU gives the same records, recoveries, final state
             (integers bitwise, voltages within 1e-5 of max(|v|, 1), the
             telemetry EMAs within 1e-6 relative) and dumps; then the
             checkpoint's bytes and ms per save and per restore;
     telemetry  the feedforward (B 8) and pipelined paths with
             ``telemetry=True``: spikes, ring and every stat equal the run
             without; the carry after 16 steps equals the CPU's (integers
             bitwise, floats within 1e-6 relative); ``check_conservation``
             closes from ``metrics_summary``'s totals with the queued and
             in-flight legs;
     shard  the shard forms (one GPU per chip) at world 1: a process
             group on NCCL through a file store (no TCP port; no NCCL is
             fatal) and ``launch.mesh.make_chip_mesh()``, every chip on
             the one rank, the exchange one ``all_to_all_single``:
             ``shard_superstep`` on the feedforward path (B 8),
             ``shard_pipeline_block`` + ``shard_flush_pending`` on the
             pipelined one, ``shard_superstep`` through the degraded
             torus (one ``all_gather`` of the per-pair counts too), each
             equal to the card's local ``net.run`` in every leaf (spikes,
             voltages, every stat, ring, merge queue, pipeline carry),
             fused_inject, fused_drain and lif_step launched (counters
             zeroed before each form); the psum heartbeat against
             ``beats_local`` (chips 7 and 30 silent); ``fused_inject``
             and ``fused_lif_inject`` at ``n_rows`` 23 of 46 chips (the
             degraded reach rows [23:46]) against their plain versions
             and the 46-row calls' rows; with a second GPU, world 2 (23
             chips a rank) against the local run and its wall ms per
             step, else a line saying it was skipped; the profile of
             ``shard_superstep`` against the local run (launches, device
             busy and wall ms per step, NCCL kernels by name); the
             process group destroyed at the end;
  8. serve-check  zamba2-2.7b at full width, one pattern repeat (6
             layers), then falcon-mamba-7b at full width, 4 Mamba-1 layers
             with its published A, then granite-moe-1b-a400m at full
             width, 2 attention+MoE layers, then whisper-medium at full
             width, 2 encoder and 2 decoder layers over 300 frames from 8
             prompt tokens, then llama3-8b, yi-9b, mistral-nemo-12b and
             chameleon-34b at full width, 2 layers each, float32, batch 1,
             prompt 300,
             8 teacher-forced decode steps, then zamba2 again at 6 layers
             with ``ssm_impl="ssd"`` (chunk 64) and window 128, prefill and
             one windowed decode step: the card (kernels) against the
             plain path on the CPU from the same weights and tokens,
             granite's routing of every MoE call bitwise first (expert
             choices, slots, counts; the smallest gap between the k-th
             and (k+1)-th router probability printed), every step's
             logits within 1e-3 of the largest |logit|;
  9. serve   ``launch.serve.main`` on zamba2-2.7b (54 layers),
             internlm2-1.8b (24 layers), falcon-mamba-7b (64 layers) and
             granite-moe-1b-a400m (24 layers, 32 experts top-8) at full
             width in bfloat16, batch 4, prompt 2048, 32 tokens, and
             whisper-medium (24 encoder + 24 decoder layers) on 1500
             frames and 8 prompt tokens (frames/s printed), then the dense
             llama3-8b (32 layers), yi-9b (48), mistral-nemo-12b (40) and
             chameleon-34b (48, 63.9 GiB of weights), then
             llama4-maverick-400b-a17b at full width on one repeat of its
             pattern (a dense and an MoE layer of 128 experts, top-1)
             through ``launch.serve.serve``; after zamba2's run, its
             long-context path on the same weights (``long_context``:
             ``ssm_impl="ssd"``, chunk 256, window 4096; a windowed
             prefill of 1 x 32768 tokens, 32 windowed decode steps over
             the padded cache, tok/s and peak memory, 54 ssd_chunked and
             9 flash_attention launches a prefill and no ssm_scan; the
             long_500k ring of 4096 slots, 32 steps; "ssd" against "scan"
             at 4 x 2048 in turns): prefill must launch
             flash_attention 9 and ssm_scan 54 times (zamba2),
             flash_attention 24 times (internlm2, granite), 72 times
             (whisper), once a layer (the dense archs, llama4) or ssm_scan
             64 times (falcon-mamba), and decode none of the port's
             kernels; then, from the same weights (falcon-mamba's with its
             published A, no layer's A with a constant row; an MoE arch's
             prefill routing metrics at its capacity factor 1.25 printed
             first), prefill + one decode step against a full forward at
             the next position, in float32 and in bf16 (``consistency``;
             an MoE arch at capacity factor 8; the float32 half on the
             repeats whose float32 copy fits beside the weights); tok/s
             and peak memory;
     bf16-check  internlm2-1.8b at full width, 2 layers, bf16: a forward's
             logits on the card against the plain path on the CPU, within
             2^-4 of the largest |logit|;
     train-check  internlm2-1.8b at full width, 2 layers, float32: loss
             and every gradient of ``lm.loss_fn`` on the card (remat off
             and full) against the CPU, the loss within 1e-5 relative and
             each gradient within 1e-3 of its leaf's largest |g|; then
             granite-moe-1b-a400m the same way, its routing bitwise
             first; then whisper-medium, 2 encoder and 2 decoder layers,
             64 frames and 448 target tokens (6 flash_attention and 6
             flash_attention_bwd launches, 12 forwards under remat); then
             mistral-nemo-12b, 2 layers; then
             zamba2-2.7b at full width, 6 layers, float32, batch 2 x 100:
             the same on the card (remat off and full) against the CPU,
             every gradient within ``ZAMBA2_GRAD_BOUND`` of its leaf's
             largest, 6 (12 under remat) ssm_scan and 6 ssm_scan_heads_bwd
             launches, 1 (2) flash_attention and 1 flash_attention_bwd,
             and the CPU's own conditioning printed beside it; then
             falcon-mamba-7b the same way at 2 layers with its published
             A, within ``FALCON_GRAD_BOUND``: 2 (4) ssm_scan and 2
             ssm_scan_bwd launches, none of ssm_scan_heads_bwd;
     train   the training path: internlm2-1.8b at full width and depth,
             bf16, batch 4 x 512, 4 AdamW steps through
             ``launch.train.make_step``, the ``Prefetcher`` and one
             ``AsyncCheckpointer`` save of the whole state into a
             temporary directory: loss, grad norm, ms and tok/s per step,
             24 flash_attention and 24 flash_attention_bwd launches per
             step, peak memory, the checkpoint's bytes and seconds, and a
             profile of one more step; then zamba2-2.7b the same way (54
             layers, 3 steps, no checkpoint written): 54 ssm_scan, 54
             ssm_scan_heads_bwd (0 of the per-channel ssm_scan_bwd), 9
             flash_attention and 9 flash_attention_bwd launches per step;
             then falcon-mamba-7b at full width, 16 of its 64 layers, its
             published A, 3 steps, no checkpoint: 16 ssm_scan and 16
             ssm_scan_bwd launches per step (0 of ssm_scan_heads_bwd),
             and the device ms a step of ssm_scan_bwd's kernels; then
             granite-moe-1b-a400m at full width and depth, 4 steps, no
             checkpoint: 24 flash_attention and 24 flash_attention_bwd
             launches per step, no scan kernel, and the step's MoE
             metrics (aux_loss, drop_fraction, bucket_utilization)
             finite; then whisper-medium at full width and depth, batch
             4 x 1500 frames x 448 target tokens, 4 steps, no
             checkpoint: 72 flash_attention and 72 flash_attention_bwd
             launches per step; then mistral-nemo-12b at full width on
             ``MISTRAL_TRAIN_LAYERS`` of its 40 layers, 3 steps, no
             checkpoint, a flash_attention and a flash_attention_bwd
             launch a layer and step;
 10. profile where a block's time goes on each path (torch.profiler):
             wall and device-busy time per step, the idle share, kernel
             launches per step, the costliest kernels and the device time
             under each phase scope (``fabric/inject``,
             ``fabric/exchange``, ``fabric/drain``,
             ``obs/metrics_update``, ...); feedforward again with
             telemetry on; 8 steps of the resilient path on its 44
             survivors; the shard phase's two rows; for the serve paths
             per prefill and per decode step, for training per step;
 11. summary the ``kernels`` JSON line, the card's name and power limit,
             and last the ``{"ok": true, ...}`` line.

The SNN kernels are held bitwise; flash attention and the SSM scan sum in
another order than their plain versions and are held to a stated
tolerance (``lm_kernel_cases``).

It exits non-zero without a card, and without the rest of the repository.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
SIMT_OPS_PER_S = 67e12          # H100 SXM float32 rate outside tensor cores
BF16_TC_OPS_PER_S = 989e12      # H100 SXM dense bf16 tensor-core rate
# float32-accurate products on tensor cores: 3xTF32, three TF32 products
# (495 T op/s dense) for each.
TF32X3_OPS_PER_S = 495e12 / 3
REPLACES = {
    "fused_inject": "src/repro/kernels/fused_inject/kernel.py:186",
    "fused_lif_inject": "src/repro/kernels/fused_inject/kernel.py:277",
    "bucket_pack": "src/repro/kernels/bucket_pack/kernel.py:84",
    "fused_drain": "src/repro/kernels/fused_drain/kernel.py:145",
    "lif_step": "src/repro/kernels/lif_step/kernel.py:45",
    "merge_sort_words": "src/repro/kernels/merge_sort/kernel.py:84",
    "merge_sort": "src/repro/kernels/merge_sort/kernel.py:132",
    "flash_attention": "src/repro/kernels/flash_attention/kernel.py:104",
    "ssm_scan": "src/repro/kernels/ssm_scan/kernel.py:61",
    # No TPU kernel: the reference's flash backward is XLA code
    # (_chunked_attention_bwd, under the custom_vjp _flash_vjp).
    "flash_attention_bwd": "src/repro/models/attention.py:180",
    # No TPU kernel: the reference trains through XLA's autodiff of the
    # lax.scan in scan_chunked.
    "ssm_scan_bwd": "none: XLA autodiff of src/repro/models/ssm.py:196 "
                    "(scan_chunked)",
    # The same, through the reference's broadcast of the per-head dt_h
    # and a_h (_dt_bc, src/repro/models/ssm.py:84).
    "ssm_scan_heads_bwd": "none: XLA autodiff of src/repro/models/ssm.py:"
                          "196 (scan_chunked) through _dt_bc's broadcasts",
    # No TPU kernel: the reference's chunk-parallel SSD forward is XLA
    # code (three einsums a chunk under lax.scan).
    "ssd_chunked": "none: XLA src/repro/models/ssm.py:118 (ssd_chunked)",
}
# zamba2's long-context serving path: the sliding window, the prompt of
# prefill_32k at batch 1, the decode steps, the chunk of the reference's
# tuned "ssd" setting (src/repro/launch/dryrun.py:389), and the largest
# share of the unwindowed causal flash time that the windowed call may
# take at [1, 32, 32768, 80] (its live pairs are 0.23 of the causal ones).
LONG_WINDOW = 4096
LONG_PROMPT = 32768
LONG_GEN = 32
SSD_CHUNK = 256
WINDOW_SHARE = 0.4
# The ssd_chunked launcher's three kernels.
SSD_KERNELS = ("ssd_state_kernel", "ssd_pass_kernel", "ssd_scan_kernel")
# The general-A scan backward's kernels (csrc/ssm_scan_bwd.cu): the chunk
# form's carry and chunk kernels (N <= 64) and the walk form's (N > 64),
# and the instances of each (x's type x the lanes for N).
SCAN_BWD_KERNELS = {"ssm_scan_bwd_carry_kernel": 5,
                    "ssm_scan_bwd_chunk_kernel": 10,
                    "ssm_scan_bwd_kernel": 6}
# The per-head scan backward's kernels (csrc/ssm_scan_bwd_chunked.cu):
# the backward, templated on x's type (2 instances), and the end-state
# kernel that runs first.
SCAN_HEADS_KERNELS = ("ssm_scan_heads_bwd_kernel",
                      "ssm_scan_heads_dstate_kernel")
SCAN_HEADS_INSTANCES = 3
# The two kernels one flash_attention_bwd call launches (name prefixes,
# of either route), and the instances of each route
# (``design(dtype, backward=True)``).
FLASH_BWD_KERNELS = ("flash_attention_bwd_dq", "flash_attention_bwd_dkdv")
FLASH_BWD_ROUTES = {
    "mma_bf16": ("flash_attention_bwd_dq_mma_kernel",
                 "flash_attention_bwd_dkdv_mma_kernel"),
    "mma_tf32x3": ("flash_attention_bwd_dq_tf32x3_kernel",
                   "flash_attention_bwd_dkdv_tf32x3_kernel")}
# Head sizes the flash kernels are instantiated for (D rounds up to one).
FLASH_DNS = (16, 32, 64, 80, 96, 128, 192, 256)
# The flash cases whose rows the summary keeps by label: a model's own
# shapes beside the main case.
KEYED = ("whisper", "llama3", "yi-9b", "mistral", "chameleon", "llama4")
PLAIN_CHECK_STEPS = 16
# Paths driven by one run call (deposits counted from the ring's pops),
# each also held against its first steps on the CPU.
WHOLE_RUNS = ("plastic", "dense", "pipelined", "flow", "routed", "degraded")
# The degraded path's failures: two dead chips and one cut link.
DEAD_CHIPS = (7, 30)
CUT_LINKS = ((12, 2),)


def tree_clone(x):
    if isinstance(x, torch.Tensor):
        return x.clone()
    if hasattr(x, "_fields"):
        return type(x)(*(tree_clone(v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(tree_clone(v) for v in x)
    return x


def leaves(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in leaves(v)]
    return []


def nbytes(*xs) -> int:
    return sum(t.numel() * t.element_size() for x in xs for t in leaves(x))


def is_mamba1(cfg) -> bool:
    """Whether ``cfg``'s layers hold Mamba-1 blocks (``ssm_version`` is 1
    by default, so a config without SSM layers carries it too)."""
    return bool(cfg.ssm_state) and cfg.ssm_version == 1


def set_general_a(params) -> None:
    """Every Mamba-1 block's A_log, in place, to Mamba-1's published
    initialisation ("S4D real": A[d, n] = -(n + 1), A_log[d, n] = log(n +
    1); state-spaces/mamba, ``mamba_simple.py``), in the leaf's type; then
    fail if any layer's A = -exp(A_log) has a constant row.  The
    reference's init draws A_log zeros, every row of A -1, on which the
    scan kernels take their constant-row route; a trained checkpoint's A
    takes the general route, so the phases that drive falcon-mamba load
    this A (test data, not an init option of the package)."""
    for blk in params["blocks"].values():
        a_log = blk["ssm"]["A_log"]
        n = a_log.shape[-1]
        with torch.no_grad():
            a_log.copy_(torch.log(torch.arange(
                1, n + 1, dtype=torch.float32, device=a_log.device)))
        a = -torch.exp(a_log.float())
        if bool((a == a[..., :1]).all(-1).any()):
            raise AssertionError("set_general_a: a layer's A has a "
                                 "constant row")


@contextlib.contextmanager
def moe_routings(store: list):
    """Record every MoE layer call's integer routing (expert choices,
    slots, counts; on the CPU) and the gap between the k-th and (k+1)-th
    router probability of each token, in call order, while the block
    runs."""
    from repro_torch.models import moe as moem

    orig = moem.moe_apply

    def wrapped(cfg, p, x, *, rules=None, routing=None):
        r = {}
        out = orig(cfg, p, x, rules=rules, routing=r)
        top = torch.sort(r["probs"].detach().float(), dim=-1,
                         descending=True).values
        gap = (top[..., cfg.top_k - 1] - top[..., cfg.top_k]
               if cfg.top_k < cfg.n_experts else torch.ones_like(top[..., 0]))
        store.append(dict(expert_idx=r["expert_idx"].cpu(),
                          slot=r["slot"].cpu(), counts=r["counts"].cpu(),
                          gap=gap.cpu()))
        if routing is not None:
            routing.update(r)
        return out

    moem.moe_apply = wrapped
    try:
        yield
    finally:
        moem.moe_apply = orig


def routing_check(label: str, got: list, want: list) -> float:
    """The card's MoE routing against the CPU's, call by call, bitwise
    (expert choices, then slots, then counts), before any float is
    compared; prints the smallest gap between the k-th and (k+1)-th
    router probability over every token and layer of the CPU run, and
    raises on the first call that differs, with the gaps of the tokens
    whose choices differ.  Returns the smallest gap."""
    if len(got) != len(want):
        raise AssertionError(f"{label}: {len(got)} MoE calls on the card, "
                             f"{len(want)} on the CPU")
    gap = min(float(w["gap"].min()) for w in want) if want else float("nan")
    print(f"[{label}] MoE routing: {len(want)} layer calls, smallest gap "
          f"between the k-th and (k+1)-th router probability {gap:.3g}")
    for i, (g, w) in enumerate(zip(got, want)):
        for key in ("expert_idx", "slot", "counts"):
            if not torch.equal(g[key], w[key]):
                flips = (g["expert_idx"] != w["expert_idx"]).any(-1)
                raise AssertionError(
                    f"{label}: MoE call {i}: {key} differs from the CPU's "
                    f"({int(flips.sum())} tokens choose other experts; "
                    f"their gaps on the CPU "
                    f"{w['gap'][flips].flatten()[:8].tolist()})")
    return gap


@contextlib.contextmanager
def capture(module, name: str, store: dict, keys=None):
    """Record the arguments of the first calls of ``module.name``: call i
    under ``keys[i]`` (default: the first call under ``name``)."""
    orig = getattr(module, name)
    keys = list(keys or (name,))

    def wrapped(*args, **kwargs):
        if keys:
            store[keys.pop(0)] = (tree_clone(args), {
                k: tree_clone(v) for k, v in kwargs.items()})
        return orig(*args, **kwargs)

    setattr(module, name, wrapped)
    try:
        yield
    finally:
        setattr(module, name, orig)


def compare(name: str, got, want) -> float:
    """Max abs difference over every output; raises unless it is 0 (all
    outputs are integers, held bitwise)."""
    g, w = leaves(got), leaves(want)
    if len(g) != len(w):
        raise AssertionError(f"{name}: {len(g)} outputs vs {len(w)}")
    err = 0.0
    for i, (a, b) in enumerate(zip(g, w)):
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"{name}: output {i} is {a.dtype}"
                                 f"{tuple(a.shape)}, plain {b.dtype}"
                                 f"{tuple(b.shape)}")
        if a.numel():
            err = max(err, float((a.double() - b.double()).abs().max()))
    if err != 0:
        raise AssertionError(f"{name}: differs from the plain version "
                             f"(max abs {err})")
    return err


def compare_close(name: str, got, want, rtol: float, atol: float) -> float:
    """Max abs difference over every output; raises where an element
    exceeds ``atol + rtol * |want|``."""
    g, w = leaves(got), leaves(want)
    if len(g) != len(w):
        raise AssertionError(f"{name}: {len(g)} outputs vs {len(w)}")
    err = 0.0
    for i, (a, b) in enumerate(zip(g, w)):
        if a.shape != b.shape:
            raise AssertionError(f"{name}: output {i} shape {tuple(a.shape)}"
                                 f", plain {tuple(b.shape)}")
        diff = (a.double() - b.double()).abs()
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"{name}: non-finite output {i}")
        err = max(err, float(diff.max()))
        if bool((diff > atol + rtol * b.double().abs()).any()):
            raise AssertionError(f"{name}: output {i} differs from the plain "
                                 f"version beyond rtol {rtol} atol {atol} "
                                 f"(max abs {err})")
    return err


def compare_scaled(name: str, got, want, frac: float) -> float:
    """The largest of max |got - want| / max |want| over the outputs;
    raises where an element is off by more than ``frac`` of its output's
    largest |want| or an output is not finite (outputs of unlike scale,
    each held to a share of its own largest).  A bf16 output may also be
    one bf16 ulp off, 2^-7 |want|: both sides round a float32 value to
    bf16, and float32 values that differ in their last bits may round
    apart."""
    g, w = leaves(got), leaves(want)
    if len(g) != len(w):
        raise AssertionError(f"{name}: {len(g)} outputs vs {len(w)}")
    worst = 0.0
    for i, (a, b) in enumerate(zip(g, w)):
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"{name}: output {i} is {a.dtype}"
                                 f"{tuple(a.shape)}, plain {b.dtype}"
                                 f"{tuple(b.shape)}")
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"{name}: non-finite output {i}")
        if a.numel():
            diff, ref = (a.double() - b.double()).abs(), b.double().abs()
            scale = max(float(ref.max()), 1e-30)
            rel = float(diff.max()) / scale
            worst = max(worst, rel)
            ulp = 2**-7 if b.dtype == torch.bfloat16 else 0.0
            if bool((diff > frac * scale + ulp * ref).any()):
                raise AssertionError(f"{name}: output {i} differs from the "
                                     f"plain version by {rel:.3g} of its "
                                     f"largest, beyond {frac:g}"
                                     + (" and a bf16 ulp" if ulp else ""))
    return worst


def compare_rows(name: str, got, want, rtol: float,
                 frac: float) -> tuple[float, float, float]:
    """Attention held row by row: raises where an element is off by more
    than ``rtol * |want| + frac * rms``, ``rms`` the root mean square of
    its own row of ``want`` over the head dimension, or is not finite.
    Each query row is a softmax of its own: a bf16 kernel's error there
    (P rounded to bf16 before P V) scales with that row's output, which
    is near |v| where the causal mask leaves a few keys and about
    1/sqrt(keys) where the window leaves thousands, so one scale for the
    tensor would be loose on the bulk or tight at the start.  Returns the
    max abs difference, the largest share of its tolerance an element
    used, and the mean |want|."""
    a, b = got.double(), want.double()
    if a.shape != b.shape:
        raise AssertionError(f"{name}: shape {tuple(a.shape)}, plain "
                             f"{tuple(b.shape)}")
    if not bool(torch.isfinite(a).all()):
        raise AssertionError(f"{name}: non-finite output")
    diff, ref = (a - b).abs(), b.abs()
    allowed = rtol * ref + frac * b.pow(2).mean(-1, keepdim=True).sqrt()
    share = float(torch.where(allowed > 0, diff / allowed.clamp_min(1e-300),
                              torch.where(diff > 0, torch.inf, 0.0)).max())
    err = float(diff.max())
    if share > 1.0:
        raise AssertionError(f"{name}: an element differs from the plain "
                             f"version by {share:.3g} of rtol {rtol:g} plus "
                             f"{frac:g} of its row's rms (max abs {err:.3g})")
    return err, share, float(ref.mean())


def event_ms(fn, iters: int) -> float:
    """Per-call time with CUDA events over back-to-back calls."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def library_ms(fn) -> float:
    """A library call's time as :func:`kc.graph_ms` takes it, or with CUDA
    events over eager calls where the call cannot be captured in a
    graph."""
    from repro_torch.kernels import common as kc
    try:
        return kc.graph_ms(fn)
    except RuntimeError as err:
        print(f"[kernel] library call not capturable ({err}); timed eagerly")
        torch.cuda.synchronize()
        return event_ms(fn, 20)


def backward_graph_ms(forward, inputs, grad_out) -> float:
    """The time of the backward of ``forward(*inputs)`` alone, as
    :func:`kc.graph_ms` takes a call: ``torch.autograd.grad`` on one
    retained graph.  The forward runs on the capture stream, so that
    autograd puts its backward there."""
    from repro_torch.kernels import common as kc
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ins = [x.detach().clone().requires_grad_(True) for x in inputs]
        out = forward(*ins)
    return kc.graph_ms(lambda: torch.autograd.grad(out, ins, grad_out,
                                                   retain_graph=True),
                       stream=side)


def device_ms(fn, names, iters: int) -> float | None:
    """Device time per launch of the CUDA kernels whose names contain one
    of ``names`` from torch.profiler; None if none of them has device
    time.  Raises if the profiler recorded no device activity at all in
    :func:`kc.profiled`'s sessions."""
    from repro_torch.kernels import common as kc
    fn()
    torch.cuda.synchronize()

    def window():
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()

    prof, _ = kc.profiled(window, f"device time of {', '.join(names)}")
    total, count = 0.0, 0
    for evt in prof.key_averages():
        if any(name in evt.key for name in names):
            t = getattr(evt, "device_time_total", None)
            if t is None:
                t = getattr(evt, "cuda_time_total", 0.0)
            total += t
            count += evt.count
    return total / count / 1e3 if count and total > 0 else None


def host_us(fn, calls: int = 1000) -> float:
    """Host time per call: a host clock over ``calls`` back-to-back calls,
    then one synchronise (the wrapper's Python and launch cost, where the
    card keeps up)."""
    fn()
    torch.cuda.synchronize()
    t_start = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t_start) / calls * 1e6


def ptxas_instances(log: str, kernel: str) -> dict[str, tuple]:
    """(registers, spill bytes as stores + loads) of each instance of the
    template ``kernel`` in ptxas's report, by its template arguments as
    they stand in the mangled name (e.g. ``fLi8ELi2``: float, 8, 2)."""
    return {key[len(kernel) + 1:-1]: (regs, spill)
            for key, (regs, spill, _) in ptxas_frames(log, (kernel,)).items()
            if key != kernel}


def ptxas_registers(log: str, kernel: str) -> int | None:
    """Registers per thread that ptxas reports for the entry function
    ``kernel`` (matched with the length prefix of its mangled name, so
    ``fused_inject_kernel`` is not ``fused_lif_inject_kernel``)."""
    mangled, hit = f"{len(kernel)}{kernel}E", False
    for line in log.splitlines():
        if "Compiling entry function" in line:
            hit = mangled in line
        m = re.search(r"Used (\d+) registers", line)
        if m and hit:
            return int(m.group(1))
    return None


def mangled_instance(line: str, kernels) -> str | None:
    """``kernel<template arguments>`` (or ``kernel``, not a template) of
    the instance of one of ``kernels`` that a mangled name in ``line``
    names (matched with its length prefix), else None."""
    for name in kernels:
        m = re.search(f"{len(name)}{name}(?:I(\\w+?)EE|E)", line)
        if m:
            return f"{name}<{m.group(1)}>" if m.group(1) else name
    return None


def ptxas_frames(log: str, kernels) -> dict[str, tuple]:
    """(registers, spill bytes as stores + loads, stack frame bytes) of
    each instance of ``kernels`` in ptxas's report, by
    :func:`mangled_instance` (None where ptxas printed no such line)."""
    out, key = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            key = mangled_instance(line, kernels)
            if key is not None:
                out[key] = (None, None, None)
        if key is None:
            continue
        regs, spill, stack = out[key]
        m = re.search(r"Used (\d+) registers", line)
        if m:
            regs = int(m.group(1))
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            stack = int(m.group(1))
            spill = int(m.group(2)) + int(m.group(3))
        out[key] = (regs, spill, stack)
    return out


def sass_instances(sass: str, kernels,
                   pattern: str = "HMMA") -> dict[str, tuple[int, int]]:
    """(instructions that match ``pattern``, atomic or reduction
    instructions) of each instance of ``kernels`` in ``cuobjdump -sass``
    output, by :func:`mangled_instance`."""
    out, key = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            key = mangled_instance(line, kernels)
            if key is not None:
                out[key] = (0, 0)
        elif key is not None:
            n, atom = out[key]
            out[key] = (n + bool(re.search(pattern, line)),
                        atom + bool(re.search(r"\b(ATOM\w*|RED)\b", line)))
    return out


def run_path(net, cfg, params, ext, device, b: int):
    """Drive ``net.run`` block by block on ``ext [T, n_chips, n_in]``;
    returns the record and the ring deposits of the run, counted as
    ring(after) - ring(before) + popped, per block."""
    state = net.init_state(cfg, params, device=device)
    deposits = torch.zeros((), dtype=torch.int64, device=device)
    spikes, volts, stats = [], [], []
    d = cfg.comm.ring_depth
    for t in range(0, ext.shape[0], b):
        before = state.ring.ring.sum(dtype=torch.int64)
        slots = (state.ring.now[:, None] + torch.arange(b, device=device)) % d
        popped = state.ring.ring.gather(
            1, slots[..., None].long().expand(-1, -1, state.ring.n_inputs))
        state, rec = net.run(cfg, params, state, ext[t:t + b], device=device)
        deposits += (state.ring.ring.sum(dtype=torch.int64) - before
                     + popped.sum(dtype=torch.int64))
        spikes.append(rec.spikes)
        volts.append(rec.voltage)
        stats.append(rec.stats)
    rec = net.StepRecord(spikes=torch.cat(spikes), voltage=torch.cat(volts),
                         stats=type(stats[0])(*(torch.cat(x)
                                                for x in zip(*stats))))
    return state, rec, deposits


def check_conservation(label: str, state, rec, deposits, carried=None):
    """Σ sent == deposits + expired + overflow + merge_dropped + stalled +
    lost_to_failure + the merge and send queues' occupancy + the in-flight
    words of a pipeline carry.  ``carried`` is a carry whose block's stats
    are not in ``rec`` yet (a run stopped between two stages): its sent
    and source-side legs are added."""
    s = rec.stats
    total = lambda x: int(x.sum(dtype=torch.int64))  # noqa: E731
    queued = sum(int(q.occupancy().sum()) for q in (state.merge, state.sendq)
                 if q is not None)
    in_flight = 0
    lhs = total(s.sent)
    legs = (total(s.expired) + total(s.overflow) + total(s.merge_dropped)
            + total(s.stalled) + total(s.lost_to_failure))
    if carried is not None:
        in_flight = int(carried.occupancy().sum())
        inj = carried.inject
        lhs += total(inj.sent)
        legs += sum(total(x) for x in (inj.overflow, inj.stalled,
                                       inj.wrap_expired, inj.lost))
    rhs = int(deposits) + legs + queued + in_flight
    print(f"[{label}] conservation: sent {lhs} == deposits {int(deposits)} "
          f"+ expired {total(s.expired)} + overflow {total(s.overflow)} + "
          f"merge_dropped {total(s.merge_dropped)} + stalled "
          f"{total(s.stalled)} + lost {total(s.lost_to_failure)} + queued "
          f"{queued} + in flight {in_flight}"
          f"{'' if carried is None else ' + the carried block legs'} "
          f"= {rhs}")
    if lhs != rhs:
        raise AssertionError(f"{label}: conservation violated")
    if lhs == 0:
        raise AssertionError(f"{label}: no event was sent")


def check_record(label: str, rec, t: int, n_chips: int, n: int):
    for name, x in (("spikes", rec.spikes), ("voltage", rec.voltage)):
        if tuple(x.shape) != (t, n_chips, n):
            raise AssertionError(f"{label}: {name} shape {tuple(x.shape)}")
        if not bool(torch.isfinite(x).all()):
            raise AssertionError(f"{label}: non-finite {name}")


@contextlib.contextmanager
def tally_pops(store: list):
    """Add up the spikes every ring pop of a run returns (the ring's
    deposits are its pops plus what it still holds)."""
    from repro_torch.core import delays as dl

    orig = dl.pop_current

    def wrapped(state):
        state, spikes = orig(state)
        store.append(spikes.sum(dtype=torch.float64))
        return state, spikes

    dl.pop_current = wrapped
    try:
        yield
    finally:
        dl.pop_current = orig


class Paths:
    """The path runs and the first-block kernel inputs of each."""

    def __init__(self, device, seed: int, steps: int):
        from repro_torch import obs
        from repro_torch.configs import bss2
        from repro_torch.core import fabric as fb
        from repro_torch.core import pulse_comm as pc
        from repro_torch.core import routing as rt
        from repro_torch.core import topology as tpo
        from repro_torch.snn import network as net
        from repro_torch.snn import synapse as sy

        self.device, self.seed, self.steps, self.net = device, seed, steps, net
        base = bss2.CONFIG
        self.wafer_cfg = net.NetworkConfig(comm=base.comm,
                                           neuron_model=base.neuron_model)
        ff_comm = dataclasses.replace(
            base.comm, fanout=1, mode="full", buckets_per_chip=2,
            merge_rate=128, superstep=8)
        self.ff_cfg = net.NetworkConfig(comm=ff_comm, neuron_model="lif")
        self.dense_cfg = net.NetworkConfig(comm=base.comm, neuron_model="lif",
                                           comm_mode="dense")
        gen = torch.Generator().manual_seed(seed)
        self.wafer_params = net.init_params(gen, self.wafer_cfg,
                                            device=device)
        c = ff_comm
        table = rt.random_table(gen, c.neurons_per_chip, c.n_chips,
                                min_delay=8, max_delay=16)
        self.ff_params = net.init_params(gen, self.ff_cfg, table=table,
                                         device=device)
        # The wafer's LUT; weights on a 1/64 grid, so the crossbar sums of
        # integer spike counts are exact in any order (card = CPU).
        dense = net.init_params(gen, self.dense_cfg,
                                table=self.wafer_params.table, device=device)
        self.dense_params = dense._replace(crossbar=sy.Crossbar(
            w=torch.round(dense.crossbar.w * 64) / 64))
        rng = np.random.default_rng(seed)
        self.wafer_ext = self._ext(rng, base.comm)
        self.ff_ext = self._ext(rng, ff_comm)
        self.dense_ext = self._ext(rng, base.comm)
        self.pc = pc
        # pipelined: the feedforward path on the pipelined schedule, with
        # delays 16 to 24 > 2B - 1, so it must equal the serial schedule.
        self.pipe_cfg = dataclasses.replace(self.ff_cfg, pipeline=True)
        self.pipe_params = self.ff_params._replace(table=rt.random_table(
            gen, c.neurons_per_chip, c.n_chips, min_delay=16, max_delay=24,
            device=device))
        # flow: the dense path's network (wafer widths and LUT, LIF,
        # weights on the 1/64 grid) on the event path under credits with
        # a send queue, and the same input.
        self.flow_cfg = net.NetworkConfig(
            comm=base.comm, neuron_model="lif", flow=fb.FlowControlConfig(
                capacity=16, drain_rate=8, retransmit_depth=512))
        # routed: the feedforward path through the paper's chip -> FPGA ->
        # switch stack; degraded: through a 2 x 23 torus with two chips
        # dead and one link cut.
        self.routed_cfg = dataclasses.replace(
            self.ff_cfg, topology=tpo.switch_tree(2, 23, link_latency=1,
                                                  trunk_latency=1))
        self.degraded_cfg = dataclasses.replace(
            self.ff_cfg, topology=tpo.torus2d(2, 23, link_latency=1),
            healthy=tuple(i for i in range(c.n_chips)
                          if i not in DEAD_CHIPS), dead_links=CUT_LINKS)
        # resilient: the degraded path's widths and LUT at B 1 through the
        # same torus at full health, with telemetry, under ResilientRunner
        # (chips 7 and 30 die mid-run).
        self.resilient_cfg = dataclasses.replace(
            self.ff_cfg, comm=dataclasses.replace(ff_comm, superstep=1),
            topology=tpo.torus2d(2, 23, link_latency=1),
            telemetry=obs.MetricsConfig(flight_depth=FLIGHT_DEPTH))

    def _ext(self, rng, comm):
        """Background input: each synapse row receives a spike with
        probability 0.02 per step."""
        x = rng.random((self.steps, comm.n_chips, comm.n_inputs_per_chip))
        return torch.as_tensor((x < 0.02).astype(np.float32),
                               device=self.device)

    def runs(self):
        """(label, cfg, params, ext, kernels that must launch, plastic)."""
        return (
            ("wafer", self.wafer_cfg, self.wafer_params, self.wafer_ext,
             ("bucket_pack", "fused_drain"), False),
            ("feedforward", self.ff_cfg, self.ff_params, self.ff_ext,
             ("fused_inject", "fused_drain", "lif_step"), False),
            ("plastic", self.ff_cfg, self.ff_params, self.ff_ext,
             ("fused_inject", "fused_drain", "lif_step"), True),
            ("dense", self.dense_cfg, self.dense_params, self.dense_ext,
             ("lif_step",), False),
            ("pipelined", self.pipe_cfg, self.pipe_params, self.ff_ext,
             ("fused_inject", "fused_drain", "lif_step"), False),
            ("flow", self.flow_cfg, self.dense_params, self.dense_ext,
             ("bucket_pack", "fused_drain", "lif_step"), False),
            ("routed", self.routed_cfg, self.ff_params, self.ff_ext,
             ("fused_inject", "fused_drain", "lif_step"), False),
            ("degraded", self.degraded_cfg, self.ff_params, self.ff_ext,
             ("fused_inject", "fused_drain", "lif_step"), False))

    def drive(self, cfg, params, state, ext, plastic: bool, device=None):
        """One ``run`` or ``run_plastic`` call; returns ``(state, record,
        params)``."""
        device = device or self.device
        if plastic:
            params, state, rec, _ = self.net.run_plastic(
                cfg, params, state, ext, device=device)
            return state, rec, params
        state, rec = self.net.run(cfg, params, state, ext, device=device)
        return state, rec, params

    def first_blocks(self) -> dict:
        """Kernel inputs of each path's first block."""
        from repro_torch.kernels.bucket_pack import ops as bp_ops
        from repro_torch.kernels.fused_drain import ops as fd_ops
        from repro_torch.kernels.fused_inject import ops as fi_ops
        from repro_torch.kernels.lif_step import ops as lif_ops

        out = {}
        for label, cfg, params, ext in (
                ("wafer", self.wafer_cfg, self.wafer_params, self.wafer_ext),
                ("feedforward", self.ff_cfg, self.ff_params, self.ff_ext),
                ("degraded", self.degraded_cfg, self.ff_params,
                 self.ff_ext)):
            store = {}
            with capture(fi_ops, "fused_inject", store), \
                    capture(fd_ops, "fused_drain", store), \
                    capture(bp_ops, "flush_pack", store), \
                    capture(lif_ops, "lif_step", store):
                state = self.net.init_state(cfg, params, device=self.device)
                _, store["record"] = self.net.run(
                    cfg, params, state, ext[:cfg.comm.superstep],
                    device=self.device)
            out[label] = store
        # The pipelined path's first two drains (the prologue, then block
        # 0 drained in stage 2), and the flow path's packs of its first
        # and fourth substeps (the queue's lanes ahead of the fresh ones).
        for label, cfg, params, ext, steps, cap in (
                ("pipelined", self.pipe_cfg, self.pipe_params, self.ff_ext,
                 2 * self.pipe_cfg.comm.superstep,
                 (fd_ops, "fused_drain", ("prologue", "steady"))),
                ("flow", self.flow_cfg, self.dense_params, self.dense_ext, 4,
                 (bp_ops, "flush_pack_column", ("first", "fourth")))):
            store = {}
            with capture(*cap[:2], store, cap[2]):
                state = self.net.init_state(cfg, params, device=self.device)
                self.net.run(cfg, params, state, ext[:steps],
                             device=self.device)
            out[label] = store
        return out


def radix_passes(key: torch.Tensor) -> torch.Tensor:
    """Passes of the SoA radix sort per row of ``key [rows, L]`` (int32):
    ceil(bits / 8) over the key bits that vary within the row."""
    diff = key ^ key[..., :1]
    bits = sum(((diff >> b) & 1).any(-1).long() for b in range(32))
    return (bits + 7) // 8


def sort_ops(lanes: int, passes: torch.Tensor) -> int:
    """Lane visits of the counting sorts: each pass counts and then ranks
    every lane of its row once (``passes`` per row)."""
    return 2 * lanes * int(passes.sum())


def merge_lanes(blocks: dict):
    """The first feedforward block's merge cycle of substep 0: queue +
    delivered lanes + ``rate`` sentinels, and the clock of each row."""
    from repro_torch.core import events as ev

    (ring, delivered, queue, t0), kw = blocks["feedforward"]["fused_drain"]
    pad = ev.sentinel_words((queue.shape[0], kw["rate"]),
                            device=queue.device)
    return torch.cat([queue, delivered[:, 0], pad], dim=-1).contiguous(), t0


def lif_inject_call(paths: Paths, device, mode: str, bpc: int, b: int):
    """``fused_lif_inject``'s arguments at the feedforward cell: the
    network's initial state and its first block's currents (the rings are
    empty in the first block, so each substep's currents are the crossbar
    of the input alone, computed as the network computes them)."""
    from repro_torch.snn import synapse as sy

    cfg, params = paths.ff_cfg, paths.ff_params
    c = cfg.comm
    state = paths.net.init_state(cfg, params, device=device)
    currents = torch.stack([sy.currents(params.crossbar,
                                        paths.ff_ext[k] + 0.0)
                            for k in range(b)])
    kw = dict(event_capacity=c.event_capacity, n_chips=c.n_chips,
              buckets_per_chip=bpc, capacity=c.bucket_capacity, mode=mode,
              time_window=c.time_window)
    return (state.neuron.v, state.neuron.refrac, currents, params.neuron,
            params.table, state.ring.now), kw


def kernel_cases(blocks: dict, paths: Paths, device) -> list[dict]:
    """Every (kernel, mode) case: the call, its plain version, bytes and
    operations."""
    from repro_torch.core import events as ev
    from repro_torch.kernels.bucket_pack import ops as bp_ops
    from repro_torch.kernels.bucket_pack.ref import bucket_pack_ref
    from repro_torch.kernels.fused_drain import ops as fd_ops
    from repro_torch.kernels.fused_drain.ref import fused_drain_ref
    from repro_torch.kernels.fused_inject import ops as fi_ops
    from repro_torch.kernels.fused_inject.ref import (fused_inject_ref,
                                                     fused_lif_inject_ref)
    from repro_torch.kernels.lif_step import ops as lif_ops
    from repro_torch.kernels.lif_step.ref import lif_step_ref
    from repro_torch.kernels.merge_sort import ops as ms_ops
    from repro_torch.kernels.merge_sort.ref import (merge_sort_ref,
                                                   merge_sort_words_ref)

    def fused_plan(plan, n, b):
        # A launch plan gives threads first and shared bytes last.
        return (f"one CTA per (chip, substep), grid ({n}, {b}), {plan[0]} "
                f"threads, {plan[-1]} B shared memory")

    cases = []
    (events, table, t0), kw = blocks["feedforward"]["fused_inject"]
    for mode, bpc in (("full", kw["buckets_per_chip"]), ("simplified", 1)):
        for b in (events.addr.shape[0], 1):
            ev_b = ev.EventBuffer(*(x[:b].contiguous() for x in events))
            kwm = dict(kw, mode=mode, buckets_per_chip=bpc)
            args = (ev_b, table, t0)
            n, lanes = ev_b.addr.shape[1], ev_b.addr.shape[2]
            nb = n * bpc
            slab = (n, nb, b, kw["capacity"])
            cases.append(dict(
                kernel="fused_inject", mode=f"{mode} B{b}",
                main=(mode == "full" and b == events.addr.shape[0]),
                run=lambda a=args, k=kwm: fi_ops.fused_inject(*a, **k),
                plain=lambda a=args, k=kwm: fused_inject_ref(*a, **k),
                inputs=(ev_b, table, t0), ops=ev_b.addr.numel(), host=True,
                sole_kernel="fused_inject_kernel",
                plan=fused_plan(fi_ops.launch_plan(lanes, n, nb,
                                                   kw["capacity"]), n, b),
                floor=(f"write floor: one torch.full of the slab {slab} "
                       f"int32 with -1",
                       lambda sh=slab: torch.full(sh, -1, dtype=torch.int32,
                                                  device=device))))

    c = paths.ff_cfg.comm
    for mode, bpc, b in (("full", c.buckets_per_chip, c.superstep),
                         ("simplified", 1, 1)):
        args, kwm = lif_inject_call(paths, device, mode, bpc, b)
        n, neurons = args[2].shape[1:]
        cases.append(dict(
            kernel="fused_lif_inject", mode=f"{mode} B{b}",
            main=mode == "full",
            run=lambda a=args, k=kwm: fi_ops.fused_lif_inject(*a, **k),
            plain=lambda a=args, k=kwm: fused_lif_inject_ref(*a, **k),
            inputs=args, ops=args[2].numel() * 12, host=True,
            sole_kernel="fused_lif_inject_kernel",
            plan=fused_plan(fi_ops.lif_launch_plan(
                neurons, n, n * bpc, c.bucket_capacity), n, b)))

    # The degraded path's first block with its reach row (lost bitwise),
    # beside the same block with a row of ones and with none (a null
    # pointer: the kernel reads nothing more).
    (events, table, t0), kw = blocks["degraded"]["fused_inject"]
    reach = kw["reach"]
    if reach is None:
        raise AssertionError("degraded: fused_inject ran without a reach row")

    def lost_check(got):
        if int(got.lost.sum()) == 0:
            raise AssertionError("fused_inject reach row: nothing culled")

    b, n, lanes = events.addr.shape
    nb = n * kw["buckets_per_chip"]
    for label, row in (("reach row", reach),
                       ("row of ones", torch.ones_like(reach)),
                       ("no reach row", None)):
        kwm = dict(kw, reach=row)
        cases.append(dict(
            kernel="fused_inject", mode=f"degraded full B{b} {label}",
            main=False,
            run=lambda a=(events, table, t0), k=kwm: fi_ops.fused_inject(
                *a, **k),
            plain=lambda a=(events, table, t0), k=kwm: fused_inject_ref(
                *a, **k),
            check=lost_check if label == "reach row" else None,
            inputs=(events, table, t0, row), ops=events.addr.numel(),
            host=True, sole_kernel="fused_inject_kernel",
            plan=fused_plan(fi_ops.launch_plan(lanes, n, nb, kw["capacity"],
                                               row is not None), n, b)))
    args, kwm = lif_inject_call(paths, device, c.mode, c.buckets_per_chip,
                                c.superstep)
    kwm = dict(kwm, reach=reach)
    n, neurons = args[2].shape[1:]
    cases.append(dict(
        kernel="fused_lif_inject", mode=f"full B{c.superstep} reach row",
        main=False,
        run=lambda a=args, k=kwm: fi_ops.fused_lif_inject(*a, **k),
        plain=lambda a=args, k=kwm: fused_lif_inject_ref(*a, **k),
        check=lambda got: lost_check(got.inject),
        inputs=args + (reach,), ops=args[2].numel() * 12, host=True,
        sole_kernel="fused_lif_inject_kernel",
        plan=fused_plan(fi_ops.lif_launch_plan(
            neurons, n, n * c.buckets_per_chip, c.bucket_capacity, True),
            n, c.superstep)))

    args, _ = blocks["feedforward"]["lif_step"]
    n = args[0].numel()
    cases.append(dict(
        kernel="lif_step", mode=f"{tuple(args[0].shape)}", main=True,
        run=lambda a=args: lif_ops.lif_step(*a),
        plain=lambda a=args: lif_step_ref(*a), inputs=args,
        ops=n * 12, host=True, sole_kernel="lif_step_kernel",
        plan=f"one neuron per thread, {-(-n // 256)} CTAs of 256 threads",
        floor=(f"launch floor: one torch.add over {tuple(args[0].shape)} "
               f"float32", lambda x=args[0], y=args[2]: torch.add(x, y))))

    words, now = merge_lanes(blocks)
    rows, lanes = words.shape
    key = ev.word_sort_key(words, now[:, None])

    def words_library(w=words, k=key):
        return w.gather(-1, torch.sort(k, dim=-1, stable=True).indices)

    cases.append(dict(
        kernel="merge_sort_words", mode=f"{rows} x {lanes}", main=True,
        run=lambda: ms_ops.merge_sort_words(words, now),
        plain=lambda: merge_sort_words_ref(words, now),
        library=words_library, inputs=(words, now),
        ops=sort_ops(lanes, torch.ones(rows))))

    # The path's lanes, then deadlines over the whole int32 range (4 radix
    # passes, the worst case).
    gen = torch.Generator(device=device).manual_seed(paths.seed)
    full = (torch.randint(0, 1 << 14, (rows, lanes), generator=gen,
                          device=device, dtype=torch.int32),
            torch.randint(-2**31, 2**31, (rows, lanes), generator=gen,
                          device=device, dtype=torch.int64).to(torch.int32),
            torch.rand((rows, lanes), generator=gen, device=device) < 0.6)
    for label, soa, main in (
            ("", (ev.word_addr(words), ev.word_deadline(words, now[:, None]),
                  ev.word_valid(words)), True),
            (" full-range", full, False)):
        soa_key = torch.where(soa[2], soa[1], 2**30)

        def soa_library(a=soa, k=soa_key):
            order = torch.sort(k, dim=-1, stable=True).indices
            return tuple(x.gather(-1, order) for x in a)

        passes = radix_passes(soa_key)
        cases.append(dict(
            kernel="merge_sort",
            mode=f"{rows} x {lanes}{label}, {int(passes.max())} passes",
            main=main, run=lambda a=soa: ms_ops.merge_sort(*a),
            plain=lambda a=soa: merge_sort_ref(*a), library=soa_library,
            inputs=soa, ops=sort_ops(lanes, passes)))

    (bid, addr, dead, valid), kw = blocks["wafer"]["flush_pack"]
    args = (bid, addr, dead, valid)
    bp_rows, bp_lanes = bid.shape[0] * bid.shape[1], bid.shape[-1]

    def bp_plain(a=args, k=kw):
        rows, counts, overflow = bucket_pack_ref(
            a[0].to(torch.int32), ev.encode_word(*a[1:]), **k)
        return rows.permute(1, 2, 0, 3).contiguous(), counts, overflow

    threads, smem = bp_ops.launch_plan(bp_lanes, kw["n_buckets"],
                                       kw["capacity"])
    cases.append(dict(
        kernel="bucket_pack", mode=f"flush B{bid.shape[0]}", main=True,
        run=lambda a=args, k=kw: bp_ops.flush_pack(*a, **k), plain=bp_plain,
        inputs=args, ops=bid.numel(), host=True,
        sole_kernel="bucket_pack_kernel",
        plan=(f"one CTA per row, {bp_rows} CTAs of {threads} threads, "
              f"{smem} B shared memory")))

    def drain_cases(label, ring, delivered, queue, t0, kw, modes):
        n, b_full = delivered.shape[:2]
        gates = (None, torch.arange(n, device=device) % 2 == 0)
        for mode in modes:
            for b in sorted({b_full, 1}, reverse=True):
                for gate in gates:
                    d = delivered[:, :b].contiguous()
                    q = queue if mode == "rate" else None
                    kwm = dict(kw, mode=mode, gate=gate)
                    if mode != "rate":
                        kwm["rate"] = 0
                    args = (ring, d, q, t0)
                    # One count and one rank visit per merged lane, one
                    # deposit per emitted word, per chip and substep: the
                    # work whatever sorts it.
                    merged = fd_ops.sort_length(
                        mode, d.shape[-1], 0 if q is None else q.shape[-1])
                    emitted = kwm["rate"] if mode == "rate" else d.shape[-1]
                    ops = n * b * (2 * merged + emitted)
                    cases.append(dict(
                        kernel="fused_drain",
                        mode=(f"{label} {mode} B{b} gate "
                              f"{'on' if gate is None else 'mixed'}"),
                        main=(label == "feedforward" and mode == "rate"
                              and b == b_full and gate is None),
                        run=lambda a=args, k=kwm: fd_ops.fused_drain(*a, **k),
                        plain=lambda a=args, k=kwm: fused_drain_ref(*a, **k),
                        inputs=(ring.ring, d, q, t0), ops=ops))

    (ring, delivered, queue, t0), kw = blocks["wafer"]["fused_drain"]
    drain_cases("wafer", ring, delivered, queue, t0, kw, ("passthrough",))
    (ring, delivered, queue, t0), kw = blocks["feedforward"]["fused_drain"]
    drain_cases("feedforward", ring, delivered, queue, t0, kw,
                ("rate", "sort", "passthrough"))

    # The pipelined schedule's drains: block 0 drained in stage 2 (deposit
    # guard widened by B, gate all on), and the prologue (gate all off).
    def prologue_check(got, q, r):
        if (bool((got.words >= 0).any()) or int(got.dep_expired.sum())
                or not torch.equal(got.queue, q)
                or not torch.equal(got.ring.ring, r.ring)):
            raise AssertionError("fused_drain prologue: the closed gate let "
                                 "words, expiries or queue changes through")

    for key, gate_open in (("steady", True), ("prologue", False)):
        (ring, delivered, queue, t0), kw = blocks["pipelined"][key]
        n, b = delivered.shape[:2]
        if (kw["extra_ahead"] != b or kw["mode"] != "rate"
                or not bool((kw["gate"] == gate_open).all())):
            raise AssertionError(f"pipelined {key} drain captured with "
                                 f"{kw}")
        args = (ring, delivered, queue, t0)
        merged = fd_ops.sort_length("rate", delivered.shape[-1],
                                    queue.shape[-1])
        cases.append(dict(
            kernel="fused_drain",
            mode=(f"pipelined rate B{b} extra_ahead {b} gate all "
                  f"{'on' if gate_open else 'off'}"), main=False,
            run=lambda a=args, k=kw: fd_ops.fused_drain(*a, **k),
            plain=lambda a=args, k=kw: fused_drain_ref(*a, **k),
            check=(None if gate_open else
                   lambda got, q=queue, r=ring: prologue_check(got, q, r)),
            inputs=(ring.ring, delivered, queue, t0),
            ops=n * b * (2 * merged + kw["rate"])))

    # The credit-gated inject's pack of one substep into column k of the
    # block's slab, in place: the send queue's lanes ahead of the fresh.
    depth = paths.flow_cfg.flow.retransmit_depth
    for key in ("first", "fourth"):
        (bid, addr, dead, valid), kw = blocks["flow"][key]
        args = (bid, addr, dead, valid)
        slab0, k, cap = kw["slab"], kw["substep"], kw["capacity"]
        target = slab0.clone()

        def column_run(a=args, s=target, k=k, cap=cap):
            counts, overflow = bp_ops.flush_pack_column(
                *a, slab=s, substep=k, capacity=cap)
            return s, counts, overflow

        def column_plain(a=args, s0=slab0, k=k, cap=cap):
            rows, counts, overflow = bucket_pack_ref(
                a[0].to(torch.int32), ev.encode_word(*a[1:]),
                n_buckets=s0.shape[1], capacity=cap)
            s = s0.clone()
            s[:, :, k] = rows
            return s, counts, overflow

        n, lanes = bid.shape
        queued = int(valid[:, :depth].sum())
        threads, smem = bp_ops.launch_plan(lanes, slab0.shape[1], cap)
        cases.append(dict(
            kernel="bucket_pack",
            mode=(f"flow column, {key} substep, {n} x {lanes} lanes "
                  f"({depth} queue lanes, {queued} valid)"), main=False,
            run=column_run, plain=column_plain, inputs=args + (slab0,),
            ops=bid.numel(), host=True, sole_kernel="bucket_pack_kernel",
            plan=(f"one CTA per row, {n} CTAs of {threads} threads, {smem} "
                  f"B shared memory, into column {k} of the slab")))
    return cases


def kernel_phase(cases: list[dict]) -> dict:
    """Compare, then time; returns the main case of each kernel.  A case
    with ``tol = (rtol, atol)`` is held to that tolerance against its
    ``want`` (default: its plain version), else bitwise."""
    from repro_torch.kernels import common as kc

    build = kc.build_dir()
    main = {}
    for case in cases:
        label = f"{case['kernel']} [{case['mode']}]"
        got = case["run"]()
        want = case.get("want", case["plain"])()
        torch.cuda.synchronize()
        tol, frac = case.get("tol"), case.get("tol_of_max")
        rows_tol, share = case.get("tol_rows"), None
        if rows_tol is not None:
            err, share, want_mean = compare_rows(label, got, want, *rows_tol)
        else:
            err = (compare_scaled(label, got, want, frac)
                   if frac is not None
                   else compare(label, got, want) if tol is None
                   else compare_close(label, got, want, *tol))
        if case.get("check") is not None:
            case["check"](got)
        del want
        moved = nbytes(case["inputs"]) + nbytes(got)
        bytes_ms = moved / HBM_BYTES_PER_S * 1e3
        ops_ms = case["ops"] / case.get("ops_per_s", SIMT_OPS_PER_S) * 1e3
        library = case.get("library")
        if library is not None:
            lib_tol = case.get("library_tol")
            if lib_tol is None:
                compare(f"{label} library", got, library())
            else:
                compare_close(f"{label} library", got, library(), *lib_tol)
        del got
        dms = device_ms(case["run"], case.get(
            "device_names", (f"{case['kernel']}_kernel",)), 20)
        if dms is not None:   # the mean per kernel, times kernels per call
            dms *= len(case.get("split_names", (None,)))
        row = dict(name=case["kernel"], mode=case["mode"], max_abs_err=err,
                   pairs=case.get("pairs"),
                   ms=kc.graph_ms(case["run"]), device_ms=dms,
                   plain_ms=event_ms(case["plain"], case.get("plain_iters",
                                                             5)),
                   bytes=moved, ops=case["ops"],
                   bound_ms=max(bytes_ms, ops_ms),
                   bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                   library_ms=(case["library_time"]()
                               if case.get("library_time")
                               else None if library is None
                               else library_ms(library)))
        if share is not None:
            row.update(tol_share=share, want_mean_abs=want_mean)
        if case.get("library_small") is not None:
            row["library_small"] = case["library_small"]()
            print(f"[kernel] {case['kernel']:16s} {case['mode']:40s} "
                  f"SDPA with the mask at {row['library_small']['shape']}: "
                  f"ms={row['library_small']['library_ms']:.5f}, the kernel "
                  f"there ms={row['library_small']['kernel_ms']:.5f}")
        for name in case.get("split_names", ()):
            split = device_ms(case["run"], (name,), 20)
            row.setdefault("split_ms", {})[name] = split
            print(f"[kernel] {case['kernel']:16s} {case['mode']:40s} "
                  f"{name}: device_ms="
                  f"{'not measured' if split is None else f'{split:.5f}'}")
        dms, lms = row["device_ms"], row["library_ms"]
        check = (f"within rtol {rows_tol[0]:g} and {rows_tol[1]:g} of its "
                 f"row's rms (max abs {err:.3g}, {share:.3g} of the "
                 f"tolerance at most; mean |want| {want_mean:.3g})"
                 if rows_tol is not None else
                 f"within {frac:g} of each output's largest (worst "
                 f"{err:.3g})" if frac is not None else
                 "bitwise ok" if tol is None else
                 f"within rtol {tol[0]:g} atol {tol[1]:g} (max abs "
                 f"{err:.3g})")
        print(f"[kernel] {case['kernel']:16s} {case['mode']:40s} "
              f"{check}  ms={row['ms']:.5f} device_ms="
              f"{'not measured' if dms is None else f'{dms:.5f}'} "
              f"plain_ms={row['plain_ms']:.4f} bytes={moved} "
              f"ops={case['ops']} bound_ms={row['bound_ms']:.5f} "
              f"({row['bound_by']})"
              + ("" if lms is None else f" library_ms={lms:.5f}"))
        if "sole_kernel" in case:
            _, names = kc.card_kernels(
                case["run"], expect=re.escape(case["sole_kernel"]))
            if len(names) != 1 or case["sole_kernel"] not in names[0]:
                raise AssertionError(f"{label}: one call put {names} on the "
                                     f"card, not one {case['sole_kernel']}")
            src = kc.KERNELS[case["kernel"]]
            regs = ptxas_registers((build / f"{src}.log").read_text(),
                                   case["sole_kernel"])
            print(f"[kernel] {case['kernel']:16s} {case['mode']:40s} "
                  f"plan: {case['plan']}; ptxas {regs} registers; one "
                  f"kernel per call ({case['sole_kernel']})")
        if case.get("host"):
            row["host_us"] = host_us(case["run"])
            print(f"[kernel] {case['kernel']:16s} {case['mode']:40s} "
                  f"host_us per wrapper call={row['host_us']:.2f} "
                  f"(1000 calls, one synchronise)")
        if "floor" in case:
            label, floor = case["floor"]
            row["floor_ms"] = kc.graph_ms(floor)
            row["floor_host_us"] = host_us(floor)
            print(f"[kernel] {label} ms={row['floor_ms']:.5f} host_us="
                  f"{row['floor_host_us']:.2f} (beside {case['kernel']} "
                  f"{case['mode']} ms={row['ms']:.5f})")
        if case.get("time_over_bound"):
            print(f"[kernel] {case['kernel']:16s} {case['mode']:40s} "
                  f"ms / bound {row['ms'] / row['bound_ms']:.3f} (bound "
                  f"{row['bound_ms']:.5f} by {row['bound_by']})")
        if case.get("both_bounds"):
            print(f"[kernel] {case['kernel']:16s} {case['mode']:40s} "
                  f"bound by operations {ops_ms:.5f} ms, by bytes "
                  f"{bytes_ms:.5f} ms; ms / bound "
                  f"{row['ms'] / row['bound_ms']:.2f}")
        if "design" in case:
            print(f"[kernel] {case['kernel']:16s} {case['mode']:40s} "
                  f"design={case['design']} TFLOP/s="
                  f"{case['ops'] / row['ms'] / 1e9:.1f} share_of_bound="
                  f"{row['bound_ms'] / row['ms']:.3f}"
                  + ("" if lms is None else
                     f" ms/library_ms={row['ms'] / lms:.3f}"))
        if "exps" in case:
            row["exp_floor_ms"], how = exp_floor_ms(case["exps"])
            binds = ("exp" if row["exp_floor_ms"] > row["bound_ms"]
                     else row["bound_by"])
            print(f"[kernel] {case['kernel']:16s} {case['mode']:40s} "
                  f"exp floor {row['exp_floor_ms']:.5f} ms ({how}) beside "
                  f"the bound by bytes {bytes_ms:.5f} and by operations "
                  f"{ops_ms:.5f}; the larger binds: {binds}; ms / exp "
                  f"floor {row['ms'] / row['exp_floor_ms']:.2f}")
        if case["main"]:
            main[case["kernel"]] = row
        if case.get("key"):
            main[case["key"]] = row
        torch.cuda.empty_cache()
    return main


FLASH_INSTANCES = {"bf16": "flash_attention_wgmma_kernel",
                   "f32": "flash_attention_tf32x3_kernel"}


def instance_key(line: str, kernels) -> tuple[str, str] | None:
    """(kernel name, DN as a string) of the instance ``kernel<DN>`` of one
    of ``kernels`` that a mangled name in ``line`` names (matched with the
    length prefix of the mangled name), else None."""
    for name in kernels:
        m = re.search(f"{len(name)}{name}ILi(\\d+)EE", line)
        if m:
            return name, m.group(1)
    return None


def ptxas_by_dn(log: str, kernels) -> dict[str, dict[str, tuple]]:
    """(registers, spill bytes as stores + loads) of each instance of
    ``kernels`` in ptxas's report, by kernel name and DN as
    :func:`instance_key` gives them (None where ptxas printed no such
    line)."""
    out = {name: {} for name in kernels}
    key = None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            key = instance_key(line, kernels)
            if key is not None:
                out[key[0]][key[1]] = (None, None)
        if key is None:
            continue
        regs, spill = out[key[0]][key[1]]
        m = re.search(r"Used (\d+) registers", line)
        if m:
            regs = int(m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = int(m.group(1)) + int(m.group(2))
        out[key[0]][key[1]] = (regs, spill)
    return out


def causal_pairs(sq: int, skv: int, q_offset: int,
                 causal: bool = True) -> int:
    """(query, key) pairs the causal mask lets through, per head (all
    sq x skv without the mask)."""
    if not causal:
        return sq * skv
    return sum(min(skv, max(0, q_offset + r + 1)) for r in range(sq))


def flash_calls(cfg) -> int:
    """flash_attention launches of one forward of ``cfg``'s model, and
    flash_attention_bwd launches of its backward: one an attention layer;
    for an encoder-decoder (whisper), one an encoder layer and two a
    decoder layer (its causal self-attention and its cross-attention)."""
    if cfg.is_encdec:
        return cfg.encoder_layers + 2 * cfg.n_layers
    return cfg.attn_layers


def lm_kernel_cases(device, seed: int) -> list[dict]:
    """flash_attention at the zamba2, internlm2 and granite-moe prefill
    shapes (bf16; granite's head size 64),
    in f32, on a ragged length and after a cached prefix, and at
    whisper-medium's shapes without the causal mask (bf16, 16 heads of
    64: the encoder over 1500 frames, the cross-attention of 8 and of 448
    decoder rows over them; operations 4 D a pair and head with no causal
    halving, SDPA with ``is_causal=False``); ssm_scan at the
    zamba2 prefill shape, on inputs made as the serve path makes them (x
    bf16, dt per head from softplus, A per head of 80 channels: one exp
    per channel and step; the main case), with f32 x and a general
    random A (an exp per state element) and with the state checkpoints;
    then the scan's training path (:func:`scan_train_cases`).

    Tolerances: a bf16 output against the plain version in f32 on the
    same bf16 inputs within 2^-8 |want| + 2^-8 max|v| (half a bf16 ulp
    of the output, plus the kernel's rounding of P to bf16 before PV, at
    most 2^-9 max|v|, doubled as l sums the unrounded p); f32 outputs
    within 5e-5 (sums over up to 2048 keys in another order); the scan's
    y and final state within 1e-4 relative and absolute (the card's expf,
    64-term sums in another order, over 2048 steps).  The library call
    (``scaled_dot_product_attention``, causal from the top left, so only
    where q_offset is 0) is held to 2e-2 against the kernel."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.ssm_scan import ops as scan_ops
    from repro_torch.kernels.ssm_scan.ref import (ssm_scan_ref,
                                                  ssm_scan_with_states_ref)

    gen = torch.Generator(device=device).manual_seed(seed)
    randn = lambda *shape: torch.randn(shape, generator=gen,  # noqa: E731
                                       device=device)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    cases = []
    bf16_t = torch.bfloat16
    for label, b, hq, hkv, sq, skv, d, dtype, q_offset, main, causal in (
            ("zamba2 prefill bf16", 4, 32, 32, 2048, 2048, 80, bf16_t, 0,
             True, True),
            ("internlm2 prefill bf16", 4, 16, 8, 2048, 2048, 128, bf16_t, 0,
             False, True),
            ("granite prefill bf16", 4, 16, 8, 2048, 2048, 64, bf16_t, 0,
             False, True),
            # The dense archs' prefills, 128-wide heads: llama3-8b's and
            # mistral-nemo-12b's (GQA 4), yi-9b's (GQA 8), chameleon-34b's
            # (64 heads, GQA 8), llama4-maverick's (40 heads, GQA 5).
            ("llama3-8b, mistral-nemo prefill bf16", 4, 32, 8, 2048, 2048,
             128, bf16_t, 0, False, True),
            ("yi-9b prefill bf16", 4, 32, 4, 2048, 2048, 128, bf16_t, 0,
             False, True),
            ("chameleon-34b prefill bf16", 4, 64, 8, 2048, 2048, 128, bf16_t,
             0, False, True),
            ("llama4 prefill bf16", 4, 40, 8, 2048, 2048, 128, bf16_t, 0,
             False, True),
            ("zamba2 f32, batch 1", 1, 32, 32, 2048, 2048, 80, torch.float32,
             0, False, True),
            ("ragged 300 f32", 1, 32, 32, 300, 300, 80, torch.float32, 0,
             False, True),
            ("q_offset 2048 bf16", 4, 32, 32, 64, 2112, 80, bf16_t, 2048,
             False, True),
            # whisper-medium: the encoder's 1500 frames (the last key tile
            # holds 92), the cross-attention of the 8 prompt tokens
            # (serve) and of the 448 target tokens (train), no mask.
            ("whisper encoder bf16", 4, 16, 16, 1500, 1500, 64, bf16_t, 0,
             False, False),
            ("whisper cross, prefill bf16", 4, 16, 16, 8, 1500, 64, bf16_t,
             0, False, False),
            ("whisper cross, train bf16", 4, 16, 16, 448, 1500, 64, bf16_t,
             0, False, False)):
        q = randn(b, hq, sq, d).to(dtype)
        k, v = randn(b, hkv, skv, d).to(dtype), randn(b, hkv, skv, d).to(dtype)
        args, kw = (q, k, v), dict(causal=causal, q_offset=q_offset)
        bf16 = dtype == torch.bfloat16
        library = None
        if q_offset == 0:
            library = (lambda a=args, c=causal: sdpa(*a, is_causal=c,
                                                     enable_gqa=True))
        cases.append(dict(
            kernel="flash_attention", mode=f"{label} {tuple(q.shape)}"
            + ("" if causal else f" Skv {skv}, no mask")
            + ("" if hq == hkv else f" Hkv {hkv}"), main=main,
            key=label if label.startswith(KEYED) else None,
            run=lambda a=args, k_=kw: fa_ops.flash_attention(*a, **k_),
            plain=lambda a=args, k_=kw: attention_ref(*a, **k_),
            want=lambda a=args, k_=kw: attention_ref(
                *(x.float() for x in a), **k_),
            tol=((2**-8, 2**-8 * float(v.float().abs().max())) if bf16
                 else (0.0, 5e-5)),
            library=library, design=fa_ops.design(dtype),
            device_names=tuple(FLASH_INSTANCES.values()),
            library_tol=(0.0, 2e-2 if bf16 else 1e-4), inputs=args,
            ops=4 * d * b * hq * causal_pairs(sq, skv, q_offset, causal),
            ops_per_s=BF16_TC_OPS_PER_S if bf16 else TF32X3_OPS_PER_S))

    cases += flash_train_cases(device, gen)

    b, t, di, n, head = 4, 2048, 5120, 64, 80
    softplus = torch.nn.functional.softplus
    x = randn(b, t, di)
    dt_h = softplus(randn(b, t, di // head) - 1.0)
    a_h = -torch.exp(randn(di // head) * 0.5)
    path = (x.to(torch.bfloat16), dt_h.repeat_interleave(head, dim=-1),
            a_h.repeat_interleave(head)[:, None]
            * torch.ones((1, n), device=device),
            randn(b, t, n), randn(b, t, n), randn(di))
    general = (x, softplus(randn(b, t, di) - 1.0),
               -torch.exp(randn(di, n) * 0.5), randn(b, t, n),
               randn(b, t, n), randn(di))
    # Operations per channel and step: with A per head, dt*A and its exp
    # (2) once, decay*h + u*B (3) and h*C summed (2) per state element, and
    # dt*x and D*x + y (3); with a general A, dt*A and exp per element.
    for label, args, ops, main in (
            ("zamba2 prefill, A per head, x bf16", path,
             b * t * di * (5 * n + 5), True),
            ("zamba2 prefill, general A, x f32", general,
             b * t * di * (7 * n + 3), False)):
        cases.append(dict(
            kernel="ssm_scan", mode=f"{label} {tuple(x.shape)} N {n}",
            main=main, run=lambda a=args: scan_ops.ssm_scan(*a),
            plain=lambda a=args: ssm_scan_ref(*a), tol=(1e-4, 1e-4),
            inputs=args, plain_iters=2, ops=ops,
            design="exp_per_channel_step" if main else "exp_per_state"))
    # The forward as training calls it: with the state checkpoints.
    cases.append(dict(
        kernel="ssm_scan", mode=f"zamba2 prefill, A per head, x bf16, with "
                                f"checkpoints {tuple(x.shape)} N {n}",
        main=False, inputs=path, plain_iters=2, ops=b * t * di * (5 * n + 5),
        run=lambda a=path: scan_ops.ssm_scan_fwd(*a, with_states=True),
        plain=lambda a=path: ssm_scan_with_states_ref(*a), tol=(1e-4, 1e-4),
        design="exp_per_channel_step"))
    del path, general
    # falcon-mamba-7b's prefill, [4, 2048, 8192] N 16, x bf16: the general
    # route (an exp per state element), A Mamba-1's published -(n + 1).
    b, t, di, n = 4, 2048, 8192, 16
    falcon = (randn(b, t, di).to(torch.bfloat16),
              softplus(randn(b, t, di) - 1.0), mamba1_a(di, n, device),
              randn(b, t, n), randn(b, t, n), randn(di))
    cases.append(dict(
        kernel="ssm_scan", mode=f"falcon-mamba prefill, general A, x bf16 "
                                f"{(b, t, di)} N {n}",
        main=False, key="ssm_scan falcon", run=lambda a=falcon:
        scan_ops.ssm_scan(*a), plain=lambda a=falcon: ssm_scan_ref(*a),
        tol=(1e-4, 1e-4), inputs=falcon, plain_iters=2,
        ops=b * t * di * (7 * n + 3), exps=b * t * di * n,
        design="exp_per_state"))
    del falcon
    cases += scan_train_cases(device, gen)
    # Last: the 32k cases' plain versions hold tens of GB for a while.
    cases += long_context_cases(device, gen)
    return cases


def window_pairs(sq: int, skv: int, q_offset: int, causal: bool,
                 window: int) -> int:
    """(query, key) pairs per head that the causal mask (where ``causal``)
    and the sliding window (where ``window`` > 0) let through."""
    pos = q_offset + np.arange(sq, dtype=np.int64)
    hi = np.minimum(pos, skv - 1) if causal else np.full_like(pos, skv - 1)
    lo = np.maximum(pos - window + 1, 0) if window else np.zeros_like(pos)
    return int(np.maximum(hi - lo + 1, 0).sum())


def blocked_attention_ref(q, k, v, *, causal: bool, q_offset: int = 0,
                          window: int = 0, rows: int = 1024):
    """``attention_ref`` on blocks of ``rows`` query rows, each over the
    keys its mask and window can reach (the same function: the plain
    version at shapes whose [Sq, Skv] scores do not fit the card)."""
    from repro_torch.kernels.flash_attention.ref import attention_ref

    sq, skv = q.shape[2], k.shape[2]
    outs = []
    for a in range(0, sq, rows):
        b = min(sq, a + rows)
        lo = max(0, a + q_offset - window + 1) if window else 0
        hi = min(skv, b + q_offset) if causal else skv
        if hi <= lo:   # no row of the block sees a key
            outs.append(torch.zeros_like(q[:, :, a:b]))
            continue
        outs.append(attention_ref(q[:, :, a:b], k[:, :, lo:hi],
                                  v[:, :, lo:hi], causal=causal,
                                  q_offset=a + q_offset - lo, window=window))
    return torch.cat(outs, dim=2)


def window_sdpa(q, k, v, *, causal: bool, q_offset: int, window: int):
    """SDPA with the causal mask and the window as one boolean mask (the
    library's call for a windowed attention; it computes every pair)."""
    from repro_torch.kernels.flash_attention.ref import _mask

    mask = _mask(q.shape[2], k.shape[2], causal, q_offset, q.device, window)
    return torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, enable_gqa=q.shape[1] != k.shape[1])


def ssd_ops(b: int, t: int, nh: int, p: int, n: int, chunk: int) -> int:
    """Operations the chunk-parallel scan needs: per chunk C B^T on the
    causal triangle (shared by the heads), per head and chunk the decay
    times cb, (decay o cb) dtx, exp(cum) C h^T and the state update, and
    x D."""
    l = min(chunk, t)
    nc, tri = -(-t // l), l * (l + 1) // 2
    per_head = tri + 2 * tri * p + 2 * l * n * p + l * p + 2 * l * p * n \
        + 2 * p * n + l * p
    return b * nc * (2 * tri * n + nh * per_head) + 2 * b * t * nh * p


def ssd_exps(b: int, t: int, nh: int, chunk: int) -> int:
    """Exponentials the chunk-parallel scan needs: the decay of every (t,
    s <= t) pair of a chunk, w and exp(cum) per step, per head."""
    l = min(chunk, t)
    return b * -(-t // l) * nh * (l * (l + 1) // 2 + 2 * l)


def long_context_cases(device, gen) -> list[dict]:
    """zamba2's long-context kernels.  flash_attention with the sliding
    window: bf16 and f32 at [1, 32, 32768, 80] (prefill_32k at batch 1,
    window 4096), the same bf16 call without the window (the causal time
    the windowed one is held to a share of), and ragged cases (Sq 777,
    Skv 1000, q_offset 223, window 100, GQA 2, causal and not, both
    types), against the plain version on blocks of query rows
    (:func:`blocked_attention_ref`): bf16 within 2^-8 |want| plus 2^-5 of
    the rms of the element's own row (:func:`compare_rows`; P rounded to
    bf16 leaves about 2^-9 of it per element, and a window one key off
    moves the bulk by some 19 times the tolerance:
    ``tools/window_tolerance.py``), f32 within 5e-5;
    operations 4 D a pair the mask and window let through; SDPA with the
    window as a boolean mask beside it, tried at the full shape and,
    where it does not run there, timed beside the kernel at [1, 32, 8192,
    80] under a key of its own (``library_small``), never as the full
    shape's ``library_ms``.
    ssd_chunked (the main case: x bf16 [1, 32768, 5120], 80 heads of 64, N
    64, chunk 256), in f32 there, at zamba2's serve shape [4, 2048, 5120]
    and ragged (2, 130, 640) with chunk 128 and a nonzero initial state,
    against ``ssd_chunked_ref`` within 2^-7 (bf16: the same roundings of
    the same exact products, a flip of one is a bf16 ulp of a term) or
    1e-4 (f32: 3xTF32 products, cumulative sums in another order, whose
    rounding the decays pass on) of each output's largest, with its
    exponentials' floor beside the bound."""
    from repro_torch.kernels import common as kc
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ssd import ops as ssd_ops_m
    from repro_torch.kernels.ssd.ref import ssd_chunked_ref

    randn = lambda *shape: torch.randn(shape, generator=gen,  # noqa: E731
                                       device=device)
    bf16_t, f32_t = torch.bfloat16, torch.float32
    cases = []
    for label, hq, hkv, sq, skv, dtype, q_offset, causal, window in (
            ("long 32k window bf16", 32, 32, LONG_PROMPT, LONG_PROMPT,
             bf16_t, 0, True, LONG_WINDOW),
            ("long 32k causal bf16", 32, 32, LONG_PROMPT, LONG_PROMPT,
             bf16_t, 0, True, 0),
            ("long 32k window f32", 32, 32, LONG_PROMPT, LONG_PROMPT, f32_t,
             0, True, LONG_WINDOW),
            ("window ragged bf16", 8, 4, 777, 1000, bf16_t, 223, True, 100),
            ("window ragged bf16, no mask", 8, 4, 777, 1000, bf16_t, 223,
             False, 100),
            ("window ragged f32", 8, 4, 777, 1000, f32_t, 223, True, 100),
            ("window ragged f32, no mask", 8, 4, 777, 1000, f32_t, 223, False,
             100)):
        d = 80
        q = randn(1, hq, sq, d).to(dtype)
        k, v = randn(1, hkv, skv, d).to(dtype), randn(1, hkv, skv, d).to(dtype)
        args = (q, k, v)
        kw = dict(causal=causal, q_offset=q_offset, window=window)
        bf16 = dtype == bf16_t
        library, library_time, library_small = None, None, None
        if window:
            library = lambda a=args, k_=kw: window_sdpa(*a, **k_)  # noqa: E731
            why = None
            if sq > 8192:
                try:
                    library()
                    torch.cuda.synchronize()
                except (RuntimeError, torch.cuda.OutOfMemoryError) as err:
                    why = (f"{type(err).__name__}: "
                           f"{(str(err).splitlines() or [''])[0]}")
                torch.cuda.empty_cache()
            if why is not None:
                print(f"[kernel] flash_attention {label}: SDPA with the mask "
                      f"does not run at {tuple(q.shape)} ({why}); it and the "
                      f"kernel are timed at [1, {hq}, 8192, {d}] instead")
                library = None
                library_small = (
                    lambda a=tuple(x[:, :, :8192] for x in args), k_=kw: dict(
                        shape=[1, hq, 8192, d],
                        library_ms=library_ms(lambda: window_sdpa(*a, **k_)),
                        kernel_ms=kc.graph_ms(
                            lambda: fa_ops.flash_attention(*a, **k_))))
            elif sq > 8192 and not bf16:
                # every pair on the library's float32 route: a call takes
                # a good share of a second, so three calls, not a graph
                library_time = (lambda f=library: event_ms(f, 3))
        elif q_offset == 0:
            library = (lambda a=args, c=causal: torch.nn.functional
                       .scaled_dot_product_attention(*a, is_causal=c,
                                                     enable_gqa=True))
        pairs = window_pairs(sq, skv, q_offset, causal, window)
        cases.append(dict(
            kernel="flash_attention", key=label,
            mode=f"{label} {tuple(q.shape)}" + ("" if skv == sq else
                                                f" Skv {skv}")
            + ("" if hq == hkv else f" Hkv {hkv}")
            + (f" q_offset {q_offset}" if q_offset else "")
            + (f" window {window}" if window else "")
            + ("" if causal else ", no mask"), main=False,
            run=lambda a=args, k_=kw: fa_ops.flash_attention(*a, **k_),
            plain=lambda a=args, k_=kw: blocked_attention_ref(*a, **k_),
            want=lambda a=args, k_=kw: blocked_attention_ref(
                *(x.float() for x in a), **k_),
            tol_rows=(2**-8, 2**-5) if bf16 else None,
            tol=None if bf16 else (0.0, 5e-5),
            library=library, library_time=library_time,
            library_small=library_small,
            design=fa_ops.design(dtype), plain_iters=1,
            device_names=tuple(FLASH_INSTANCES.values()),
            library_tol=(0.0, 2e-2 if bf16 else 1e-4), inputs=args,
            ops=4 * d * hq * pairs, pairs=pairs,
            ops_per_s=BF16_TC_OPS_PER_S if bf16 else TF32X3_OPS_PER_S))
    softplus = torch.nn.functional.softplus
    for label, b, t, nh, n, chunk, dtype, with_h0, main in (
            ("long 32k ssd bf16", 1, LONG_PROMPT, 80, 64, SSD_CHUNK, bf16_t,
             False, True),
            ("long 32k ssd f32", 1, LONG_PROMPT, 80, 64, SSD_CHUNK, f32_t,
             False, False),
            ("zamba2 prefill ssd bf16", 4, 2048, 80, 64, SSD_CHUNK, bf16_t,
             False, False),
            ("zamba2 prefill ssd f32", 4, 2048, 80, 64, SSD_CHUNK, f32_t,
             False, False),
            ("ssd ragged bf16", 2, 130, 10, 64, 128, bf16_t, True, False),
            ("ssd ragged f32", 2, 130, 10, 64, 128, f32_t, True, False)):
        di = nh * 64
        args = (randn(b, t, di).to(dtype), softplus(randn(b, t, nh) - 1.0),
                -torch.exp(randn(nh) * 0.5), randn(b, t, n), randn(b, t, n),
                randn(di), randn(b, di, n) if with_h0 else None)
        bf16 = dtype == bf16_t
        cases.append(dict(
            kernel="ssd_chunked", key=label, main=main,
            mode=f"{label} {(b, t, di)} {nh} heads N {n} chunk {chunk}"
            + (", h0" if with_h0 else ""),
            run=lambda a=args, c=chunk: ssd_ops_m.ssd_chunked(*a, chunk=c),
            plain=lambda a=args, c=chunk: ssd_chunked_ref(*a, chunk=c),
            tol_of_max=2**-7 if bf16 else 1e-4, inputs=args, plain_iters=1,
            device_names=SSD_KERNELS, split_names=SSD_KERNELS,
            ops=ssd_ops(b, t, nh, 64, n, chunk),
            exps=ssd_exps(b, t, nh, chunk), both_bounds=True,
            ops_per_s=BF16_TC_OPS_PER_S if bf16 else TF32X3_OPS_PER_S,
            design="mma_bf16" if bf16 else "mma_tf32x3"))
    return cases


def mamba1_a(di: int, n: int, device) -> torch.Tensor:
    """Mamba-1's published A [di, N]: -(n + 1) in every row (no row
    constant, so the scan takes its general route)."""
    return -torch.arange(1, n + 1, dtype=torch.float32,
                         device=device).expand(di, n).contiguous()


def exp_floor_ms(exps: int) -> tuple[float, str]:
    """The least time of ``exps`` exp evaluations on the card's special
    function units: one MUFU.EX2 each, 16 a clock on each SM (Hopper), at
    the card's highest SM clock (``nvidia-smi``'s clocks.max.sm); and how
    it was counted."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True).stdout.split()[0])
    return (exps / (16 * sms * mhz * 1e6) * 1e3,
            f"{exps} exp at 16 a clock on {sms} SMs at {mhz:.0f} MHz")


def scan_train_cases(device, gen) -> list[dict]:
    """The scan on zamba2's training path, [4, 512, 5120] N 64: the
    forward with checkpoints, and ``ssm_scan_bwd`` (the main case: x bf16,
    A per head, no gradient of the final state, as ``ssm_apply`` trains)
    against ``ssm_scan_bwd_ref`` on the same inputs and checkpoints, each
    gradient within 1e-4 of its largest |.| (the card's expf, and sums in
    another order: dB and dC over 5120 channels, dA and dD over 2048
    steps; the forward's bound; the bf16 dx also within one bf16 ulp of
    the element, as both sides round it), two calls the same bits; then a
    general
    A with x f32 and a final-state gradient, and a ragged case (T 130, di
    1000, N 100, A per head at even channels and general at odd ones).

    Operations per state element and step: the backward recomputes h
    (FMUL, FFMA: 3) and updates g (FMUL, FFMA: 3), then q = g h (1), q e
    A and q e dt summed (2 + 2), g B (2), u g (2) and dy h (2): 17; per
    channel and step u, e = exp(dt a0) and its product (3), dx (3), ddt
    (2), dD (2): 10.  A general row takes dt A, its exp and the products
    e A and e dt per element (21 N + 7)."""
    from repro_torch.kernels import common as kc
    from repro_torch.kernels.ssm_scan import ops as scan_ops
    from repro_torch.kernels.ssm_scan.ref import (heads_to_channels,
                                                  ssm_scan_bwd_ref,
                                                  ssm_scan_heads_bwd_ref,
                                                  ssm_scan_with_states_ref)

    randn = lambda *shape: torch.randn(shape, generator=gen,  # noqa: E731
                                       device=device)
    softplus = torch.nn.functional.softplus
    cases = []
    b, t, di, n, head = 4, 512, 5120, 64, 64   # zamba2: 80 heads of 64
    x = randn(b, t, di)
    dt_h = softplus(randn(b, t, di // head) - 1.0)
    a_h = -torch.exp(randn(di // head) * 0.5)
    per_head = (x.to(torch.bfloat16),
                *heads_to_channels(dt_h, a_h, head, n),
                randn(b, t, n), randn(b, t, n), randn(di))
    cases.append(dict(
        kernel="ssm_scan", mode=f"zamba2 training, A per head, x bf16, with "
                                f"checkpoints {tuple(x.shape)} N {n}",
        main=False, inputs=per_head, plain_iters=2,
        ops=b * t * di * (5 * n + 5),
        run=lambda a=per_head: scan_ops.ssm_scan_fwd(*a, with_states=True),
        plain=lambda a=per_head: ssm_scan_with_states_ref(*a),
        tol=(1e-4, 1e-4), design="exp_per_channel_step"))
    general = (x, softplus(randn(b, t, di) - 1.0),
               -torch.exp(randn(di, n) * 0.5), randn(b, t, n),
               randn(b, t, n), randn(di))
    rb, rt, rdi, rn = 1, 130, 1000, 100
    rag_a = torch.where((torch.arange(rdi, device=device) % 2 == 0)[:, None],
                        (-torch.exp(randn(-(-rdi // head)) * 0.5))
                        .repeat_interleave(head)[:rdi, None]
                        * torch.ones((1, rn), device=device),
                        -torch.exp(randn(rdi, rn) * 0.5))
    ragged = (randn(rb, rt, rdi), softplus(randn(rb, rt, rdi) - 1.0), rag_a,
              randn(rb, rt, rn), randn(rb, rt, rn), randn(rdi))

    def bwd_args(fwd_args, dh):
        _, _, hc = scan_ops.ssm_scan_fwd(*fwd_args, with_states=True)
        bb, tt, dd = fwd_args[0].shape
        nn = fwd_args[2].shape[1]
        return fwd_args + (hc, randn(bb, tt, dd),
                           randn(bb, dd, nn) if dh else None)

    def same_bits(got, a, label):
        before = kc.launches["ssm_scan_bwd"]
        again = scan_ops.ssm_scan_bwd(*a)
        launches = kc.launches["ssm_scan_bwd"] - before
        if not all(torch.equal(g, w) for g, w in zip(got, again)):
            raise AssertionError("ssm_scan_bwd: two calls on the same "
                                 "inputs differ")
        n = a[2].shape[1]
        bf16 = a[0].dtype == torch.bfloat16
        _, names = kc.card_kernels(lambda: scan_ops.ssm_scan_bwd(*a),
                                   expect="|".join(SCAN_BWD_KERNELS))
        ours = [m.group(0) for m in (re.search(
            "|".join(SCAN_BWD_KERNELS), nm) for nm in names) if m]
        print(f"[kernel] ssm_scan_bwd     {label}: two calls give the same "
              f"bits; form {scan_ops.bwd_route(n)}, resident warps an SM "
              f"{scan_ops.bwd_resident_warps(n, bf16)}; "
              f"{launches} ssm_scan_bwd launch a call, its kernels on the "
              f"card {ours}")
        if launches != 1 or not ours:
            raise AssertionError(f"ssm_scan_bwd {label}: {launches} "
                                 f"launches a call, kernels {names}")

    # falcon-mamba-7b's training shape, [4, 512, 8192] N 16, x bf16, its
    # published A, no final-state gradient (as ssm_apply trains).
    fb, ft, fdi, fn = 4, 512, 8192, 16
    falcon = (randn(fb, ft, fdi).to(torch.bfloat16),
              softplus(randn(fb, ft, fdi) - 1.0), mamba1_a(fdi, fn, device),
              randn(fb, ft, fn), randn(fb, ft, fn), randn(fdi))
    for label, fwd_args, dh, ops, key in (
            ("falcon-mamba training, general A, x bf16", falcon, False,
             fb * ft * fdi * (21 * fn + 7), None),
            ("zamba2 training, A per head, x bf16", per_head, False,
             b * t * di * (17 * n + 10), "ssm_scan_bwd zamba2"),
            ("zamba2 training, general A, x f32, dh", general, True,
             b * t * di * (21 * n + 7), None),
            ("ragged, mixed A, dh", ragged, True,
             rb * rt * rdi * (21 * rn + 7), None)):
        args = bwd_args(fwd_args, dh)
        shape = tuple(fwd_args[0].shape)
        main = fwd_args is falcon
        nn = fwd_args[2].shape[1]
        split = (("ssm_scan_bwd_carry_kernel", "ssm_scan_bwd_chunk_kernel")
                 if scan_ops.bwd_route(nn) == "chunks" else
                 ("ssm_scan_bwd_kernel",))
        cases.append(dict(
            kernel="ssm_scan_bwd", mode=f"{label} {shape} N {nn}",
            main=main, key=key, run=lambda a=args: scan_ops.ssm_scan_bwd(*a),
            plain=lambda a=args: ssm_scan_bwd_ref(*a), tol_of_max=1e-4,
            inputs=tuple(z for z in args if z is not None), plain_iters=2,
            ops=ops, check=(lambda got, a=args, lb=label: same_bits(got, a,
                                                                     lb)),
            device_names=split, split_names=split, time_over_bound=True,
            design=f"{scan_ops.bwd_route(nn)} form"))
    del falcon

    # The per-head backward (csrc/ssm_scan_bwd_chunked.cu) at the same
    # shape (the main case), ragged with a final-state gradient, and with
    # x f32; its operations are :func:`heads_bwd_ops`.
    group = scan_ops.heads_bwd_group()

    def heads_case(label, xh, dth, ah, rest, dh, main):
        bb, tt, dd = xh.shape
        nh, nn = ah.shape[0], rest[0].shape[-1]
        dt_, a_ = heads_to_channels(dth, ah, dd // nh, nn)
        _, _, hc = scan_ops.ssm_scan_fwd(xh, dt_, a_, *rest, with_states=True)
        args = (xh, dth, ah, *rest, hc, randn(bb, tt, dd),
                randn(bb, dd, nn) if dh else None)
        nc = -(-tt // 64)

        def same(got, a=args):
            again = scan_ops.ssm_scan_heads_bwd(*a)
            if not all(torch.equal(g, w) for g, w in zip(got, again)):
                raise AssertionError("ssm_scan_heads_bwd: two calls on the "
                                     "same inputs differ")
            print("[kernel] ssm_scan_heads_bwd two calls give the same bits")

        return dict(
            kernel="ssm_scan_heads_bwd", mode=f"{label} {(bb, tt, dd)} "
                                              f"{nh} heads N {nn}",
            main=main, run=lambda a=args: scan_ops.ssm_scan_heads_bwd(*a),
            plain=lambda a=args: ssm_scan_heads_bwd_ref(*a), tol_of_max=1e-4,
            inputs=tuple(z for z in args if z is not None), plain_iters=2,
            ops=heads_bwd_ops(bb, tt, nh, dd // nh, nn,
                              xh.dtype == torch.bfloat16, dh),
            ops_per_s=TF32X3_OPS_PER_S, both_bounds=True, check=same,
            device_names=SCAN_HEADS_KERNELS, split_names=SCAN_HEADS_KERNELS,
            design=f"mma_tf32x3 ({group} heads a block)")

    rest = per_head[3:]
    cases.append(heads_case("zamba2 training, x bf16", per_head[0], dt_h,
                            a_h, rest, False, True))
    rb, rt, rh = 2, 200, 10
    cases.append(heads_case(
        "ragged, x bf16, dh", randn(rb, rt, rh * 64).to(torch.bfloat16),
        softplus(randn(rb, rt, rh) - 1.0), -torch.exp(randn(rh) * 0.5),
        (randn(rb, rt, n), randn(rb, rt, n), randn(rh * 64)), True, False))
    cases.append(heads_case("zamba2 training, x f32", x, dt_h, a_h, rest,
                            False, False))
    return cases


def heads_bwd_ops(b: int, t: int, nh: int, p: int, n: int, x_bf16: bool,
                  dh: bool) -> int:
    """Operations the per-head (chunked) backward needs on this data,
    counted as 3xTF32 operations (three TF32 products each) for its rate.
    Per batch row and chunk of q steps, with tri = q (q + 1) / 2 the pairs
    t >= s that the causal mask keeps:
      per head, full, q P N multiply-adds each: dy h0 and dy^T diag(exp
      cum) C (the end-state pass), but not in the first chunk, whose h0
      is 0 and whose start-state gradient no input needs; B G^T and x G,
      but not in the last chunk without a final-state gradient (``dh``),
      whose G is then 0;
      per head, lower triangle: M^T dy and dy x^T (tri P each), dM~ B and
      dM~^T C (tri N each);
      once for all heads: C B^T at its lower triangle (tri N).
    A product that reads a bf16 x (exact in TF32: x G, dy x^T) takes two
    TF32 products, every other three."""
    xw = 2 if x_bf16 else 3
    total = 0
    for c0 in range(0, t, 64):
        q = min(64, t - c0)
        tri = q * (q + 1) // 2
        full = 0
        if c0:
            full += 2 * 3 * q * p * n
        if dh or c0 + q < t:
            full += (3 + xw) * q * p * n
        per_head = full + tri * (3 * p + xw * p + 2 * 3 * n)
        total += nh * per_head + 3 * tri * n
    return 2 * b * total // 3


def bwd_design(route: str, d: int, ptxas: dict) -> str:
    """The backward's route for head size ``d`` with the registers and
    spill bytes of each instance of its two kernels at that DN, from
    ptxas's report."""
    dn = str(next(n for n in FLASH_DNS if d <= n))
    parts = [f"{name.split('_')[3]}<{key}> {regs} registers {spill} spill "
             f"bytes"
             for name in FLASH_BWD_ROUTES[route]
             for key, (regs, spill) in ptxas[name].items() if key == dn]
    return f"{route} ({', '.join(parts)})"


def flash_train_cases(device, gen) -> list[dict]:
    """The training path's attention kernels at its shapes: the forward
    with lse at internlm2's training heads (bf16 [4, 16, 512, 128]), and
    ``flash_attention_bwd`` there (the main case), at zamba2's head size
    (bf16 [4, 32, 512, 80]), at granite-moe's (bf16 [4, 16, 512, 64], GQA
    2), in float32 (the train-check's [2, 16, 64,
    128], [1, 16, 512, 128], zamba2's heads [1, 32, 512, 80], and a
    peaked softmax: [1, 16, 512, 128] with q eight times larger) and
    after 71 cached keys (GQA 4, both types); then at whisper-medium's
    training shapes (bf16 [4, 16, *, 64], MHA): the encoder's 1500 x 1500
    and the cross-attention's 448 x 1500 without the mask, the decoder's
    448 x 448 causal.

    The forward's (out, lse) is held to the bf16 output bound of
    :func:`lm_kernel_cases` and its lse within 1e-4 + 1e-5 |lse| of the
    plain version in f32 (scores summed in another order; MUFU exp2 and
    the rescale from the log2 domain).  The backward is fed the plain
    forward's out and lse and held elementwise within
    ``attention_bwd_bounds`` (bf16: a flip of the output's rounding,
    2^-7 |y|, plus 2^-6 of the root of each element's sum of squared
    terms for flips of p's and ds's roundings, plus 2^-15 of a sum that
    bounds dp - delta; f32: 2^-16 of that sum; the peaked case within
    ``tf32x3_bwd_bounds``, which adds 3xTF32's error of s passed on by
    p); each case prints its largest err / bound.  Bound: 5 products of 2
    D flops per unmasked pair and query head, at 989 TFLOP/s (bf16) or
    165 (f32, 3xTF32; the time at 67 T op/s on CUDA cores printed
    beside); the library time is SDPA's backward alone
    (``torch.autograd.grad`` on a retained graph, in a CUDA graph as the
    kernel's), held within 5% of the largest |gradient| of the
    kernel's."""
    from repro_torch.kernels import common as kc
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import (
        attention_bwd_bounds, attention_bwd_ref, attention_with_lse_ref,
        tf32x3_bwd_bounds)

    randn = lambda *shape: torch.randn(shape, generator=gen,  # noqa: E731
                                       device=device)
    ptxas = ptxas_by_dn((kc.build_dir() / "flash_attention_bwd.log")
                        .read_text(), sum(FLASH_BWD_ROUTES.values(), ()))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    cases = []
    q, k, v = (randn(4, h, 512, 128).to(torch.bfloat16) for h in (16, 8, 8))
    want_lse = attention_with_lse_ref(q.float(), k.float(), v.float())[1]

    def lse_check(got, want=want_lse):
        compare_close("flash_attention lse", got[1], want, 1e-5, 1e-4)

    cases.append(dict(
        kernel="flash_attention", mode=f"internlm2 train bf16 with lse "
        f"{tuple(q.shape)}", main=False,
        run=lambda a=(q, k, v): fa_ops.flash_attention_fwd(*a, with_lse=True),
        plain=lambda a=(q, k, v): attention_with_lse_ref(*a),
        want=lambda a=(q, k, v): attention_with_lse_ref(
            *(x.float() for x in a)),
        tol=(2**-8, 2**-8 * float(v.float().abs().max())), check=lse_check,
        design=fa_ops.design(q.dtype),
        device_names=tuple(FLASH_INSTANCES.values()), inputs=(q, k, v),
        ops=4 * 128 * 4 * 16 * causal_pairs(512, 512, 0),
        ops_per_s=BF16_TC_OPS_PER_S))

    f32 = torch.float32
    rows = [(*row, True) for row in (
            ("internlm2 train bf16", 4, 16, 8, 512, 512, 128,
             torch.bfloat16, 0, True, 1),
            ("zamba2 heads bf16", 4, 32, 32, 512, 512, 80, torch.bfloat16,
             0, False, 1),
            ("granite train bf16", 4, 16, 8, 512, 512, 64, torch.bfloat16,
             0, False, 1),
            ("train-check f32", 2, 16, 8, 64, 64, 128, f32, 0, False, 1),
            ("internlm2 f32, batch 1", 1, 16, 8, 512, 512, 128, f32, 0,
             False, 1),
            ("zamba2 heads f32", 1, 32, 32, 512, 512, 80, f32, 0, False, 1),
            ("q_offset 71, GQA 4 f32", 1, 32, 8, 129, 200, 80, f32, 71,
             False, 1),
            ("peaked f32, q x 8", 1, 16, 8, 512, 512, 128, f32, 0, False,
             8),
            ("q_offset 71, GQA 4 bf16", 1, 32, 8, 129, 200, 80,
             torch.bfloat16, 71, False, 1),
            ("mistral-nemo train bf16", 4, 32, 8, 512, 512, 128,
             torch.bfloat16, 0, False, 1))]
    # whisper-medium's training step, 16 heads of 64: the encoder's
    # self-attention over 1500 frames and the cross-attention of the 448
    # target tokens over them, without the mask; the decoder's causal
    # self-attention.
    rows += [
        ("whisper encoder train bf16", 4, 16, 16, 1500, 1500, 64,
         torch.bfloat16, 0, False, 1, False),
        ("whisper cross train bf16", 4, 16, 16, 448, 1500, 64,
         torch.bfloat16, 0, False, 1, False),
        ("whisper decoder train bf16", 4, 16, 16, 448, 448, 64,
         torch.bfloat16, 0, False, 1, True)]
    for (label, b, hq, hkv, sq, skv, d, dtype, q_offset, main, q_factor,
         causal) in rows:
        q = (randn(b, hq, sq, d) * q_factor).to(dtype)
        k, v = randn(b, hkv, skv, d).to(dtype), randn(b, hkv, skv, d).to(dtype)
        dout = randn(b, hq, sq, d).to(dtype)
        kw = dict(causal=causal, q_offset=q_offset)
        out, lse = attention_with_lse_ref(q, k, v, **kw)
        args = (q, k, v, out, lse, dout)
        bounds = (tf32x3_bwd_bounds if q_factor != 1
                  else attention_bwd_bounds)(*args, **kw)
        bf16 = dtype == torch.bfloat16
        ops = 10 * d * b * hq * causal_pairs(sq, skv, q_offset, causal)

        def check(got, a=args, k_=kw, bd=bounds, lbl=label, bf16=bf16,
                  ops=ops):
            ratios = []
            for name, g, w, bound in zip(("dq", "dk", "dv"), got,
                                         attention_bwd_ref(*a, **k_), bd):
                err = (g.float() - w.float()).abs()
                bad = err > bound
                if bool(bad.any()):
                    raise AssertionError(
                        f"flash_attention_bwd [{lbl}] {name}: "
                        f"{int(bad.sum())} elements beyond "
                        f"attention_bwd_bounds")
                ratios.append(
                    f"{name} {float((err / bound).max()):.3g} (max err "
                    f"{float(err.max() / w.float().abs().max()):.3g}, "
                    f"bound {float(bound.max() / w.float().abs().max()):.3g}"
                    f" of max |{name}|)")
            print(f"[kernel] flash_attention_bwd [{lbl}] max err / bound: "
                  + "; ".join(ratios))
            if not bf16:
                print(f"[kernel] flash_attention_bwd [{lbl}] bound at 67 T "
                      f"op/s on CUDA cores {ops / SIMT_OPS_PER_S * 1e3:.5f} "
                      f"ms (at 3xTF32's 165: "
                      f"{ops / TF32X3_OPS_PER_S * 1e3:.5f})")

        library = library_time = None
        if q_offset == 0:
            lq, lk, lv = (x.detach().clone().requires_grad_(True)
                          for x in (q, k, v))
            lo = sdpa(lq, lk, lv, is_causal=causal, enable_gqa=True)
            library = (lambda o=lo, ins=(lq, lk, lv), g=dout:
                       torch.autograd.grad(o, ins, g, retain_graph=True))
            library_time = (lambda ins=(q, k, v), g=dout, c=causal:
                            backward_graph_ms(
                                lambda x, y, z: sdpa(x, y, z, is_causal=c,
                                                     enable_gqa=True),
                                ins, g))
        cases.append(dict(
            kernel="flash_attention_bwd", mode=f"{label} {tuple(q.shape)}"
            + ("" if causal else f" Skv {skv}, no mask")
            + ("" if hq == hkv else f" Hkv {hkv}"), main=main,
            key=label if label.startswith(KEYED) else None,
            run=lambda a=args, k_=kw: fa_ops.flash_attention_bwd(*a, **k_),
            plain=lambda a=args, k_=kw: attention_bwd_ref(*a, **k_),
            tol=(0.0, max(float(x.max()) for x in bounds)), check=check,
            library=library, library_time=library_time,
            library_tol=(0.0, 0.05 * max(
                float(x.float().abs().max())
                for x in attention_bwd_ref(*args, **kw))),
            design=bwd_design(fa_ops.design(dtype, backward=True), d,
                              ptxas),
            device_names=FLASH_BWD_KERNELS, split_names=FLASH_BWD_KERNELS,
            inputs=args, ops=ops,
            ops_per_s=BF16_TC_OPS_PER_S if bf16 else TF32X3_OPS_PER_S))
    return cases


def entry_phase(blocks: dict, paths: Paths, device) -> dict:
    """The entry points off the network's path, counters zeroed just
    before; returns their launches."""
    from repro_torch.core import events as ev
    from repro_torch.core import merge as mg
    from repro_torch.kernels import common as kc
    from repro_torch.kernels.fused_drain import ops as fd_ops
    from repro_torch.kernels.fused_inject import ops as fi_ops
    from repro_torch.kernels.merge_sort import ops as ms_ops

    (ring, delivered, queue, t0), kw = blocks["feedforward"]["fused_drain"]
    record = blocks["feedforward"]["record"]
    c = paths.ff_cfg.comm
    lif_args, lif_kw = lif_inject_call(paths, device, c.mode,
                                       c.buckets_per_chip, c.superstep)
    torch.cuda.synchronize()
    kc.reset_launches()
    drains = {rate: mg.merge_drain_words(
        mg.MergeBuffer(words=queue), delivered.transpose(0, 1), now0=t0,
        rate=rate, use_pallas=True) for rate in (kw["rate"], 16)}
    merged, now = merge_lanes(blocks)
    soa = (ev.word_addr(merged), ev.word_deadline(merged, now[:, None]),
           ev.word_valid(merged))
    sorted_soa = ms_ops.merge_sort(*soa)
    lif = fi_ops.fused_lif_inject(*lif_args, **lif_kw)
    scan_grads, scan_want = scan_entry(device)
    torch.cuda.synchronize()
    counts = dict(kc.launches)
    compare_scaled("ssm_scan (per-channel A) gradients vs the plain "
                   "backward", scan_grads, scan_want, 1e-4)
    print("[entry] ssm_scan with a general A under grad (SSMScan, the "
          "per-channel backward) within 1e-4 of the plain backward")
    for rate, (buf, words, dropped) in drains.items():
        fused = fd_ops.fused_drain(ring, delivered, queue, t0, mode="rate",
                                   rate=rate)
        compare(f"merge_drain_words(use_pallas=True) vs fused_drain rate "
                f"{rate}", (buf.words, words, dropped),
                (fused.queue, fused.words, fused.dropped))
        print(f"[entry] merge_drain_words(use_pallas=True) equals "
              f"fused_drain rate mode at rate {rate}: "
              f"{int(buf.occupancy().sum())} queued, {int(dropped.sum())} "
              f"dropped")
    key = torch.where(sorted_soa[2], sorted_soa[1], 2**30)
    if not bool((key[..., 1:] >= key[..., :-1]).all()):
        raise AssertionError("merge_sort: rows out of order")
    compare("fused_lif_inject spikes vs the network's first block",
            lif.spikes, record.spikes)
    (events, table, t0_inject), inject_kw = blocks["feedforward"][
        "fused_inject"]
    compare("fused_lif_inject vs fused_inject of the network's first block",
            lif.inject, fi_ops.fused_inject(events, table, t0_inject,
                                            **inject_kw))
    print(f"[entry] merge_sort on {tuple(soa[0].shape)} in order; "
          f"fused_lif_inject's spikes and slab equal the network's first "
          f"block "
          f"({int(lif.spikes.sum())} spikes, {int(lif.inject.sent.sum())} "
          f"sent); launches {counts}")
    for k in ("merge_sort_words", "merge_sort", "fused_lif_inject",
              "ssm_scan_bwd"):
        if counts[k] == 0:
            raise AssertionError(f"entry: kernel {k} never launched")
    return counts


def scan_entry(device, b: int = 2, t: int = 130, di: int = 256,
               n: int = 16):
    """``kernels.ssm_scan.ssm_scan`` under grad with a general [di, N] A
    (Mamba-1's form; the models' Mamba-2 layers take ``ssm_scan_heads``):
    its ``SSMScan`` Function runs the forward with checkpoints and the
    per-channel backward.  Returns the gradients of a random linear loss
    of y and h_final and the plain backward's from the same
    checkpoints."""
    from repro_torch.kernels.ssm_scan import ops as scan_ops
    from repro_torch.kernels.ssm_scan.ref import ssm_scan_bwd_ref

    gen = torch.Generator(device=device).manual_seed(5)
    randn = lambda *s: torch.randn(s, generator=gen,  # noqa: E731
                                   device=device)
    leaves = [randn(b, t, di),
              torch.nn.functional.softplus(randn(b, t, di) - 1.0),
              -torch.exp(randn(di, n) * 0.5), randn(b, t, n),
              randn(b, t, n), randn(di)]
    dy, dh = randn(b, t, di), randn(b, di, n)
    inputs = [z.clone().requires_grad_(True) for z in leaves]
    y, h = scan_ops.ssm_scan(*inputs)
    grads = torch.autograd.grad((y * dy).sum() + (h * dh).sum(), inputs)
    _, _, hc = scan_ops.ssm_scan_fwd(*leaves, with_states=True)
    return grads, ssm_scan_bwd_ref(*leaves, hc, dy, dh)


def path_phase(paths: Paths, device) -> dict:
    """Run every path with the launch counters zeroed just before each;
    returns launches per kernel and path."""
    from repro_torch import demo
    from repro_torch.core import topology as tpo
    from repro_torch.kernels import common as kc

    net = paths.net
    counts = {}
    for label, cfg, params, ext, needs, plastic in paths.runs():
        c = cfg.comm
        if label == "feedforward":
            print("[feedforward] paper demo (2 chips x 64 LIF, fan-out 1):")
            kc.reset_launches()
            src_t, dst_t = demo.main(device)
            demo_counts = dict(kc.launches)
            if (src_t, dst_t) != _demo_on_cpu(demo):
                raise AssertionError("demo spike times differ from the "
                                     "plain run on the CPU")
            print(f"[feedforward] demo spike times equal the plain CPU run; "
                  f"launches {demo_counts}")
        if label in WHOLE_RUNS:
            check_against_cpu(paths, label, cfg, params, ext, plastic)
        torch.cuda.synchronize()
        kc.reset_launches()
        pops = []
        t_start = time.perf_counter()
        if label in WHOLE_RUNS:
            state = net.init_state(cfg, params, device=device)
            ring0 = state.ring.ring.sum(dtype=torch.float64)
            with tally_pops(pops):
                state, rec, learnt = paths.drive(cfg, params, state, ext,
                                                 plastic)
            deposits = (state.ring.ring.sum(dtype=torch.float64) - ring0
                        + sum(pops))
        else:
            state, rec, deposits = run_path(net, cfg, params, ext, device,
                                            c.superstep)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_start
        counts[label] = dict(kc.launches)
        print(f"[{label}] {c.n_chips} chips x {c.neurons_per_chip} "
              f"{cfg.neuron_model}, {cfg.comm_mode}, fan-out {c.fanout}, "
              f"{c.mode}, bpc {c.buckets_per_chip}, merge_rate "
              f"{c.merge_rate}, B {c.superstep}, T {ext.shape[0]}"
              f"{', STDP' if plastic else ''}: {ext.shape[0] / wall:.2f} "
              f"steps/s ({wall:.3f} s); launches {counts[label]}")
        s = rec.stats
        print(f"[{label}] spikes {int(rec.spikes.sum())}, sent "
              f"{int(s.sent.sum())}, overflow {int(s.overflow.sum())}, "
              f"expired {int(s.expired.sum())}, merge_dropped "
              f"{int(s.merge_dropped.sum())}, stalled "
              f"{int(s.stalled.sum())}, mean utilization "
              f"{float(s.utilization.mean()):.4f}")
        check_record(label, rec, ext.shape[0], c.n_chips, c.neurons_per_chip)
        if label == "dense":
            check_dense_delivery(cfg, params, rec, deposits)
            gradient_steps(paths, cfg, params, ext)
        else:
            check_conservation(label, state, rec, int(deposits))
        if label == "pipelined":
            check_pipelined(paths, device, state, rec)
        if label == "flow":
            queued = int(state.sendq.occupancy().sum())
            print(f"[flow] credit gate: {int(s.stalled.sum())} words stalled "
                  f"past the send queue, {queued} still queued at the end, "
                  f"{int(state.flow.notifications.sum())} credit "
                  f"notifications")
            if int(s.stalled.sum()) == 0 and queued == 0:
                raise AssertionError("flow: the credit gate never bound")
        if cfg.topology is not None:
            plan = tpo.compile_routes(cfg.topology, cfg.healthy,
                                      cfg.dead_links)
            print(f"[{label}] {cfg.topology.kind} {cfg.topology.dims or ''}"
                  f" max path latency {int(plan.latency.max())}: "
                  f"link_words {tuple(s.link_words.shape)}, per port "
                  f"{s.link_words.sum((0, 1)).tolist()}, backlog "
                  f"{int(s.link_backlog.sum())}, lost_to_failure "
                  f"{int(s.lost_to_failure.sum())}")
        if label == "routed":
            check_compensated(paths, device)
        if label == "degraded":
            dead = list(DEAD_CHIPS)
            touching = [int(s.traffic[:, :, dead].sum()),
                        int(s.traffic[:, dead].sum()),
                        int(s.link_words[:, dead].sum())]
            print(f"[degraded] chips {dead} dead, link {CUT_LINKS} cut: "
                  f"{int(s.lost_to_failure.sum())} words lost to failure; "
                  f"traffic to / from the dead chips and their link words "
                  f"{touching}")
            if int(s.lost_to_failure.sum()) == 0 or any(touching):
                raise AssertionError("degraded: nothing lost, or traffic "
                                     "touched a dead chip")
        if plastic:
            w = learnt.crossbar.w
            if not bool(torch.isfinite(w).all()):
                raise AssertionError("plastic: non-finite weights")
            moved = float((w - params.crossbar.w).abs().max())
            print(f"[plastic] weights moved by up to {moved:.5f}, now in "
                  f"[{float(w.min()):.4f}, {float(w.max()):.4f}]")
            if moved == 0:
                raise AssertionError("plastic: STDP changed no weight")
        for k in needs:
            if counts[label][k] == 0:
                raise AssertionError(f"{label}: kernel {k} never launched")
        counts[label]["steps_per_s"] = ext.shape[0] / wall
    return counts


def check_pipelined(paths: Paths, device, state, rec, blocks: int = 4):
    """The pipelined run against the serial run of the same config and
    LUT on the card (spikes, ring, every integer stat bitwise); then a
    streaming drive of ``pipeline_block`` calls on the run's own events,
    whose conservation closes with the in-flight leg, and its flush."""
    from types import SimpleNamespace

    from repro_torch.core import delays as dl
    from repro_torch.core import events as ev
    from repro_torch.core import fabric as fb

    net, c = paths.net, paths.pipe_cfg.comm
    serial = dataclasses.replace(paths.pipe_cfg, pipeline=False)
    sstate, srec = net.run(serial, paths.pipe_params,
                           net.init_state(serial, paths.pipe_params,
                                          device=device),
                           paths.ff_ext, device=device)
    same = [torch.equal(srec.spikes, rec.spikes),
            torch.equal(sstate.ring.ring, state.ring.ring)]
    same += [torch.equal(getattr(srec.stats, f), getattr(rec.stats, f))
             for f in rec.stats._fields if f != "utilization"]
    if not all(same):
        raise AssertionError("pipelined: differs from the serial run")
    print(f"[pipelined] equals the serial run on the card: spikes, ring "
          f"and every integer stat ({int(rec.stats.sent.sum())} sent); "
          f"the carry is empty after the run "
          f"({int(state.pending.occupancy().sum())} in flight)")

    b = c.superstep
    fabric = fb.PulseFabric(c, device=device)
    ring = dl.init(c.ring_depth, c.n_inputs_per_chip,
                   batch_shape=(c.n_chips,), device=device)
    merge, pending, stats = fabric.init_merge(), None, []
    for f in range(blocks):
        bufs = [ev.from_spikes(rec.spikes[t] > 0.5, t, c.event_capacity)[0]
                for t in range(f * b, (f + 1) * b)]
        res = fabric.pipeline_block(
            ev.EventBuffer(*(torch.stack(x) for x in zip(*bufs))),
            paths.pipe_params.table, ring, None, merge, None, pending)
        ring = dl.DelayRing(ring=res.ring.ring, now=res.ring.now + b)
        merge, pending = res.merge, res.pending
        stats.append(res.stats)
    cat = lambda xs: type(xs[0])(*(torch.cat(v) for v in zip(*xs)))  # noqa
    in_flight = int(pending.occupancy().sum())
    if in_flight == 0:
        raise AssertionError("pipelined streaming: the carry is empty")
    check_conservation(
        f"pipelined streaming, {blocks} blocks",
        SimpleNamespace(merge=merge, sendq=None),
        SimpleNamespace(stats=cat(stats)), ring.ring.sum(dtype=torch.int64),
        carried=pending)
    res = fabric.flush_pending(ring, pending, None, merge)
    if int(res.pending.occupancy().sum()) != 0:
        raise AssertionError("pipelined: the flush left words in flight")
    check_conservation(
        "pipelined streaming, flushed",
        SimpleNamespace(merge=res.merge, sendq=None),
        SimpleNamespace(stats=cat(stats + [res.stats])),
        res.ring.ring.sum(dtype=torch.int64))


def check_compensated(paths: Paths, device):
    """The reference's acceptance identity at full width: the routed
    path's widths in simplified mode (1 bucket per chip) equal, spike for
    spike, a run on the dense transport whose LUT delays are raised by
    the path latency ``latency[src, dest]``."""
    from repro_torch.core import topology as tpo
    from repro_torch.snn import network as net

    topo = paths.routed_cfg.topology
    comm = dataclasses.replace(paths.ff_cfg.comm, mode="simplified",
                               buckets_per_chip=1)
    routed = dataclasses.replace(paths.routed_cfg, comm=comm)
    dense = dataclasses.replace(routed, topology=None)
    table = paths.ff_params.table
    n = comm.n_chips
    lat = torch.as_tensor(tpo.compile_routes(topo).latency, device=device)
    comp = paths.ff_params._replace(table=table._replace(
        delay=table.delay + lat[torch.arange(n, device=device)[:, None, None],
                                table.dest_chip.long()]))
    out = []
    for cfg, params in ((routed, paths.ff_params), (dense, comp)):
        _, rec = net.run(cfg, params, net.init_state(cfg, params,
                                                     device=device),
                         paths.ff_ext, device=device)
        out.append(rec)
    if not torch.equal(out[0].spikes, out[1].spikes):
        raise AssertionError("routed: spikes differ from the dense run with "
                             "latency-compensated delays")
    print(f"[routed] simplified, 1 bucket per chip: "
          f"{int(out[0].spikes.sum())} spikes equal, spike for spike, the "
          f"dense-transport run with delays raised by latency[src, dest] "
          f"({int(out[0].stats.sent.sum())} sent)")


def check_dense_delivery(cfg, params, rec, deposits):
    """Infinite capacity: every spike reaches the rings once for each LUT
    entry that is valid, in range and has a delay in [1, D]."""
    tbl, c = params.table, cfg.comm
    ok = (tbl.valid.bool() & (tbl.delay >= 1) & (tbl.delay <= c.ring_depth)
          & (tbl.dest_chip >= -c.n_chips) & (tbl.dest_chip < c.n_chips))
    want = (rec.spikes.double() * ok.sum(-1).double()).sum()
    print(f"[dense] delivered {float(deposits):.0f} spikes into the rings, "
          f"{float(want):.0f} expected from {int(rec.spikes.sum())} spikes")
    if float(deposits) != float(want) or float(want) == 0:
        raise AssertionError("dense: delivery does not match the LUT")


def check_against_cpu(paths: Paths, label, cfg, params, ext, plastic):
    """The path's first steps on the card against the plain versions on
    the CPU from the same weights: spikes equal, on the event paths every
    integer stat, the ring and the carries (credits, send and merge
    queues) bitwise, learnt weights within 1e-5, and each neuron's
    voltage within 1e-5 of the largest |v| on its own trajectory (at
    least 1).  The card's expf and the CPU's exp may
    differ in the last bit, and the card sums the crossbar in another
    order once STDP has made the weights non-dyadic; a neuron's voltage
    keeps such an ulp of its largest value through the leak and through
    cancelling currents."""
    t = PLAIN_CHECK_STEPS
    cpu = torch.device("cpu")
    cpu_params = type(params)(*(tree_to(x, cpu) for x in params))
    out = {}
    for dev, p in ((paths.device, params), (cpu, cpu_params)):
        state = paths.net.init_state(cfg, p, device=dev)
        final, rec, learnt = paths.drive(cfg, p, state, ext[:t].to(dev),
                                         plastic, device=dev)
        out[dev.type] = (rec, learnt, final)
    (grec, gp, gfinal), (crec, cp, cfinal) = out["cuda"], out["cpu"]
    if not torch.equal(grec.spikes.cpu(), crec.spikes):
        raise AssertionError(f"{label}: spikes differ from the CPU run")
    if cfg.comm_mode == "event":
        pairs = [(getattr(grec.stats, f), getattr(crec.stats, f))
                 for f in crec.stats._fields if f != "utilization"]
        for name in ("ring", "flow", "sendq", "merge"):
            if getattr(cfinal, name) is not None:
                pairs += zip(getattr(gfinal, name), getattr(cfinal, name))
        if not all(torch.equal(g.cpu(), w) for g, w in pairs):
            raise AssertionError(f"{label}: stats, ring or carries differ "
                                 f"from the CPU run")
    scale = crec.voltage.abs().amax(0, keepdim=True).clamp(min=1.0)
    rel = float(((grec.voltage.cpu() - crec.voltage).abs() / scale).max())
    dw = float((gp.crossbar.w.cpu() - cp.crossbar.w).abs().max())
    if rel > 1e-5 or dw > 1e-5:
        raise AssertionError(f"{label}: voltage {rel} (of each neuron's "
                             f"largest |v|) / weights {dw} differ from the "
                             f"CPU run")
    print(f"[{label}] first {t} steps equal the plain CPU run: "
          f"{int(crec.spikes.sum())} spikes equal"
          + (", integer stats, ring and carries bitwise"
             if cfg.comm_mode == "event" else "")
          + f", max |dv| / max|v| "
          f"{rel:.3g} (|v| up to {float(scale.max()):.4g}), max |dw| "
          f"{dw:.3g}")


def tree_to(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return type(x)(*(tree_to(v, device) for v in x))


def gradient_steps(paths: Paths, cfg, params, ext, steps: int = 3,
                   t: int = PLAIN_CHECK_STEPS, lr: float = 5.0):
    """Surrogate-gradient descent on the dense path: the squared distance
    of the mean firing rate from 0.05 over ``t`` steps, ``steps`` times."""
    from repro_torch.snn import synapse as sy

    w = params.crossbar.w.clone().requires_grad_()
    losses = []
    t_start = time.perf_counter()
    for _ in range(steps):
        p = params._replace(crossbar=sy.Crossbar(w=w))
        state = paths.net.init_state(cfg, p, device=paths.device)
        _, rec = paths.net.run(cfg, p, state, ext[:t], device=paths.device)
        loss = (rec.spikes.mean() - 0.05) ** 2
        (g,) = torch.autograd.grad(loss, w)
        if not bool(torch.isfinite(g).all()) or float(g.abs().sum()) == 0:
            raise AssertionError("dense: the gradient is not finite and "
                                 "nonzero")
        losses.append(float(loss.detach()))
        w = (w - lr * g).detach().requires_grad_()
    torch.cuda.synchronize()
    print(f"[dense] {steps} surrogate-gradient steps at T {t}: loss "
          f"{' -> '.join(f'{x:.6g}' for x in losses)}, |grad| finite and "
          f"nonzero ({(time.perf_counter() - t_start) / steps:.3f} s/step)")


RESILIENT_FAILURES = ((7, 13), (30, 22))
RESILIENT_STEPS = 32
RESILIENT_EVERY = 4
FLIGHT_DEPTH = 16
# The phase scopes (``repro_torch.obs.phase_scope``) whose device time the
# profile phase reads; their annotations are not kernels.
SCOPES = ("fabric/inject", "fabric/exchange", "fabric/drain", "fabric/flush",
          "pulse_comm/exchange_issue", "pulse_comm/exchange_complete",
          "obs/metrics_update", "fabric/recovery_dump")


def drill_fns(net, cfg, params, injector, ext, device):
    """The drill's ``(make_step, detect)``, as tests/test_resilience.py
    builds them: inputs masked by the true alive mask, the dead chips'
    neuron and ring rows frozen, the network rebuilt with ``healthy=``
    on the survivors; detection from the injector's schedule."""
    from repro_torch.core import resilience as rsl

    def make_step(healthy):
        hcfg = dataclasses.replace(cfg, healthy=tuple(healthy))

        def step_fn(state, t):
            alive = injector.alive_at(t, device=device)
            new_state, rec = net.step(hcfg, params, state,
                                      ext[t] * alive[:, None], device=device)
            fzn, fzr = rsl.freeze(alive, (state.neuron, state.ring),
                                  (new_state.neuron, new_state.ring))
            new_state = new_state._replace(neuron=fzn, ring=fzr)
            return new_state, rec._replace(
                spikes=rec.spikes * alive[:, None].to(rec.spikes.dtype))
        return step_fn

    def detect(state, t, healthy):
        surviving = tuple(c for c in injector.healthy_after(t)
                          if c in healthy)
        return surviving if surviving != tuple(healthy) else None

    return make_step, detect


def run_drill(paths: Paths, device, workdir: Path) -> dict:
    """The resilient path on ``device``: ``ResilientRunner`` over T 32
    steps with checkpoints every 4, chips 7 and 30 killed at steps 13 and
    22.  Each rebuild after a failure also restores the checkpoint it
    resumes from, for the uninterrupted reference runs."""
    from repro_torch import checkpoint as ckpt
    from repro_torch.core import resilience as rsl
    from repro_torch.runtime import ResilientRunner

    cfg = paths.resilient_cfg
    params = tree_to(paths.ff_params, device)
    injector = rsl.FabricFaultInjector(n_chips=cfg.comm.n_chips,
                                       chip_failures=RESILIENT_FAILURES)
    make_step, detect = drill_fns(paths.net, cfg, params, injector,
                                  paths.ff_ext.to(device), device)
    state0 = paths.net.init_state(cfg, params, device=device)
    ckpt_dir, flight_dir = workdir / "ckpt", workdir / "flight"
    flight_dir.mkdir(parents=True)
    resumes = {}

    def rebuild(healthy):
        last = ckpt.latest_step(str(ckpt_dir))
        if last is not None and len(healthy) < cfg.comm.n_chips:
            resumes[healthy] = (last + 1, ckpt.restore(
                str(ckpt_dir), last, ckpt.tree_map(torch.zeros_like,
                                                   state0)))
        return make_step(healthy)

    runner = ResilientRunner(
        make_step=rebuild, detect=detect, ckpt_dir=str(ckpt_dir),
        n_chips=cfg.comm.n_chips, ckpt_every=RESILIENT_EVERY,
        flight_of=lambda s: s.metrics.flight, flight_dir=str(flight_dir))
    t_start = time.perf_counter()
    final, healthy = runner.run(state0, RESILIENT_STEPS)
    if device.type == "cuda":
        torch.cuda.synchronize()
    return dict(runner=runner, final=final, healthy=healthy, state0=state0,
                resumes=resumes, make_step=make_step,
                wall=time.perf_counter() - t_start)


def _int_stats_equal(a, b) -> bool:
    return all(torch.equal(getattr(a, f).cpu(), getattr(b, f).cpu())
               for f in a._fields if f != "utilization")


def _flight_row_of(stats, t0: int) -> dict:
    """The flight-ring row a B-1 step's ``CommStats`` gives (per-chip
    fields, link words and the end-of-step backlog summed over ports)."""
    from repro_torch.obs import metrics as obm

    row = {f: getattr(stats, f).tolist() for f in obm.SCALAR_FIELDS}
    row["link_words"] = stats.link_words.sum(-1).tolist()
    row["link_backlog"] = stats.link_backlog.sum(-1).tolist()
    return row


def check_states_close(label: str, got, want):
    """Every leaf of two states: integers bitwise; voltages within 1e-5 of
    max(|v|, 1); other floats (the telemetry EMAs) within 1e-6
    relative."""
    from repro_torch import checkpoint as ckpt

    g, w = ckpt.tree_flatten_with_path(got)[0], ckpt.tree_leaves(want)
    if len(g) != len(w):
        raise AssertionError(f"{label}: {len(g)} leaves vs {len(w)}")
    worst = 0.0
    for (path, a), b in zip(g, w):
        a, b = a.cpu(), b.cpu()
        name = "/".join(map(str, path))
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"{label}: {name} {a.dtype}"
                                 f"{tuple(a.shape)} vs {b.dtype}"
                                 f"{tuple(b.shape)}")
        if not a.dtype.is_floating_point:
            if not torch.equal(a, b):
                raise AssertionError(f"{label}: {name} differs")
            continue
        scale = (b.abs().clamp(min=1.0) if name == "neuron/v"
                 else b.abs().clamp(min=1e-30))
        tol = 1e-5 if name == "neuron/v" else 1e-6
        rel = float(((a.double() - b.double()).abs() / scale).max()) \
            if a.numel() else 0.0
        worst = max(worst, rel)
        if rel > tol:
            raise AssertionError(f"{label}: {name} differs by {rel:.3g} "
                                 f"relative (tolerance {tol:g})")
    return worst


def resilient_phase(paths: Paths, device) -> dict:
    """The slice's main path: the wafer-width network under
    ``ResilientRunner`` through two chip failures, counters zeroed just
    before; then its checks against uninterrupted runs on the survivors,
    the flight dumps, the same drill on the CPU, and the checkpoint's
    cost.  Returns the drill's launches per kernel."""
    import tempfile

    from repro_torch import checkpoint as ckpt
    from repro_torch import obs
    from repro_torch.kernels import common as kc
    from repro_torch.kernels.fused_inject import ops as fi_ops
    from repro_torch.runtime import RecoveryEvent

    cfg, c = paths.resilient_cfg, paths.resilient_cfg.comm
    n = c.n_chips
    libs = dict(kc._libs)
    built = {p: p.stat().st_mtime_ns for p in kc.build_dir().glob("*.so")}
    reach_calls = []
    orig_inject = fi_ops.fused_inject

    def inject(*args, **kwargs):
        reach_calls.append(kwargs.get("reach") is not None)
        return orig_inject(*args, **kwargs)

    with tempfile.TemporaryDirectory() as tmp:
        workdir = Path(tmp)
        torch.cuda.synchronize()
        kc.reset_launches()
        fi_ops.fused_inject = inject
        try:
            card = run_drill(paths, device, workdir / "card")
        finally:
            fi_ops.fused_inject = orig_inject
        counts = dict(kc.launches)
        runner = card["runner"]
        steps_run = RESILIENT_STEPS + sum(
            r.detected_at - r.resumed_from + 1 for r in runner.recoveries)
        print(f"[resilient] {n} chips x {c.neurons_per_chip} "
              f"{cfg.neuron_model}, {cfg.topology.kind} "
              f"{cfg.topology.dims}, {c.mode}, bpc {c.buckets_per_chip}, "
              f"merge_rate {c.merge_rate}, B {c.superstep}, T "
              f"{RESILIENT_STEPS}, checkpoints every {RESILIENT_EVERY}, "
              f"chips killed {RESILIENT_FAILURES}: {steps_run} steps run "
              f"in {card['wall']:.3f} s; launches {counts}; fused_inject "
              f"with a reach row {sum(reach_calls)} of {len(reach_calls)} "
              f"calls")
        for k in ("fused_inject", "fused_drain", "lif_step"):
            if counts[k] == 0:
                raise AssertionError(f"resilient: kernel {k} never launched")
        if not any(reach_calls):
            raise AssertionError("resilient: fused_inject never ran with a "
                                 "reach row")
        if dict(kc._libs) != libs or {
                p: p.stat().st_mtime_ns
                for p in kc.build_dir().glob("*.so")} != built:
            raise AssertionError("resilient: a rebuild of the fabric built "
                                 "or loaded a kernel library again")

        h1 = tuple(i for i in range(n) if i != 7)
        h2 = tuple(i for i in range(n) if i not in (7, 30))
        want = [RecoveryEvent(13, 12, h1), RecoveryEvent(22, 20, h2)]
        print(f"[resilient] recoveries (detected at, resumed from, "
              f"survivors): {[(r.detected_at, r.resumed_from, len(r.healthy)) for r in runner.recoveries]}")
        if runner.recoveries != want or card["healthy"] != h2:
            raise AssertionError(f"resilient: recoveries "
                                 f"{runner.recoveries}, not {want}")
        if sorted(runner.records) != list(range(RESILIENT_STEPS)):
            raise AssertionError("resilient: records do not cover T")

        # From each resume point: an uninterrupted run on the survivors
        # from the same checkpoint; its steps up to the next resume point
        # are the records (the failing trajectory's later steps feed the
        # second flight dump).
        make_step = card["make_step"]
        records, ref_stats = runner.records, {}
        state = card["state0"]
        full = make_step(tuple(range(n)))
        for t in range(13 + 1):
            state, rec = full(state, t)
            ref_stats[("full", t)] = rec.stats
        ends = {h1: (20, 22), h2: (RESILIENT_STEPS, RESILIENT_STEPS - 1)}
        for healthy, (resume, state) in card["resumes"].items():
            step_fn = make_step(healthy)
            upto, last = ends[healthy]
            for t in range(resume, last + 1):
                state, rec = step_fn(state, t)
                ref_stats[(healthy, t)] = rec.stats
                if t < upto and not (
                        torch.equal(rec.spikes, records[t].spikes)
                        and _int_stats_equal(rec.stats, records[t].stats)):
                    raise AssertionError(f"resilient: step {t} differs from "
                                         f"the uninterrupted run on "
                                         f"{len(healthy)} chips")
            print(f"[resilient] steps {resume} to {upto - 1} equal an "
                  f"uninterrupted run on {len(healthy)} chips from the "
                  f"step-{resume - 1} checkpoint (spikes, every integer "
                  f"stat)")
        check_states_close("resilient final state vs the uninterrupted run",
                           card["final"], state)
        for chip, kill in RESILIENT_FAILURES:
            late = sum(int(records[t].spikes[chip].sum())
                       for t in range(kill, RESILIENT_STEPS))
            if late:
                raise AssertionError(f"resilient: chip {chip} spiked after "
                                     f"its kill at {kill}")
        s = {f: sum(int(getattr(records[t].stats, f).sum())
                    for t in records) for f in ("sent", "lost_to_failure",
                                                "expired", "merge_dropped")}
        spikes = sum(int(records[t].spikes.sum()) for t in records)
        print(f"[resilient] {spikes} spikes, {s['sent']} sent, "
              f"{s['lost_to_failure']} lost to failure, {s['expired']} "
              f"expired, {s['merge_dropped']} merge_dropped over the "
              f"records; no spike from a dead chip after its kill")
        if s["lost_to_failure"] == 0:
            raise AssertionError("resilient: nothing lost to failure")

        dumps = [obs.load_flight(p) for p in runner.flight_dumps]
        if len(dumps) != 2:
            raise AssertionError(f"resilient: {len(dumps)} flight dumps")
        for dump, failure, trail in zip(dumps, want, (("full",) * 14,
                                                      ("full",) * 12
                                                      + (h1,) * 11)):
            seqs = [b["seq"] for b in dump["blocks"]]
            first = failure.detected_at + 1 - min(FLIGHT_DEPTH,
                                                 failure.detected_at + 1)
            if seqs != list(range(first, failure.detected_at + 1)):
                raise AssertionError(f"resilient: dump blocks {seqs}")
            for b in dump["blocks"]:
                key = (trail[b["seq"]], b["seq"])
                if b["per_chip"] != _flight_row_of(ref_stats[key], b["seq"]):
                    raise AssertionError(f"resilient: flight block "
                                         f"{b['seq']} differs from the "
                                         f"failing trajectory")
            print(f"[resilient] flight dump at step {dump['failure']['step']}"
                  f": blocks {seqs[0]} to {seqs[-1]} equal the failing "
                  f"trajectory's per-step stats; "
                  f"{len(dump['recoveries'])} earlier recoveries")

        t_start = time.perf_counter()
        cpu = run_drill(paths, torch.device("cpu"), workdir / "cpu")
        cpu_s = time.perf_counter() - t_start
        if cpu["runner"].recoveries != runner.recoveries:
            raise AssertionError("resilient: CPU recoveries differ")
        vmax = 0.0
        for t in range(RESILIENT_STEPS):
            g, w = records[t], cpu["runner"].records[t]
            if not (torch.equal(g.spikes.cpu(), w.spikes)
                    and _int_stats_equal(g.stats, w.stats)):
                raise AssertionError(f"resilient: step {t} differs from the "
                                     f"CPU run")
            vmax = max(vmax, float(((g.voltage.cpu() - w.voltage).abs()
                                    / w.voltage.abs().clamp(min=1.0)).max()))
        if vmax > 1e-5:
            raise AssertionError(f"resilient: voltages differ from the CPU "
                                 f"run by {vmax:.3g}")
        worst = check_states_close("resilient final state vs the CPU run",
                                   card["final"], cpu["final"])
        cpu_dumps = [obs.load_flight(p) for p in cpu["runner"].flight_dumps]
        if cpu_dumps != dumps:
            raise AssertionError("resilient: flight dumps differ from the "
                                 "CPU run's")
        print(f"[resilient] the drill on the CPU ({cpu_s:.1f} s): the same "
              f"records (spikes, every integer stat; voltages within "
              f"{vmax:.3g} of max(|v|, 1)), recoveries and final state "
              f"(floats within {worst:.3g} relative); flight dumps equal "
              f"row for row")

        final = card["final"]
        size = nbytes(ckpt.tree_leaves(final))
        save_ms, restore_ms = [], []
        for i in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ckpt.save(final, str(workdir / "timing"), i)
            save_ms.append((time.perf_counter() - t0) * 1e3)
            target = ckpt.tree_map(torch.zeros_like, final)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            back = ckpt.restore(str(workdir / "timing"), i, target)
            torch.cuda.synchronize()
            restore_ms.append((time.perf_counter() - t0) * 1e3)
        compare("checkpoint round trip", back, final)
        on_disk = sum(p.stat().st_size for p in
                      Path(ckpt.step_dir(str(workdir / "timing"), 0)).iterdir())
        print(f"[resilient] checkpoint of the network state: {size} bytes "
              f"in {len(ckpt.tree_leaves(final))} leaves ({on_disk} on "
              f"disk); save ms {[round(x, 3) for x in save_ms]}, restore "
              f"onto the card ms {[round(x, 3) for x in restore_ms]}")
    counts["steps_per_s"] = steps_run / card["wall"]
    counts["checkpoint"] = dict(bytes=size, save_ms=save_ms,
                                restore_ms=restore_ms)
    return counts


def telemetry_phase(paths: Paths, device) -> dict:
    """Telemetry on the feedforward (B 8) and pipelined paths: on equals
    off on the card (spikes, ring, every stat), the carry after 16 steps
    equals the CPU's, and ``check_conservation`` closes from
    ``metrics_summary``'s totals with the queued and in-flight legs."""
    from repro_torch import obs

    net, out = paths.net, {}
    for label, cfg, params in (
            ("feedforward", paths.ff_cfg, paths.ff_params),
            ("pipelined", paths.pipe_cfg, paths.pipe_params)):
        on = dataclasses.replace(cfg, telemetry=True)
        ext = paths.ff_ext
        runs = {}
        for name, ccfg in (("off", cfg), ("on", on)):
            state = net.init_state(ccfg, params, device=device)
            ring0 = state.ring.ring.sum(dtype=torch.float64)
            pops = []
            with tally_pops(pops):
                final, rec = net.run(ccfg, params, state, ext, device=device)
            deposits = (final.ring.ring.sum(dtype=torch.float64) - ring0
                        + sum(pops))
            runs[name] = (final, rec, deposits)
        (foff, roff, _), (fon, ron, deposits) = runs["off"], runs["on"]
        same = [torch.equal(roff.spikes, ron.spikes),
                torch.equal(foff.ring.ring, fon.ring.ring)]
        same += [torch.equal(getattr(roff.stats, f), getattr(ron.stats, f))
                 for f in roff.stats._fields]
        if not all(same):
            raise AssertionError(f"telemetry {label}: the run with "
                                 f"telemetry differs from the run without")
        summary = obs.metrics_summary(fon.metrics)
        queued = fon.merge.occupancy() if fon.merge is not None else 0
        in_flight = (fon.pending.occupancy() if fon.pending is not None
                     else 0)
        report = obs.check_conservation(
            summary["totals"], delivered=int(deposits), queued=queued,
            in_flight=in_flight)
        carries = []
        for dev in (device, torch.device("cpu")):
            p = tree_to(params, dev)
            final, _ = net.run(on, p, net.init_state(on, p, device=dev),
                               ext[:PLAIN_CHECK_STEPS].to(dev), device=dev)
            carries.append(final.metrics)
        worst = check_states_close(f"telemetry {label}: carry vs the CPU",
                                   *carries)
        print(f"[telemetry] {label}: telemetry on equals off on the card "
              f"(spikes, ring, every stat); {summary['steps']} substeps in "
              f"{summary['blocks']} fabric calls; conservation from the "
              f"carry's totals: injected {report.injected} == delivered "
              f"{report.delivered} + queued {report.queued} + in flight "
              f"{report.in_flight} + dropped {sum(report.legs.values())}; "
              f"the carry after {PLAIN_CHECK_STEPS} steps equals the CPU's "
              f"(integers bitwise, floats within {worst:.3g} relative)")
        out[label] = dict(totals=summary["totals"], ema=summary["ema"])
        if label == "feedforward":
            out["ab"] = telemetry_ab(paths, device, cfg, on, params, ext,
                                     fon, ron)
    return out


def telemetry_ab(paths: Paths, device, off, on, params, ext, state,
                 rec) -> dict:
    """Wall ms per step of the feedforward path without and with
    telemetry, in turns (off, on, on, off, after a warm-up of each), and
    the host µs of one ``metrics_update`` call on a block's stats."""
    from repro_torch import obs

    net, walls = paths.net, {"off": [], "on": []}
    for name, ccfg in (("off", off), ("on", on)):
        net.run(ccfg, params, net.init_state(ccfg, params, device=device),
                ext[:16], device=device)
    for name in ("off", "on", "on", "off"):
        ccfg = on if name == "on" else off
        state0 = net.init_state(ccfg, params, device=device)
        torch.cuda.synchronize()
        t_start = time.perf_counter()
        net.run(ccfg, params, state0, ext, device=device)
        torch.cuda.synchronize()
        walls[name].append((time.perf_counter() - t_start) * 1e3
                           / ext.shape[0])
    b = off.comm.superstep
    stats = type(rec.stats)(*(x[:b] for x in rec.stats))
    mcfg = obs.MetricsConfig()
    us = host_us(lambda: obs.metrics_update(mcfg, state.metrics, stats,
                                            merge=state.merge))
    print(f"[telemetry] feedforward wall ms/step in turns: off "
          f"{walls['off'][0]:.4f}, on {walls['on'][0]:.4f}, on "
          f"{walls['on'][1]:.4f}, off {walls['off'][1]:.4f}; host µs per "
          f"metrics_update call {us:.2f} (1000 calls, one synchronise)")
    return dict(wall_ms_per_step=walls, metrics_update_host_us=us)


# The shard phase: the three shard forms at the feedforward cell's widths.
SHARD_FORMS = ("feedforward", "pipelined", "degraded")
SHARD_ROWS = slice(23, 46)        # the second rank's chips at world 2


def shard_drive(net, cfg, params, state, ext, mesh):
    """The shard forms over ``ext``, block by block: ``shard_superstep``,
    or on the pipelined schedule ``shard_pipeline_block`` then
    ``shard_flush_pending`` (stats realigned to their blocks, as
    ``net.run`` does).  Returns ``(state, record)``."""
    b = cfg.comm.superstep
    spikes, volts, stats = [], [], []
    form = net.shard_pipeline_block if cfg.pipeline else net.shard_superstep
    for t in range(0, ext.shape[0], b):
        state, rec = form(cfg, "chip", params, state, ext[t:t + b],
                          mesh=mesh)
        spikes.append(rec.spikes)
        volts.append(rec.voltage)
        stats.append(rec.stats)
    if cfg.pipeline:
        state, flushed = net.shard_flush_pending(cfg, "chip", state,
                                                 mesh=mesh)
        stats = stats[1:] + [flushed]
    return state, net.StepRecord(
        spikes=torch.cat(spikes), voltage=torch.cat(volts),
        stats=type(stats[0])(*(torch.cat(x) for x in zip(*stats))))


def check_same_run(label: str, got, want) -> None:
    """Two ``(state, record)`` runs of the same kernels: every leaf equal
    (spikes, voltages, every stat, ring, merge queue, pipeline carry)."""
    from repro_torch import checkpoint as ckpt

    g, w = ckpt.tree_flatten_with_path(got)[0], ckpt.tree_leaves(want)
    if len(g) != len(w):
        raise AssertionError(f"{label}: {len(g)} leaves vs {len(w)}")
    for (path, a), b in zip(g, w):
        if a.shape != b.shape or a.dtype != b.dtype or not torch.equal(a, b):
            raise AssertionError(f"{label}: {'/'.join(map(str, path))} "
                                 f"differs from the local run")


def shard_rows_check(paths: Paths, blocks: dict, device) -> None:
    """``fused_inject`` and ``fused_lif_inject`` on the shard forms' call:
    rows 23 to 45 of 46 chips (``n_rows`` 23, ``n_chips`` 46), with the
    degraded path's reach rows [23:46], against their plain versions and
    against rows 23 to 45 of the 46-row call, bitwise."""
    from repro_torch.kernels import common as kc
    from repro_torch.core import events as ev
    from repro_torch.core import routing as rt
    from repro_torch.kernels.fused_inject import ops as fi_ops
    from repro_torch.kernels.fused_inject.ref import (fused_inject_ref,
                                                     fused_lif_inject_ref)
    from repro_torch.snn import neuron as nr

    rows = SHARD_ROWS
    cut = lambda x: x[rows].contiguous()  # noqa: E731
    col = lambda x: x[:, rows].contiguous()  # noqa: E731
    (events, table, t0), kw = blocks["degraded"]["fused_inject"]
    kwp = dict(kw, reach=cut(kw["reach"]))
    part = (ev.EventBuffer(*(col(x) for x in events)),
            rt.RoutingTable(*(cut(x) for x in table)), cut(t0))
    got = fi_ops.fused_inject(*part, **kwp)
    compare("shard rows: fused_inject", got, fused_inject_ref(*part, **kwp))
    whole = fi_ops.fused_inject(events, table, t0, **kw)
    compare("shard rows: fused_inject against the 46-row call", got,
            tuple(cut(h) if f == "slab" else col(h)
                  for f, h in zip(whole._fields, whole)))
    lost = int(got.lost.sum())
    c = paths.ff_cfg.comm
    (v, refrac, currents, params, ltable, now), kwl = lif_inject_call(
        paths, device, "full", c.buckets_per_chip, c.superstep)
    kwl = dict(kwl, reach=kw["reach"])
    args = (cut(v), cut(refrac), col(currents),
            nr.LIFParams(*(cut(x) for x in params)),
            rt.RoutingTable(*(cut(x) for x in ltable)), cut(now))
    kwlp = dict(kwl, reach=cut(kw["reach"]))
    got = fi_ops.fused_lif_inject(*args, **kwlp)
    compare("shard rows: fused_lif_inject", got,
            fused_lif_inject_ref(*args, **kwlp))
    whole = fi_ops.fused_lif_inject(v, refrac, currents, params, ltable,
                                    now, **kwl)
    compare("shard rows: fused_lif_inject against the 46-row call", got,
            (cut(whole.v), cut(whole.refrac), col(whole.spikes),
             col(whole.voltage),
             tuple(cut(h) if f == "slab" else col(h)
                   for f, h in zip(whole.inject._fields, whole.inject))))
    print(f"[shard] fused_inject and fused_lif_inject at n_rows "
          f"{rows.stop - rows.start} of {c.n_chips} chips (reach rows "
          f"[{rows.start}:{rows.stop}]) equal their plain versions and "
          f"the 46-row calls' rows, bitwise ({lost} words culled in the "
          f"rows' first block)")
    times = dict(
        inject_rows=kc.graph_ms(
            lambda: fi_ops.fused_inject(*part, **kwp)),
        inject_all=kc.graph_ms(
            lambda: fi_ops.fused_inject(events, table, t0, **kw)),
        lif_rows=kc.graph_ms(
            lambda: fi_ops.fused_lif_inject(*args, **kwlp)),
        lif_all=kc.graph_ms(lambda: fi_ops.fused_lif_inject(
            v, refrac, currents, params, ltable, now, **kwl)))
    print(f"[shard] ms per call (CUDA events over a CUDA graph of 20 calls):"
          f" fused_inject "
          f"{times['inject_rows']:.5f} at 23 rows, {times['inject_all']:.5f}"
          f" at 46; fused_lif_inject {times['lif_rows']:.5f} at 23 rows, "
          f"{times['lif_all']:.5f} at 46")


def _shard_rank(rank: int, world: int, store: str, out: str, seed: int,
                steps: int) -> None:
    """A rank of the multi-GPU run (spawned, GPU ``rank``): the
    feedforward path's shard form on its chips against its rows of the
    local run on its card, and its wall time per step."""
    import torch.distributed as dist

    from repro_torch.launch import mesh as ms

    torch.cuda.set_device(rank)
    device = torch.device("cuda", rank)
    dist.init_process_group("nccl", init_method="file://" + store,
                            rank=rank, world_size=world)
    try:
        paths = Paths(device, seed, steps)
        net, cfg, params = paths.net, paths.ff_cfg, paths.ff_params
        n_local = cfg.comm.n_chips // world
        want = net.run(cfg, params, net.init_state(cfg, params,
                                                   device=device),
                       paths.ff_ext, device=device)
        mesh = ms.make_chip_mesh()
        mine = net.shard_slice((params, net.init_state(cfg, params,
                                                       device=device)),
                               rank, n_local)
        rows = slice(rank * n_local, (rank + 1) * n_local)
        got = shard_drive(net, cfg, mine[0], mine[1], paths.ff_ext[:, rows],
                          mesh)
        equal = (torch.equal(got[1].spikes, want[1].spikes[:, rows])
                 and torch.equal(got[0].ring.ring, want[0].ring.ring[rows]))
        dist.barrier()
        torch.cuda.synchronize()
        t_start = time.perf_counter()
        shard_drive(net, cfg, mine[0], mine[1], paths.ff_ext[:, rows], mesh)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_start
        torch.save(dict(equal=equal, wall_ms_per_step=wall * 1e3
                        / paths.ff_ext.shape[0]), f"{out}-{rank}.pt")
    finally:
        dist.destroy_process_group()


def shard_phase(paths: Paths, blocks: dict, device, seed: int,
                steps: int) -> tuple[dict, dict]:
    """The shard forms on the card at world 1 over NCCL (every chip on the
    one rank, the exchange one ``all_to_all_single``), against the local
    run; the heartbeat; the kernels at ``n_rows`` 23 of 46; a world-2
    run where a second GPU exists; the profile of ``shard_superstep``
    against the local run.  Returns ``(launches, profile rows)``."""
    import shutil
    import tempfile

    import torch.distributed as dist

    from repro_torch.core import resilience as rsl
    from repro_torch.core import transport as tp
    from repro_torch.kernels import common as kc
    from repro_torch.launch import mesh as ms

    net = paths.net
    if not (dist.is_available() and dist.is_nccl_available()):
        raise AssertionError("shard: this PyTorch has no NCCL")
    tmp = tempfile.mkdtemp(prefix="shard-")
    dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                            rank=0, world_size=1)
    try:
        mesh = ms.make_chip_mesh()
        total = {k: 0 for k in kc.launches}
        forms = dict(feedforward=(paths.ff_cfg, paths.ff_params),
                     pipelined=(paths.pipe_cfg, paths.pipe_params),
                     degraded=(paths.degraded_cfg, paths.ff_params))
        for label in SHARD_FORMS:
            cfg, params = forms[label]
            c = cfg.comm
            want = net.run(cfg, params, net.init_state(cfg, params,
                                                       device=device),
                           paths.ff_ext, device=device)
            state = net.shard_slice(net.init_state(cfg, params,
                                                   device=device),
                                    0, c.n_chips)
            torch.cuda.synchronize()
            kc.reset_launches()
            t_start = time.perf_counter()
            got = shard_drive(net, cfg, params, state, paths.ff_ext, mesh)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t_start
            launches = dict(kc.launches)
            check_same_run(f"shard {label}", got, want)
            for k in ("fused_inject", "fused_drain", "lif_step"):
                if launches[k] == 0:
                    raise AssertionError(f"shard {label}: kernel {k} never "
                                         f"launched")
            for k, n in launches.items():
                total[k] += n
            s = got[1].stats
            form = ("shard_pipeline_block + shard_flush_pending"
                    if cfg.pipeline else "shard_superstep")
            print(f"[shard] {label} at world 1 (NCCL, {c.n_chips} chips on "
                  f"rank 0), {form}, B {c.superstep}, T "
                  f"{paths.ff_ext.shape[0]}: equals "
                  f"the local run (spikes, voltages, every stat, ring, "
                  f"carries); sent {int(s.sent.sum())}, lost "
                  f"{int(s.lost_to_failure.sum())}, link words "
                  f"{int(s.link_words.sum())}; "
                  f"{paths.ff_ext.shape[0] / wall:.2f} steps/s; launches "
                  f"{launches}")
        alive = torch.ones(46, dtype=torch.int32, device=device)
        alive[list(DEAD_CHIPS)] = 0
        beats = rsl.heartbeat(tp.DistributedTransport(
            mesh=mesh, axis="chip", n_chips=46), alive)
        if not torch.equal(beats, rsl.beats_local(alive)):
            raise AssertionError("shard: the heartbeat differs from "
                                 "beats_local")
        print(f"[shard] heartbeat (one all_reduce) equals beats_local: "
              f"{int(beats.sum())} of 46 chips, {list(DEAD_CHIPS)} silent")
        shard_rows_check(paths, blocks, device)
        profile = shard_profile(paths, mesh, device)
        # After the profile: a spawned process may leave this process's
        # profiler without device activity (seen in the card tests).
        n_dev = torch.cuda.device_count()
        if n_dev >= 2:
            import torch.multiprocessing as mp

            mp.spawn(_shard_rank, args=(2, f"{tmp}/store2", f"{tmp}/out",
                                        seed, steps), nprocs=2, join=True)
            ranks = [torch.load(f"{tmp}/out-{r}.pt") for r in range(2)]
            if not all(r["equal"] for r in ranks):
                raise AssertionError("shard: the world-2 run differs from "
                                     "the local run")
            print(f"[shard] world 2 (NCCL, 23 chips a rank, {n_dev} devices"
                  f"): equals the local run; wall ms per step by rank "
                  f"{[r['wall_ms_per_step'] for r in ranks]}")
        else:
            print(f"[shard] multi-rank run skipped: {n_dev} CUDA device "
                  f"(world 2 needs a second one; the CPU tests hold "
                  f"worlds 2 and 4 on gloo)")
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    return total, profile


def shard_profile(paths: Paths, mesh, device, blocks: int = 4) -> dict:
    """torch.profiler over ``blocks`` blocks of the feedforward path (after
    a warm-up block), ``shard_superstep`` at world 1 against the local
    ``net.run``, per step; the NCCL kernels by name."""
    from repro_torch.kernels import common as kc
    net, cfg, params = paths.net, paths.ff_cfg, paths.ff_params
    b = cfg.comm.superstep
    ext = paths.ff_ext
    out = {}
    for label in ("feedforward (local)", "feedforward (shard, world 1)"):
        state = net.init_state(cfg, params, device=device)
        if "shard" in label:
            state = net.shard_slice(state, 0, cfg.comm.n_chips)
            step = lambda s, e: net.shard_superstep(  # noqa: E731
                cfg, "chip", params, s, e, mesh=mesh)
        else:
            step = lambda s, e: net.run(  # noqa: E731
                cfg, params, s, e, device=device)
        state, _ = step(state, ext[:b])
        torch.cuda.synchronize()

        def window(step=step, state=state):
            t_start = time.perf_counter()
            for i in range(1, blocks + 1):
                state, _ = step(state, ext[i * b:(i + 1) * b])
            torch.cuda.synchronize()
            return time.perf_counter() - t_start

        prof, wall = kc.profiled(window, f"profile of {label}")
        row = profile_row(prof, wall, blocks * b)
        row["nccl_kernels"] = sorted({
            e.key[:80] for e in prof.key_averages()
            if "nccl" in e.key.lower()
            and kc.on_device(e)})
        out[label] = row
        print_profile(label, row)
        print(f"[profile] {label}:   NCCL kernels {row['nccl_kernels']}")
    return out


def profile_row(prof, wall: float, units: float) -> dict:
    """Per unit (a step, a prefill, a decode step) of a profiled window:
    wall and device busy time (sum of kernel times on the one stream),
    the idle share, kernel launches and the costliest kernels."""
    from repro_torch.kernels import common as kc
    kernels = [e for e in prof.key_averages() if kc.on_device(e)
               and e.key not in SCOPES and not e.key.startswith("serve/")]
    dev_us = lambda e: (getattr(e, "self_device_time_total", None)  # noqa: E731
                        or getattr(e, "device_time_total", 0.0))
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3
    top = sorted(kernels, key=dev_us, reverse=True)[:5]
    return dict(
        wall_ms_per_step=wall * 1e3 / units,
        device_busy_ms_per_step=busy_ms / units,
        idle_share=1.0 - busy_ms / (wall * 1e3),
        kernel_launches_per_step=sum(e.count for e in kernels) / units,
        top_kernels=[(e.key[:60], dev_us(e) / 1e3 / units) for e in top],
        scopes=scope_ms(prof, units))


def named_ms(prof) -> dict:
    """Device ms of each kernel of a profiled window, by its name."""
    from repro_torch.kernels import common as kc
    return {e.key: (getattr(e, "self_device_time_total", None)
                    or getattr(e, "device_time_total", 0.0)) / 1e3
            for e in prof.key_averages() if kc.on_device(e)}


def scope_ms(prof, units: float) -> dict:
    """Device ms and launches per unit under each phase scope that ran,
    from the profile's trace: every kernel, copy or fill whose launch
    (the CUDA runtime or driver call, matched to it by its correlation
    id) lies inside one of the scope's host-side ranges.  The kernels of
    the ctypes launchers belong to no PyTorch op, so the annotations'
    own ``device_time_total`` misses them."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        trace = json.loads(path.read_text())
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    ranges, calls, device_us = {}, [], {}
    for e in events:
        cat, args = e.get("cat", ""), e.get("args") or {}
        if e.get("ph") != "X":
            continue
        if cat == "user_annotation" and e.get("name") in SCOPES:
            ranges.setdefault(e["name"], []).append(
                (e.get("tid"), e["ts"], e["ts"] + e.get("dur", 0.0)))
        elif cat in ("cuda_runtime", "cuda_driver") and "correlation" in args:
            calls.append((e.get("tid"), e["ts"], args["correlation"]))
        elif cat in ("kernel", "gpu_memcpy", "gpu_memset") \
                and "correlation" in args:
            c = args["correlation"]
            device_us[c] = device_us.get(c, 0.0) + e.get("dur", 0.0)
    out = {}
    for name, spans in ranges.items():
        us, n = 0.0, 0
        for tid, t0, t1 in spans:
            for ctid, ts, corr in calls:
                if ctid == tid and t0 <= ts <= t1 and corr in device_us:
                    us += device_us[corr]
                    n += 1
        out[name] = dict(ms=us / 1e3 / units, launches=n / units)
    return {name: out[name] for name in SCOPES if name in out}


def print_profile(label: str, row: dict, unit: str = "step") -> None:
    print(f"[profile] {label}: {row['wall_ms_per_step']:.4f} ms/{unit} "
          f"wall, device busy {row['device_busy_ms_per_step']:.4f} "
          f"ms/{unit}, idle share {row['idle_share']:.4f}, "
          f"{row['kernel_launches_per_step']:.1f} kernel launches/{unit}")
    for name, ms in row["top_kernels"]:
        print(f"[profile] {label}:   {ms:.5f} ms/{unit}  {name}")
    for name, sc in row.get("scopes", {}).items():
        print(f"[profile] {label}:   scope {name}: {sc['ms']:.5f} ms/{unit} "
              f"device, {sc['launches']:.1f} launches/{unit}")


def profile_phase(paths: Paths, device, blocks: int = 4) -> dict:
    """Where a block's time goes: torch.profiler over ``blocks`` blocks of
    each path (after one warm-up block), per step; the feedforward path
    again with telemetry on; and 8 steps of the resilient path on the
    survivors of both failures."""
    from repro_torch.kernels import common as kc
    from repro_torch.core import resilience as rsl

    net = paths.net
    out = {}
    runs = list(paths.runs())
    ff = next(r for r in runs if r[0] == "feedforward")
    runs.append(("feedforward+telemetry",
                 dataclasses.replace(ff[1], telemetry=True)) + ff[2:])
    for label, cfg, params, ext, _, plastic in runs:
        b = cfg.comm.superstep if cfg.comm_mode == "event" else 8
        n_blocks = min(blocks, ext.shape[0] // b - 1)
        state = net.init_state(cfg, params, device=device)
        state, _, params = paths.drive(cfg, params, state, ext[:b], plastic)
        torch.cuda.synchronize()

        def window(cfg=cfg, params=params, state=state, ext=ext, b=b,
                   n_blocks=n_blocks, plastic=plastic):
            t_start = time.perf_counter()
            # A pipelined run is one call (its stages, then one flush);
            # the others take a call per block.
            for i, j in ([(1, n_blocks + 1)] if cfg.pipeline else
                         [(i, i + 1) for i in range(1, n_blocks + 1)]):
                state, _, params = paths.drive(cfg, params, state,
                                               ext[i * b:j * b], plastic)
            torch.cuda.synchronize()
            return time.perf_counter() - t_start

        prof, wall = kc.profiled(window, f"profile of {label}")
        out[label] = profile_row(prof, wall, n_blocks * b)
        print_profile(label, out[label])

    cfg = paths.resilient_cfg
    survivors = tuple(i for i in range(cfg.comm.n_chips)
                      if i not in (7, 30))
    injector = rsl.FabricFaultInjector(n_chips=cfg.comm.n_chips,
                                       chip_failures=RESILIENT_FAILURES)
    step_fn = drill_fns(net, cfg, paths.ff_params, injector, paths.ff_ext,
                        device)[0](survivors)
    state = net.init_state(cfg, paths.ff_params, device=device)
    state, _ = step_fn(state, 23)
    torch.cuda.synchronize()

    def window(state=state):
        t_start = time.perf_counter()
        for t in range(24, 32):
            state, _ = step_fn(state, t)
        torch.cuda.synchronize()
        return time.perf_counter() - t_start

    prof, wall = kc.profiled(window, "profile of resilient")
    out["resilient"] = profile_row(prof, wall, 8)
    print_profile("resilient (44 survivors)", out["resilient"])
    return out


# The serve-checks, (arch, layers) at full width in float32: zamba2's one
# pattern repeat (five Mamba-2 blocks, then the shared attention+MLP block
# and a sixth), 4 of falcon-mamba's Mamba-1 blocks with its published A
# (the scan's general route), and 2 of granite-moe's attention+MoE blocks
# (32 experts, top-8, its own capacity factor), the routing compared
# first; whisper-medium with 2 encoder and 2 decoder layers (the prompt
# is its frame count, the decoder starts from 8 tokens).
SERVE_CHECKS = (("zamba2-2.7b", 6), ("falcon-mamba-7b", 4),
                ("granite-moe-1b-a400m", 2), ("whisper-medium", 2),
                ("llama3-8b", 2), ("yi-9b", 2), ("mistral-nemo-12b", 2),
                ("chameleon-34b", 2))


# zamba2's long-context path in the serve-check: 6 layers (one shared
# attention), "ssd" with chunks of 64, window 128 (below the 300-token
# prompt, so that it bites), one decode step.
LONG_SERVE_CHECK = dict(arch="zamba2-2.7b", layers=6, steps=1, window=128,
                        replace=dict(ssm_impl="ssd", ssd_chunk=64))


def serve_check(device, seed: int, prompt: int = 300,
                steps: int = 8) -> dict:
    """Each of ``SERVE_CHECKS``, then ``LONG_SERVE_CHECK``
    (:func:`serve_check_one`); returns their rows by arch and their card
    runs' launches, summed."""
    rows, launches = {}, {}
    runs = [dict(arch=a, layers=n, steps=steps) for a, n in SERVE_CHECKS]
    for run in runs + [LONG_SERVE_CHECK]:
        row = serve_check_one(device, seed, prompt=prompt, **run)
        for k, v in row.pop("launches").items():
            launches[k] = launches.get(k, 0) + v
        rows[row.pop("label")] = row
    return dict(rows=rows, launches=launches)


def serve_check_one(device, seed: int, arch: str, layers: int, prompt: int,
                    steps: int, window: int = 0,
                    replace: dict | None = None) -> dict:
    """``arch`` at full width, ``layers`` layers, float32, batch 1:
    prefill and ``steps`` teacher-forced decode steps on the card
    (kernels) and on the CPU (plain versions) from the same weights and
    tokens (a Mamba-1 arch with :func:`set_general_a`), with the config's
    fields ``replace`` and the sliding ``window`` (prefill and decode)
    where given.  An MoE arch's routing (every layer, prefill and decode)
    must equal the CPU's bitwise (:func:`routing_check`).  Every step's
    logits agree within 1e-3 of the largest |logit| (f32 sums in another
    order through every layer); the prefill launches ssm_scan (or
    ssd_chunked on the "ssd" route) once a Mamba layer and
    flash_attention :func:`flash_calls` times.  An encoder-decoder runs
    ``layers`` encoder and decoder layers, ``prompt`` random frames and
    8 prompt tokens."""
    from repro_torch import configs as C
    from repro_torch.kernels import common as kc
    from repro_torch.models import lm
    from repro_torch.models import spec as sp
    from repro_torch.models import ssm

    cfg = dataclasses.replace(C.get(arch), n_layers=layers, dtype="float32",
                              **(replace or {}))
    if cfg.is_encdec:
        cfg = dataclasses.replace(cfg, encoder_layers=layers)
    params = lm.init(torch.Generator().manual_seed(seed), cfg, device="cpu")
    if is_mamba1(cfg):
        set_general_a(params)
    rng = np.random.default_rng(seed)
    frames = None
    if cfg.is_encdec:
        frames = torch.as_tensor(rng.standard_normal(
            (1, prompt, cfg.d_model)).astype(np.float32))
        prompt = 8
    tokens = torch.as_tensor(rng.integers(
        0, cfg.vocab_size, (1, prompt + steps)).astype(np.int32))

    def run(dev):
        p = sp.tree_map(lambda x: x.to(dev), params)
        tk = tokens.to(dev)
        batch = {"tokens": tk[:, :prompt]}
        if frames is not None:
            batch["frames"] = frames.to(dev)
        torch.cuda.synchronize()
        kc.reset_launches()
        routes = []
        t_start = time.perf_counter()
        with torch.no_grad(), moe_routings(routes):
            last, cache = lm.prefill(cfg, p, batch, window=window)
            cache = lm.pad_cache(cfg, cache, prompt + steps)
            rows = [last]
            for i in range(steps):
                lg, cache = lm.decode(cfg, p, tk[:, prompt + i], cache,
                                      prompt + i, window=window)
                rows.append(lg)
        logits = torch.cat(rows).float().cpu()
        return (logits, time.perf_counter() - t_start, dict(kc.launches),
                routes)

    (gpu, t_gpu, counts, r_gpu), (cpu, t_cpu, _, r_cpu) = (
        run(dev) for dev in (device, torch.device("cpu")))
    del params
    gap = None
    if cfg.n_experts:
        gap = routing_check(f"serve-check {arch}", r_gpu, r_cpu)
    mamba = layers if cfg.ssm_state else 0
    ssd = ssm.uses_ssd(cfg)
    if (counts["flash_attention"], counts["ssm_scan"],
            counts["ssd_chunked"]) != (flash_calls(cfg), 0 if ssd else mamba,
                                       mamba if ssd else 0):
        raise AssertionError(f"serve-check {arch}: launches {counts}")
    scale = float(cpu.abs().max())
    err = (gpu - cpu).abs().amax(dim=-1)
    agree = int((gpu.argmax(-1) == cpu.argmax(-1)).sum())
    what = (f"{layers} + {layers} layers, f32, batch 1, {frames.shape[1]} "
            f"frames, prompt {prompt}" if cfg.is_encdec else
            f"{layers} layers, f32, batch 1, prompt {prompt}")
    label = arch
    if replace or window:
        label += "".join(f", {k} {v}" for k, v in (replace or {}).items()) \
            + (f", window {window}" if window else "")
    print(f"[serve-check] {label} full width, {what}, {steps} teacher-forced "
          f"steps: card "
          f"{t_gpu:.2f} s, CPU {t_cpu:.2f} s; max |dlogit| per step "
          f"{[float(f'{e:.3g}') for e in err]} vs max |logit| "
          f"{scale:.4g} (rel {float(err.max()) / scale:.3g}); greedy tokens "
          f"equal {agree}/{steps + 1}; launches flash_attention "
          f"{counts['flash_attention']}, ssm_scan {counts['ssm_scan']}, "
          f"ssd_chunked {counts['ssd_chunked']}")
    if not bool(torch.isfinite(gpu).all()) or float(err.max()) > 1e-3 * scale:
        raise AssertionError(f"serve-check {label}: the card's logits differ "
                             f"from the CPU's beyond 1e-3 of the largest "
                             f"|logit|")
    return dict(label=label, max_rel_err=float(err.max()) / scale,
                greedy_equal=agree, steps=steps + 1, launches=counts,
                moe_smallest_gap=gap)


# (arch, flash_attention launches, ssm_scan launches) a prefill, at full
# width and depth through ``launch.serve.main``; then llama4-maverick at
# full width on one repeat of its pattern (a dense and an MoE layer of 128
# experts: the whole model does not fit one card), through
# ``launch.serve.serve``.
SERVE_RUNS = (("zamba2-2.7b", 9, 54), ("internlm2-1.8b", 24, 0),
              ("falcon-mamba-7b", 0, 64), ("granite-moe-1b-a400m", 24, 0),
              ("whisper-medium", 72, 0), ("llama3-8b", 32, 0),
              ("yi-9b", 48, 0), ("mistral-nemo-12b", 40, 0),
              ("chameleon-34b", 48, 0))
ONE_REPEAT = (("llama4-maverick-400b-a17b", 2, 0),)
# The capacity factor of an MoE model's consistency check: capacity
# depends on the tokens of a call (a prefill's S, a forward's S + 1, a
# decode step's B), so at the config's own factor the three would drop
# other lanes; at 8, as the reference's own test runs it, none drops.
MOE_CONSISTENCY_CF = 8.0
# An encoder-decoder's prompt is its frame count, whisper's 30-second
# window (the decoder starts from 8 tokens, as the reference serves it).
SERVE_ARGS = dict(batch=4, prompt=2048, gen=32, frames=1500)


def serve_phase(device, seed: int) -> tuple[dict, dict, dict]:
    """``launch.serve.main`` at full width and depth on each serve arch,
    then, from the same weights, prefill + one decode step against a full
    forward at the next position, and a profile of one prefill and of 4
    decode steps.  ``serve.main`` draws the reference's init, whose
    Mamba-1 A has constant rows; the consistency check and the profile
    run falcon-mamba with :func:`set_general_a`; an MoE arch's runs the
    consistency at ``MOE_CONSISTENCY_CF`` and first prints a prefill's
    routing metrics at the config's own capacity factor.  The serve
    run's counts are one prefill's: the decode loop is plain torch and
    launches none of the port's kernels.  whisper-medium serves 1500
    frames and 8 prompt tokens: its prefill launches flash_attention 72
    times (24 encoder, 24 decoder self- and 24 cross-attentions), and its
    frames per second are printed beside the reference's tok/s line,
    which counts the 8 tokens.  ``ONE_REPEAT``'s archs serve one repeat
    of their layer pattern at full width through ``serve.serve``.  Only
    one model's weights are alive at a time.  Returns (launches, metrics,
    profile) by path."""
    import io
    import re

    from repro_torch import configs as C
    from repro_torch.kernels import common as kc
    from repro_torch.launch import serve
    from repro_torch.models import lm, moe
    from repro_torch.models import transformer as tfm

    b, n_gen = SERVE_ARGS["batch"], SERVE_ARGS["gen"]
    counts, metrics, profile = {}, {}, {}
    runs = [(a, f, n, False) for a, f, n in SERVE_RUNS] + [
        (a, f, n, True) for a, f, n in ONE_REPEAT]
    for arch, n_flash, n_scan, one_repeat in runs:
        cfg = C.get(arch)
        label = f"serve {arch}"
        if one_repeat:
            cfg = dataclasses.replace(cfg, n_layers=cfg.pattern_period())
            label += ", one repeat"
        s = SERVE_ARGS["frames" if cfg.is_encdec else "prompt"]
        n_prompt = 8 if cfg.is_encdec else s
        argv = ["--arch", arch, "--batch", str(b), "--prompt-len", str(s),
                "--gen", str(n_gen), "--seed", str(seed)]
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        kc.reset_launches()
        buf = io.StringIO()
        t_start = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            ids = (serve.serve(cfg, serve.parse_args(argv)) if one_repeat
                   else serve.main(argv))
        wall = time.perf_counter() - t_start
        counts[label] = dict(kc.launches)
        peak = torch.cuda.max_memory_allocated()
        text = buf.getvalue()
        for line in text.splitlines():
            print(f"[{label}] {line}")
        pre_ms = float(re.search(r"prefill: \S+ in ([\d.]+) ms", text)[1])
        dec_ms = float(re.search(r"decode: .* in ([\d.]+) ms", text)[1])
        row = dict(prefill_ms=pre_ms,
                   prefill_tok_s=b * n_prompt / pre_ms * 1e3,
                   decode_ms=dec_ms, decode_tok_s=b * n_gen / dec_ms * 1e3,
                   peak_bytes=peak, wall_s=wall)
        what = f"{cfg.n_layers} layers, d_model {cfg.d_model}, " \
            f"{cfg.n_heads} heads over {cfg.n_kv_heads}, vocabulary " \
            f"{cfg.vocab_size}, bf16, batch {b}, prompt {s}"
        if cfg.is_encdec:
            row["prefill_frames_s"] = b * s / pre_ms * 1e3
            what = (f"{cfg.encoder_layers} encoder + {cfg.n_layers} decoder "
                    f"layers, d_model {cfg.d_model}, bf16, batch {b}, {s} "
                    f"frames ({row['prefill_frames_s']:.1f} frames/s in the "
                    f"prefill), prompt {n_prompt}")
        print(f"[{label}] {what}, {n_gen} tokens: prefill "
              f"{row['prefill_tok_s']:.1f} tok/s, decode "
              f"{row['decode_tok_s']:.2f} tok/s, peak memory {peak} B "
              f"({peak / 2**30:.2f} GiB), {wall:.1f} s in all; launches a "
              f"prefill: flash_attention {counts[label]['flash_attention']}, "
              f"ssm_scan {counts[label]['ssm_scan']}; a decode step: none "
              f"of the port's kernels")
        if (counts[label]["flash_attention"] != n_flash
                or counts[label]["ssm_scan"] != n_scan):
            raise AssertionError(f"{label}: prefill launched "
                                 f"{counts[label]}, expected flash_attention "
                                 f"{n_flash} and ssm_scan {n_scan}")
        if tuple(ids.shape) != (b, n_gen) or not bool(
                ((ids >= 0) & (ids < cfg.vocab_size)).all()):
            raise AssertionError(f"{label}: generated ids {ids.shape}")
        del ids
        # Same weights as serve.main drew (same generator and seed); its
        # own copy is gone with the call, so one model's weights are
        # alive at a time (chameleon-34b's take 63.9 GiB).
        torch.cuda.empty_cache()
        params = lm.init(torch.Generator(device=device).manual_seed(seed),
                         cfg, device=device)
        if is_mamba1(cfg):
            set_general_a(params)
            print(f"[{label}] consistency and profile with Mamba-1's "
                  f"published A (A[d, n] = -(n + 1)): no layer's A has a "
                  f"constant row")
        draw = torch.Generator(device=device).manual_seed(seed + 1)
        frames = None
        if cfg.is_encdec:
            frames = torch.randn((b, s, cfg.d_model), device=device,
                                 generator=draw)
        tokens = torch.randint(
            0, cfg.vocab_size, (b, n_prompt + 1), device=device,
            dtype=torch.int32, generator=draw)
        check_cfg = cfg
        if cfg.n_experts:
            with torch.no_grad():
                m = tfm.forward(cfg, params, tokens[:, :s]).metrics
            row.update({k: float(v) for k, v in m.items()},
                       capacity=moe.capacity(cfg, b * s))
            print(f"[{label}] a prefill's MoE routing at capacity factor "
                  f"{cfg.capacity_factor} ({row['capacity']} slots an "
                  f"expert for {b * s} tokens x top-{cfg.top_k}): "
                  f"drop_fraction {row['drop_fraction']:.6f}, "
                  f"bucket_utilization {row['bucket_utilization']:.6f}, "
                  f"aux_loss {row['aux_loss']:.6f} (averaged over "
                  f"{tfm.n_repeats(cfg)} repeats of the layer pattern, "
                  f"{cfg.n_layers} layers); the consistency check runs at "
                  f"capacity factor {MOE_CONSISTENCY_CF}, where no lane "
                  f"drops")
            check_cfg = dataclasses.replace(
                cfg, capacity_factor=MOE_CONSISTENCY_CF)
        consistency(label, check_cfg, params, tokens, frames)
        profile.update(serve_profile(label, cfg, params, tokens[:, :n_prompt],
                                     frames))
        metrics[label] = row
        if arch == "zamba2-2.7b":
            long_counts, long_rows = long_context(device, seed, cfg, params)
            counts.update(long_counts)
            metrics.update(long_rows)
        del params
        print(f"[time] {label}: {time.perf_counter() - t_start:.1f} s with "
              f"its checks and profile")
    return counts, metrics, profile


def long_context(device, seed: int, cfg, params) -> tuple[dict, dict]:
    """zamba2's long-context serving path on the serve run's weights, bf16,
    54 layers, ``ssm_impl="ssd"`` with chunks of ``SSD_CHUNK`` and the
    window ``LONG_WINDOW`` (the config's own):
    (a) ``lm.prefill(window=)`` on 1 x ``LONG_PROMPT`` tokens (prefill_32k
        at batch 1), the cache padded by ``LONG_GEN`` slots, then
        ``LONG_GEN`` greedy steps of ``transformer.decode_step(window=)``;
        the timed prefill (after one warm-up) must launch ssd_chunked once
        a Mamba layer (54), flash_attention once an attention application
        (9) and ssm_scan never;
    (b) the long_500k ring: a windowed prefill of ``LONG_WINDOW`` tokens
        is the ring of ``lm.cache_len_for(cfg, SHAPES["long_500k"])``
        slots at position ``LONG_WINDOW``; ``LONG_GEN`` decode steps wrap
        it from the first (slot pos % window);
    (c) the "ssd" and "scan" routes at the serve shape (4 x 2048) in
        turns (scan, ssd, ssd, scan, after a warm-up of each): prefill
        tok/s of each and their ratio, and the largest |logit| gap
        between them (printed: two bf16 routes through 54 random layers).
    Logits must be finite and ids in range.  Returns (launches, metrics)
    by step."""
    from repro_torch import configs as C
    from repro_torch.kernels import common as kc
    from repro_torch.models import lm
    from repro_torch.models import transformer as tfm

    ssd = dataclasses.replace(cfg, ssm_impl="ssd", ssd_chunk=SSD_CHUNK)
    w = cfg.window
    if w != LONG_WINDOW:
        raise AssertionError(f"{cfg.name}: window {w}, not {LONG_WINDOW}")
    draw = torch.Generator(device=device).manual_seed(seed + 2)
    counts, rows = {}, {}

    def finite(label, x):
        if not bool(torch.isfinite(x.float()).all()):
            raise AssertionError(f"{label}: non-finite logits")

    def prefill(c, tokens, window):
        torch.cuda.synchronize()
        kc.reset_launches()
        t_start = time.perf_counter()
        last, cache = lm.prefill(c, params, {"tokens": tokens}, window=window)
        torch.cuda.synchronize()
        return time.perf_counter() - t_start, last, cache, dict(kc.launches)

    def greedy(label, last, cache, pos):
        tok, ids = last.argmax(-1).to(torch.int32), []
        torch.cuda.synchronize()
        t_start = time.perf_counter()
        for i in range(LONG_GEN):
            lg, cache = tfm.decode_step(ssd, params, tok, cache, pos + i,
                                        window=w)
            tok = lg.argmax(-1).to(torch.int32)
            ids.append(tok)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_start
        finite(label, lg)
        ids = torch.stack(ids)
        if not bool(((ids >= 0) & (ids < cfg.vocab_size)).all()):
            raise AssertionError(f"{label}: generated ids out of range")
        return wall, cache

    def launches_ok(label, got, scan, ssd_n):
        want = (cfg.attn_layers, scan, ssd_n)
        have = (got["flash_attention"], got["ssm_scan"], got["ssd_chunked"])
        if have != want:
            raise AssertionError(f"{label}: a prefill launched flash, scan, "
                                 f"ssd {have}, not {want}")

    with torch.no_grad():
        # (a) prefill_32k at batch 1, windowed, then 32 windowed steps.
        label = "long-context 32k"
        tokens = torch.randint(0, cfg.vocab_size, (1, LONG_PROMPT),
                               device=device, dtype=torch.int32,
                               generator=draw)
        prefill(ssd, tokens, w)   # warm-up: the timed call is the next
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        pre, last, cache, got = prefill(ssd, tokens, w)
        counts[label] = got
        launches_ok(label, got, 0, cfg.n_layers)
        finite(label, last)
        cache = lm.pad_cache(ssd, cache, LONG_PROMPT + LONG_GEN)
        dec, cache = greedy(label, last, cache, LONG_PROMPT)
        peak = torch.cuda.max_memory_allocated()
        del cache, last
        rows[label] = dict(prefill_s=pre, prefill_tok_s=LONG_PROMPT / pre,
                           decode_s=dec, decode_tok_s=LONG_GEN / dec,
                           peak_bytes=peak)
        print(f"[{label}] {cfg.name} {cfg.n_layers} layers {cfg.dtype}, ssd "
              f"chunk {SSD_CHUNK}, window {w}, batch 1, prompt {LONG_PROMPT}: "
              f"prefill {pre * 1e3:.1f} ms ({LONG_PROMPT / pre:.1f} tok/s), "
              f"{LONG_GEN} decode steps over {LONG_PROMPT + LONG_GEN} slots "
              f"{dec * 1e3:.1f} ms ({LONG_GEN / dec:.2f} tok/s), peak memory "
              f"{peak} B ({peak / 2**30:.2f} GiB); launches a prefill: "
              f"ssd_chunked {got['ssd_chunked']}, flash_attention "
              f"{got['flash_attention']}, ssm_scan {got['ssm_scan']}")
        # (b) the long_500k ring.
        label = "long-context ring"
        slots = lm.cache_len_for(cfg, C.SHAPES["long_500k"])
        if slots != w:
            raise AssertionError(f"{label}: {slots} slots, not {w}")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _, last, cache, got = prefill(ssd, tokens[:, :slots], w)
        counts[label] = got
        launches_ok(label, got, 0, cfg.n_layers)
        kv = cache[f"pos{cfg.pattern_period() - 1}"]["kv"]
        if kv.k.shape[-2] != slots:
            raise AssertionError(f"{label}: cache of {kv.k.shape[-2]} slots")
        first = kv.k[..., 0, :].clone()
        dec, cache = greedy(label, last, cache, slots)
        if torch.equal(kv.k[..., 0, :], first):
            raise AssertionError(f"{label}: the first step did not write "
                                 f"slot 0 of the ring")
        peak = torch.cuda.max_memory_allocated()
        del cache, last, kv, first
        rows[label] = dict(decode_s=dec, decode_tok_s=LONG_GEN / dec,
                           peak_bytes=peak, slots=slots)
        print(f"[{label}] {cfg.name}: a windowed prefill of {slots} tokens "
              f"fills the long_500k ring of {slots} slots; {LONG_GEN} decode "
              f"steps from position {slots} wrap it (slot pos % {slots}): "
              f"{dec * 1e3:.1f} ms ({LONG_GEN / dec:.2f} tok/s), peak memory "
              f"{peak} B ({peak / 2**30:.2f} GiB)")
        del tokens
        # (c) the two routes at the serve shape, in turns.
        label = "long-context routes"
        b, s = SERVE_ARGS["batch"], SERVE_ARGS["prompt"]
        tokens = torch.randint(0, cfg.vocab_size, (b, s), device=device,
                               dtype=torch.int32, generator=draw)
        routes = {"scan": cfg, "ssd": ssd}
        outs, times = {}, {"scan": [], "ssd": []}
        for name in ("scan", "ssd"):
            _, outs[name], _, got = prefill(routes[name], tokens, 0)
            counts[f"{label} {name}"] = got
            launches_ok(f"{label} {name}", got,
                        0 if name == "ssd" else cfg.n_layers,
                        cfg.n_layers if name == "ssd" else 0)
            finite(f"{label} {name}", outs[name])
        for name in ("scan", "ssd", "ssd", "scan"):
            times[name].append(prefill(routes[name], tokens, 0)[0])
        torch.cuda.empty_cache()
        tok_s = {k: b * s / (sum(v) / len(v)) for k, v in times.items()}
        ms = {k: [round(x * 1e3, 1) for x in v] for k, v in times.items()}
        gap = float((outs["ssd"].float() - outs["scan"].float()).abs().max())
        top = float(outs["scan"].float().abs().max())
        rows[label] = dict(prefill_tok_s=tok_s, prefill_s=times,
                           ssd_over_scan=tok_s["ssd"] / tok_s["scan"],
                           logit_gap=gap, max_logit=top)
        print(f"[{label}] {cfg.name} {cfg.dtype}, batch {b}, prompt {s}, "
              f"prefill in turns (scan, ssd, ssd, scan): scan "
              f"{tok_s['scan']:.1f} tok/s {ms['scan']} ms, ssd (chunk "
              f"{SSD_CHUNK}) {tok_s['ssd']:.1f} tok/s {ms['ssd']} ms: "
              f"ssd/scan {tok_s['ssd'] / tok_s['scan']:.3f}; last-token "
              f"logits of "
              f"the two routes {gap:.4g} apart (max |logit| {top:.4g}: two "
              f"{cfg.dtype} routes through {cfg.n_layers} random layers)")
    return counts, rows


def model_batch(tokens, frames=None) -> dict:
    """A prefill's batch: the tokens, and an encoder-decoder's frames."""
    return {"tokens": tokens} if frames is None else {"tokens": tokens,
                                                      "frames": frames}


def next_token_logits(cfg, params, tokens, frames=None):
    """A full forward's logits at the last two positions S - 1 and S,
    and those of prefill over the first S tokens and one decode step with
    the last token, float32 on the card (an encoder-decoder's over
    ``frames``)."""
    from repro_torch.models import lm
    from repro_torch.models import transformer as tfm
    from repro_torch.models import whisper as wsp

    s = tokens.shape[1] - 1
    f32 = dict(dtype=torch.float32, copy=True)  # no view keeps [B, S, V]
    with torch.no_grad():
        full = (tfm.forward(cfg, params, tokens) if frames is None
                else wsp.forward(cfg, params, frames, tokens))
        full = full.logits[:, s - 1:].to(**f32)
        last, cache = lm.prefill(cfg, params,
                                 model_batch(tokens[:, :s], frames))
        last = last.to(**f32)
        cache = lm.pad_cache(cfg, cache, s + 1)
        dec, _ = lm.decode(cfg, params, tokens[:, s], cache, s)
        del cache
    for name, x in (("forward", full), ("prefill", last), ("decode", dec)):
        if not bool(torch.isfinite(x).all()):
            raise AssertionError(f"{cfg.name}: non-finite {name} logits")
    return full, last, dec.float()


def f32_repeats(cfg, params, rows: int, seq: int) -> int:
    """How many repeats of ``cfg``'s layer pattern a float32 copy of
    ``params`` may hold beside them on the card: all, or as many as the
    free memory leaves room for after the unstacked leaves (embedding,
    head) in float32 and a margin for a forward over ``rows`` x ``seq``
    tokens (its float32 logits twice, and 4 GiB)."""
    from repro_torch.models import spec as sp
    from repro_torch.models import transformer as tfm

    torch.cuda.empty_cache()
    free = torch.cuda.mem_get_info()[0]
    stacked = sum(x.numel() for x in sp.tree_leaves(params["blocks"]))
    rest = sum(x.numel() for x in sp.tree_leaves(params)) - stacked
    repeats = tfm.n_repeats(cfg)
    margin = 2 * rows * seq * cfg.vocab_size * 4 + 4 * 2**30
    room = (free - margin - 4 * rest) // max(4 * stacked // repeats, 1)
    return int(max(0, min(repeats, room)))


def consistency(label: str, cfg, params, tokens, frames=None) -> None:
    """Prefill + one decode step against a full forward at positions S - 1
    and S, as ``tests/test_models_smoke.py`` checks the JAX model: in
    float32 (the bf16 weights widened, exactly) within 1e-3 of the largest
    |logit| (sums in another order through every layer); in the serving
    type, bf16, within 0.1 of the largest |logit| or within the distance
    of the bf16 forward from the float32 forward at position S, whichever
    is larger.  Where a float32 copy of the whole model does not fit
    beside it at full batch (:func:`f32_repeats`: mistral-nemo-12b,
    chameleon-34b), the float32 half runs on the first row of the batch
    and on the first repeats that fit (the drift then from that row); cut
    in depth, the bf16 half is held within 0.1 of its own largest
    |logit|; where not one repeat fits (llama4-maverick's MoE repeat is
    74 GB in float32), the bf16 half alone runs, and the line says so.
    With random weights a deep model can amplify bf16 rounding to
    differences of the order of the logits themselves (54-layer zamba2 on
    an H100 80GB HBM3 at 700 W: 1.05 x max |logit| between the bf16 and
    the float32 forward at the next position): two bf16 paths that round
    at other places (cuBLAS picks other kernels for 4 rows than for 8192;
    decode attends from the bf16 cache in f32 and steps the SSM state in
    f32) cannot be held closer to each other than either is to the exact
    function."""
    from repro_torch.models import spec as sp
    from repro_torch.models import transformer as tfm

    f16, l16, d16 = next_token_logits(cfg, params, tokens, frames)
    err = lambda a, b: float((a - b).abs().max())  # noqa: E731
    agree = lambda a, b: int((a.argmax(-1) == b.argmax(-1)).sum())  # noqa: E731
    e16 = max(err(l16, f16[:, 0]), err(d16, f16[:, 1]))
    rows, seq = tokens.shape
    repeats = tfm.n_repeats(cfg) if frames is None else 1
    n, fit = rows, repeats
    if frames is None and f32_repeats(cfg, params, rows, seq) < repeats:
        n, fit = 1, f32_repeats(cfg, params, 1, seq)
    drift = None
    scale = float(f16.abs().max())
    if fit == 0:
        print(f"[{label}] consistency with a full forward, bf16 only (a "
              f"float32 copy of one repeat does not fit beside the bf16 "
              f"weights), max |logit| {scale:.4g}: bf16 prefill "
              f"{err(l16, f16[:, 0]):.4g}, decode {err(d16, f16[:, 1]):.4g} "
              f"(rel {e16 / scale:.3g}); argmax equal: bf16 decode/forward "
              f"{agree(d16, f16[:, 1])}/{rows}")
    else:
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        p32 = params
        if fit < repeats:
            cfg32 = dataclasses.replace(
                cfg32, n_layers=fit * cfg.pattern_period())
            p32 = dict(params, blocks=sp.tree_map(lambda x: x[:fit],
                                                  params["blocks"]))
        p32 = sp.tree_map(lambda x: x.float(), p32)
        f32, l32, d32 = next_token_logits(cfg32, p32, tokens[:n],
                                          None if frames is None
                                          else frames[:n])
        del p32
        torch.cuda.empty_cache()
        top32 = float(f32.abs().max())
        e32 = max(err(l32, f32[:, 0]), err(d32, f32[:, 1]))
        cut = ([f"the first {cfg32.n_layers} of {cfg.n_layers} layers"]
               if fit < repeats else []) + (
                   [f"{n} of {rows} rows"] if n < rows else [])
        where = "" if not cut else (
            f" (float32 on {' and '.join(cut)}: a float32 copy of the "
            f"whole model does not fit beside it at full batch)")
        if fit == repeats:
            scale = top32
            drift = err(f16[:n, 1], f32[:, 1])
            tail = (f"; bf16 forward vs float32 forward {drift:.4g} (rel "
                    f"{drift / scale:.3g}); argmax equal: bf16 "
                    f"decode/forward {agree(d16, f16[:, 1])}/{rows}, float32 "
                    f"{agree(d32, f32[:, 1])}/{n}, bf16/float32 forward "
                    f"{agree(f16[:n, 1], f32[:, 1])}/{n}")
        else:
            tail = (f"; bf16 max |logit| {scale:.4g}; argmax equal: bf16 "
                    f"decode/forward {agree(d16, f16[:, 1])}/{rows}, float32 "
                    f"{agree(d32, f32[:, 1])}/{n}")
        print(f"[{label}] consistency with a full forward{where}, max "
              f"|logit| {top32:.4g}: float32 prefill "
              f"{err(l32, f32[:, 0]):.4g}, decode {err(d32, f32[:, 1]):.4g} "
              f"(rel {e32 / top32:.3g}); bf16 prefill "
              f"{err(l16, f16[:, 0]):.4g}, decode {err(d16, f16[:, 1]):.4g} "
              f"(rel {e16 / scale:.3g})" + tail)
        if e32 > 1e-3 * top32:
            raise AssertionError(f"{label}: float32 prefill/decode differ "
                                 f"from the full forward beyond 1e-3 of max "
                                 f"|logit|")
    if drift is None and e16 > 0.1 * scale:
        raise AssertionError(f"{label}: bf16 prefill/decode differ from the "
                             f"bf16 forward beyond 0.1 of max |logit|")
    if drift is not None and e16 > max(0.1 * scale, drift):
        raise AssertionError(f"{label}: bf16 prefill/decode differ from the "
                             f"bf16 forward beyond both 0.1 of max |logit| "
                             f"and the bf16 forward's distance from float32")


def serve_profile(label: str, cfg, params, tokens, frames=None,
                  steps: int = 4) -> dict:
    """torch.profiler over one prefill, then over ``steps`` decode steps
    (after one warm-up step); an encoder-decoder's prefill over
    ``frames``."""
    from repro_torch.kernels import common as kc
    from repro_torch.models import lm

    s = tokens.shape[1]
    out = {}
    def prefill():
        t_start = time.perf_counter()
        logits, cache = lm.prefill(cfg, params, model_batch(tokens, frames))
        torch.cuda.synchronize()
        return time.perf_counter() - t_start, logits, cache

    with torch.no_grad():
        torch.cuda.synchronize()
        prof, (wall, logits, cache) = kc.profiled(prefill,
                                               f"profile of {label} prefill")
        out[f"{label} prefill"] = profile_row(prof, wall, 1)
        cache = lm.pad_cache(cfg, cache, s + steps + 1)
        tok = logits.argmax(-1).to(torch.int32)
        logits, cache = lm.decode(cfg, params, tok, cache, s)
        torch.cuda.synchronize()

        def decode(logits=logits, cache=cache):
            t_start = time.perf_counter()
            for i in range(steps):
                tok = logits.argmax(-1).to(torch.int32)
                logits, cache = lm.decode(cfg, params, tok, cache, s + 1 + i)
            torch.cuda.synchronize()
            return time.perf_counter() - t_start

        prof, wall = kc.profiled(decode, f"profile of {label} decode")
        out[f"{label} decode"] = profile_row(prof, wall, steps)
    print_profile(f"{label} prefill", out[f"{label} prefill"], "prefill")
    print_profile(f"{label} decode", out[f"{label} decode"], "decode step")
    return out


# mistral-nemo-12b trains at full width on 4 of its 40 layers (2.43e9
# parameters).  AdamW's update holds the old and the new state at once,
# about 22 bytes a parameter with the gradients, and float32 temporaries
# of each leaf (2.7 GB apiece for the [131072, 5120] embedding and head).
# On an H100 80GB HBM3 (700 W), 12 layers ran out of memory in the update
# and 6 layers peaked at 72.64 GiB in their steps, then ran out of memory
# in the profiled step.  Full depth of any of the four dense archs does
# not fit one card (llama3-8b: 8.03e9 x 22 B).
MISTRAL_TRAIN_LAYERS = 4
# The training path's runs: internlm2-1.8b with one checkpoint of the
# whole state, then zamba2-2.7b, falcon-mamba-7b and granite-moe-1b-a400m
# (no checkpoint write, to stay in time).  falcon-mamba trains at full width on 16 of its 64
# layers: at full depth its float32 AdamW moments alone take 58 GB.
# whisper-medium takes the reference's training layout: ``seq`` frames
# for the encoder (1500, whisper's own count) and max_target_len (448)
# decoder tokens; its tok/s counts the frames, as the reference does.
TRAIN_RUNS = (dict(arch="internlm2-1.8b", batch=4, seq=512, steps=4,
                   ckpt=True),
              dict(arch="zamba2-2.7b", batch=4, seq=512, steps=3,
                   ckpt=False),
              dict(arch="falcon-mamba-7b", batch=4, seq=512, steps=3,
                   ckpt=False, layers=16),
              dict(arch="granite-moe-1b-a400m", batch=4, seq=512, steps=4,
                   ckpt=False),
              dict(arch="whisper-medium", batch=4, seq=1500, steps=4,
                   ckpt=False),
              dict(arch="mistral-nemo-12b", batch=4, seq=512, steps=3,
                   ckpt=False, layers=MISTRAL_TRAIN_LAYERS))


MOE_METRICS = ("aux_loss", "drop_fraction", "bucket_utilization")


def train_phase(device, seed: int) -> tuple[dict, dict, dict]:
    """The training path, each run of ``TRAIN_RUNS`` in turn: the arch at
    full width in bf16 and at full depth unless the run names its
    ``layers`` (internlm2-1.8b: 24 layers, d_model 2048; zamba2-2.7b: 54
    Mamba-2 layers, d_model 2560, the shared attention block at every
    6th; falcon-mamba-7b: 16 of its 64 Mamba-1 layers, d_model 4096, with
    :func:`set_general_a`; granite-moe-1b-a400m: 24 attention+MoE layers,
    d_model 1024, 32 experts top-8), batch 4 x 512, ``steps`` AdamW steps
    through
    ``launch.train.make_step`` (remat off, as the CLI), the data stream
    through the ``Prefetcher``; for internlm2 one checkpoint of the whole
    state through ``AsyncCheckpointer`` into a temporary directory; then
    one more step under the profiler.  Every step's loss must be finite
    and its grad norm finite and nonzero (an MoE arch's step metrics must
    carry ``MOE_METRICS``, finite), and each step must launch
    flash_attention and flash_attention_bwd once per attention layer and
    ssm_scan once per Mamba layer, with the backward of its version once
    per Mamba layer (Mamba-2: ssm_scan_heads_bwd; Mamba-1: the
    per-channel ssm_scan_bwd) and the other never; the counts are zeroed
    just before each run's steps and read just after.  Returns (launches
    summed over the runs, metrics by arch, profile rows)."""
    counts, metrics, profile = {}, {}, {}
    for run in TRAIN_RUNS:
        t_start = time.perf_counter()
        c, metrics[run["arch"]], row = train_run(device, seed, **run)
        counts = {k: counts.get(k, 0) + v for k, v in c.items()}
        profile.update(row)
        print(f"[time] train {run['arch']}: "
              f"{time.perf_counter() - t_start:.1f} s with its profile")
    return counts, metrics, profile


def train_run(device, seed: int, arch: str, batch: int, seq: int,
              steps: int, ckpt: bool, layers: int | None = None
              ) -> tuple[dict, dict, dict]:
    """One run of :func:`train_phase`, at ``layers`` layers (None: the
    config's depth): (launches, metrics, profile)."""
    import shutil
    import tempfile

    from repro_torch import checkpoint as ckpt_store
    from repro_torch import configs as C
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import pipeline as dp
    from repro_torch.kernels import common as kc
    from repro_torch.launch import train

    cfg = C.get(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    shape = ShapeConfig("train", seq, batch, "train")
    mamba = cfg.n_layers if cfg.ssm_state else 0
    mamba1 = is_mamba1(cfg)
    want = {"flash_attention": flash_calls(cfg),
            "flash_attention_bwd": flash_calls(cfg),
            "ssm_scan": mamba,
            "ssm_scan_bwd": mamba if mamba1 else 0,
            "ssm_scan_heads_bwd": 0 if mamba1 else mamba}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    state = train.build_train_state(
        torch.Generator(device=device).manual_seed(seed), cfg, device=device)
    if mamba1:
        set_general_a(state["params"])
    step_fn = train.make_step(cfg, peak_lr=3e-4, total_steps=steps,
                              remat=False)
    tokens = batch * seq
    tmp = tempfile.mkdtemp(prefix="repro_train_")
    rows = []
    ckpt_bytes = snap = save = None
    try:
        it = dp.Prefetcher(dp.stream(cfg, shape, seed), device=device)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kc.reset_launches()
        for step, data in it:
            if step >= steps:
                break
            before = dict(kc.launches)
            t_start = time.perf_counter()
            state, m = step_fn(state, data)
            loss, gnorm = float(m["loss"]), float(m["grad_norm"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t_start
            per = {k: kc.launches[k] - before[k] for k in want}
            moe_m = {k: float(m[k]) for k in MOE_METRICS if k in m}
            rows.append(dict(step=step, loss=loss, grad_norm=gnorm,
                             wall_s=wall, tok_s=tokens / wall, **moe_m))
            print(f"[train] {arch} step {step}: loss {loss:.4f}, grad_norm "
                  f"{gnorm:.4f}, {wall * 1e3:.1f} ms, {tokens / wall:.1f} "
                  f"tok/s; launches {per}"
                  + "".join(f"; {k} {v:.6f}" for k, v in moe_m.items()))
            if not (np.isfinite(loss) and np.isfinite(gnorm) and gnorm > 0
                    and all(np.isfinite(v) for v in moe_m.values())):
                raise AssertionError(f"train {arch} step {step}: loss "
                                     f"{loss}, grad_norm {gnorm}, {moe_m}")
            if cfg.n_experts and len(moe_m) != len(MOE_METRICS):
                raise AssertionError(f"train {arch}: the step's metrics "
                                     f"lack the MoE's: {sorted(m)}")
            if per != want:
                raise AssertionError(f"train {arch} step {step}: launches "
                                     f"{per}, expected {want} per step")
        counts = dict(kc.launches)
        peak = torch.cuda.max_memory_allocated()
        if ckpt:
            writer = ckpt_store.AsyncCheckpointer(tmp)
            t_start = time.perf_counter()
            writer.save(state, steps - 1)
            snap = time.perf_counter() - t_start
            writer.close()
            save = time.perf_counter() - t_start
            if ckpt_store.latest_step(tmp) != steps - 1:
                raise AssertionError("train: the checkpoint was not "
                                     "committed")
            ckpt_bytes = sum(f.stat().st_size for f in Path(tmp).rglob("*")
                             if f.is_file())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    steady = rows[1:] or rows
    metrics = dict(
        steps=rows, peak_bytes=peak, ckpt_bytes=ckpt_bytes,
        ckpt_snapshot_s=snap, ckpt_save_s=save,
        tok_s=tokens * len(steady) / sum(r["wall_s"] for r in steady),
        launches_per_step={k: v / steps for k, v in counts.items() if v})
    layout = (f"{cfg.encoder_layers} encoder + {cfg.n_layers} decoder "
              f"layers, d_model {cfg.d_model}, bf16, batch {batch} x {seq} "
              f"frames x {cfg.max_target_len} tokens" if cfg.is_encdec else
              f"{cfg.n_layers} layers, d_model {cfg.d_model}, bf16, batch "
              f"{batch} x {seq}")
    print(f"[train] {arch}, {layout}, {steps} AdamW steps: "
          f"{metrics['tok_s']:.1f} tok/s after the first step, peak memory "
          f"{peak} B ({peak / 2**30:.2f} GiB); launches per step "
          f"{metrics['launches_per_step']}"
          + (f"; checkpoint {ckpt_bytes} B, snapshot {snap:.2f} s, written "
             f"{save:.2f} s" if ckpt else "; no checkpoint written"))
    data = dp.to_device(dp.batch_at(cfg, shape, seed, steps), device)
    torch.cuda.synchronize()

    def window():
        t_start = time.perf_counter()
        out = step_fn(state, data)
        torch.cuda.synchronize()
        return time.perf_counter() - t_start, out

    prof, (wall, (state, _)) = kc.profiled(
        window, f"profile of train {arch}",
        expect="|".join(SCAN_BWD_KERNELS) if mamba1 else None)
    label = f"train {arch}"
    profile = {label: profile_row(prof, wall, 1)}
    print_profile(label, profile[label], "step")
    if mamba1:
        per = {name: sum(kc_ms for key, kc_ms in named_ms(prof).items()
                         if name in key) for name in SCAN_BWD_KERNELS}
        profile[label]["ssm_scan_bwd_ms_per_step"] = sum(per.values())
        print(f"[train] {arch}: ssm_scan_bwd {sum(per.values()):.4f} device "
              f"ms a step (torch.profiler; by kernel {per})")
    del state, data, step_fn
    torch.cuda.empty_cache()
    return counts, metrics, profile


# The attention train-checks, (arch, layers) at full width in float32:
# internlm2's dense blocks, then granite-moe's attention+MoE blocks (32
# experts, top-8, its own capacity factor), the routing compared first,
# then whisper-medium's 2 encoder and 2 decoder layers (64 frames, 448
# target tokens), then mistral-nemo-12b's dense blocks (32 heads of 128
# over 8: n_heads x d_head 4096 against d_model 5120; vocabulary 131072).
ATTN_TRAIN_CHECKS = (("internlm2-1.8b", 2), ("granite-moe-1b-a400m", 2),
                     ("whisper-medium", 2), ("mistral-nemo-12b", 2))


def train_check(device, seed: int) -> dict:
    """The attention archs of ``ATTN_TRAIN_CHECKS``
    (:func:`attn_train_check`), then the SSM archs of
    ``SSM_TRAIN_CHECKS`` (:func:`ssm_train_check`).  Returns the rows of
    all and the launches of their card runs without remat, summed."""
    rows, counts = {}, {}
    for arch, n in ATTN_TRAIN_CHECKS:
        arows, acounts = attn_train_check(device, seed, arch, n)
        rows.update(arows)
        counts = {k: counts.get(k, 0) + v for k, v in acounts.items()}
    for arch, n, bound in SSM_TRAIN_CHECKS:
        srows, scounts = ssm_train_check(device, seed, arch, n, bound)
        rows.update(srows)
        counts = {k: counts.get(k, 0) + v for k, v in scounts.items()}
    return dict(rows=rows, launches=counts)


def attn_train_check(device, seed: int, arch: str, layers: int,
                     batch: int = 2, seq: int = 64) -> tuple[dict, dict]:
    """``arch`` at full width, ``layers`` layers, float32 (TF32 off):
    loss and every gradient of ``lm.loss_fn`` on the card (the flash
    forward and backward kernels, remat off and full) against the plain
    path on the CPU from the same weights and batch.  An MoE arch's
    routing (every layer's first forward) must first equal the CPU's
    bitwise (:func:`routing_check`).  Bound: the loss within 1e-5
    relative and each gradient within 1e-3 of its leaf's largest |g| (f32
    sums of up to 8192 terms in another order, 3xTF32 in the forward,
    within 2e-5 of its output, through two layers and the head; the CPU
    tests hold the plain path to JAX within 1e-5 on the reduced config).
    Gradients, not parameters after a step: AdamW's first step is about
    lr sign(g), which amplifies noise where g ~ 0.  Returns (rows,
    launches of the card run without remat)."""
    from repro_torch import configs as C
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import pipeline as dp
    from repro_torch.kernels import common as kc
    from repro_torch.models import lm
    from repro_torch.models import spec as sp

    cfg = dataclasses.replace(C.get(arch), n_layers=layers,
                              dtype="float32", remat_policy="full")
    if cfg.is_encdec:
        cfg = dataclasses.replace(cfg, encoder_layers=layers)
    params = lm.init(torch.Generator().manual_seed(seed), cfg, device="cpu")
    host = dp.batch_at(cfg, ShapeConfig("t", seq, batch, "train"), seed, 0)
    out = {}
    for label, dev, remat in (("card", device, False),
                              ("card, remat full", device, True),
                              ("cpu", torch.device("cpu"), False)):
        p = sp.tree_map(lambda x: x.to(dev).requires_grad_(True), params)
        kc.reset_launches()
        routes = []
        t_start = time.perf_counter()
        with moe_routings(routes):
            loss, _ = lm.loss_fn(cfg, p, dp.to_device(host, dev),
                                 remat=remat)
        grads = torch.autograd.grad(loss, sp.tree_leaves(p))
        grads = [g.cpu() for g in grads]
        out[label] = (float(loss.detach()), grads, dict(kc.launches),
                      time.perf_counter() - t_start, routes[:layers])
        del p
    names = ["/".join(k) for k in _tree_paths(params)]
    l_cpu, g_cpu, _, t_cpu, r_cpu = out["cpu"]
    rows = {}
    for label in ("card", "card, remat full"):
        l_gpu, g_gpu, counts, t_gpu, r_gpu = out[label]
        gap = None
        if cfg.n_experts:
            gap = routing_check(f"train-check {arch} [{label}]", r_gpu,
                                r_cpu)
        rel = [float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
               for a, b in zip(g_gpu, g_cpu)]
        worst = max(range(len(rel)), key=rel.__getitem__)
        dl = abs(l_gpu - l_cpu) / abs(l_cpu)
        print(f"[train-check] {arch} full width, {layers} layers, "
              f"f32, batch {batch} x {seq}, {label}: loss {l_gpu:.6f} vs CPU "
              f"{l_cpu:.6f} (rel {dl:.3g}); max |dg| / max |g| per leaf: "
              f"worst {rel[worst]:.3g} ({names[worst]}), median "
              f"{float(np.median(rel)):.3g}; card {t_gpu:.2f} s, CPU "
              f"{t_cpu:.2f} s; launches flash_attention "
              f"{counts['flash_attention']}, flash_attention_bwd "
              f"{counts['flash_attention_bwd']}")
        fwd = flash_calls(cfg) * (2 if "full" in label else 1)
        if (counts["flash_attention"], counts["flash_attention_bwd"]) != (
                fwd, flash_calls(cfg)):
            raise AssertionError(f"train-check {arch} [{label}]: launches "
                                 f"{counts}")
        if dl > 1e-5 or rel[worst] > 1e-3:
            raise AssertionError(f"train-check {arch} [{label}]: beyond "
                                 f"the bound")
        rows[f"{arch} {label}"] = dict(loss_rel_err=dl, worst_grad_rel_err=rel[worst],
                         worst_leaf=names[worst], moe_smallest_gap=gap)
    return rows, dict(out["card"][2])


# The SSM train-checks: (arch, layers, gradient bound) at full width,
# float32, batch 2 x 100 (a chunk of 64 steps and a ragged one of 36).
# zamba2: one pattern repeat (6 layers, so the shared attention block runs
# once), the bound four times the CPU's own conditioning measured for it,
# 4.87e-4.  falcon-mamba: 2 Mamba-1 layers with its published A, the bound
# about seven times the CPU's own conditioning, 1.44e-6.  Their
# derivation: ssm_train_check.
ZAMBA2_GRAD_BOUND = 2e-3
FALCON_GRAD_BOUND = 1e-5
SSM_TRAIN_CHECKS = (("zamba2-2.7b", 6, ZAMBA2_GRAD_BOUND),
                    ("falcon-mamba-7b", 2, FALCON_GRAD_BOUND))


def ssm_train_check(device, seed: int, arch: str, layers: int, bound: float,
                    batch: int = 2, seq: int = 100) -> tuple[dict, dict]:
    """``arch`` at full width, ``layers`` layers, float32 (TF32 off; a
    Mamba-1 arch with :func:`set_general_a`): loss and every gradient of
    ``lm.loss_fn`` on the card (the scan's forward and backward kernels,
    the flash pair; remat off and full) against the plain path on the CPU
    from the same weights and batch: the loss within 1e-5 relative and
    every gradient within ``bound`` of its leaf's largest |g|.  Launches:
    ssm_scan once per layer (twice under remat), the backward of the
    arch's version once per layer (Mamba-2: ssm_scan_heads_bwd; Mamba-1:
    the per-channel ssm_scan_bwd) and the other never, and the flash pair
    once per attention application (the forward twice under remat).

    The bound's derivation: the CPU's own gradients move by the printed
    ``conditioning`` (max over leaves of max |dg| / max |g|) when every
    weight is moved by 1e-7 of itself, a relative change of the size of
    float32 rounding; the card's float32 differs from the CPU's by a few
    such roundings per operation, so its gradients may differ by a few
    times the conditioning.  Measured on the CPU of the machine with the
    card (an H100 80GB HBM3's host): zamba2, 6 layers, 4.87e-4 (worst on
    the token embedding; the median over leaves 3.4e-5), so its bound is
    four times that, 2e-3.  Reduced zamba2 is worse conditioned against
    JAX (2e-3 for 1e-7; ``tests/test_torch_train.py``).  falcon-mamba, 2
    layers: 1.44e-6 (worst on A_log; the median 9.1e-7), and the card's
    gradients measured 4.95e-6 from the CPU's (3.4 times it, worst on
    the token embedding), so its bound is 1e-5, about seven times the
    conditioning.  Returns (rows, launches of the card run without
    remat)."""
    from repro_torch import configs as C
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import pipeline as dp
    from repro_torch.kernels import common as kc
    from repro_torch.models import lm
    from repro_torch.models import spec as sp

    cfg = dataclasses.replace(C.get(arch), n_layers=layers,
                              dtype="float32", remat_policy="full")
    params = lm.init(torch.Generator().manual_seed(seed), cfg, device="cpu")
    mamba1 = is_mamba1(cfg)
    if mamba1:
        set_general_a(params)
    gen = torch.Generator().manual_seed(seed + 1)
    moved = sp.tree_map(lambda w: w * (1 + 1e-7 * torch.randn(
        w.shape, generator=gen)), params)
    host = dp.batch_at(cfg, ShapeConfig("t", seq, batch, "train"), seed, 0)
    names = ["/".join(k) for k in _tree_paths(params)]

    def grads(dev, remat, weights):
        p = sp.tree_map(lambda x: x.to(dev).requires_grad_(True), weights)
        kc.reset_launches()
        t_start = time.perf_counter()
        loss, _ = lm.loss_fn(cfg, p, dp.to_device(host, dev), remat=remat)
        g = torch.autograd.grad(loss, sp.tree_leaves(p))
        return (float(loss.detach()), [x.cpu() for x in g], dict(kc.launches),
                time.perf_counter() - t_start)

    def rel(got, want):
        r = [float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
             for a, b in zip(got, want)]
        return r, max(range(len(r)), key=r.__getitem__)

    l_cpu, g_cpu, _, t_cpu = grads(torch.device("cpu"), False, params)
    cond, c_worst = rel(grads(torch.device("cpu"), False, moved)[1], g_cpu)
    del moved
    print(f"[train-check] {arch} full width, {layers} layers, f32, "
          f"batch {batch} x {seq}: conditioning on the CPU (weights moved "
          f"by 1e-7 of themselves): max |dg| / max |g| per leaf worst "
          f"{cond[c_worst]:.3g} ({names[c_worst]}), median "
          f"{float(np.median(cond)):.3g}; bound {bound:g}")
    rows, counts = {}, None
    for label, remat in (("card", False), ("card, remat full", True)):
        l_gpu, g_gpu, c, t_gpu = grads(device, remat, params)
        r, worst = rel(g_gpu, g_cpu)
        dl = abs(l_gpu - l_cpu) / abs(l_cpu)
        print(f"[train-check] {arch} full width, {layers} layers, f32, "
              f"batch {batch} x {seq}, {label}: loss {l_gpu:.6f} vs CPU "
              f"{l_cpu:.6f} (rel {dl:.3g}); max |dg| / max |g| per leaf: "
              f"worst {r[worst]:.3g} ({names[worst]}), median "
              f"{float(np.median(r)):.3g}; card {t_gpu:.2f} s, CPU "
              f"{t_cpu:.2f} s; launches ssm_scan {c['ssm_scan']}, "
              f"ssm_scan_heads_bwd {c['ssm_scan_heads_bwd']}, ssm_scan_bwd "
              f"{c['ssm_scan_bwd']}, flash_attention "
              f"{c['flash_attention']}, flash_attention_bwd "
              f"{c['flash_attention_bwd']}")
        k = 2 if remat else 1
        want = (layers * k, 0 if mamba1 else layers, layers if mamba1 else 0,
                flash_calls(cfg) * k, flash_calls(cfg))
        if (c["ssm_scan"], c["ssm_scan_heads_bwd"], c["ssm_scan_bwd"],
                c["flash_attention"], c["flash_attention_bwd"]) != want:
            raise AssertionError(f"train-check {arch} [{label}]: launches "
                                 f"{c}, expected (scan, scan_heads_bwd, "
                                 f"scan_bwd, flash, flash_bwd) {want}")
        if dl > 1e-5 or r[worst] > bound:
            raise AssertionError(f"train-check {arch} [{label}]: beyond "
                                 f"the bound")
        rows[f"{arch} {label}"] = dict(
            loss_rel_err=dl, worst_grad_rel_err=r[worst],
            worst_leaf=names[worst], conditioning=cond[c_worst])
        counts = counts or c
    return rows, counts


# The compressed-gradient data-parallel phase: internlm2-1.8b at full width
# and depth, bf16, batch 4 x 512 a rank; (method, checked steps) after
# "none", each method's timed steps after them.
COMPRESSED_ARCH = "internlm2-1.8b"
COMPRESSED_METHODS = (("int8", 3), ("topk", 3))
COMPRESSED_TIMED = 2
TOPK_FRAC = 0.01


def state_leaves(state) -> list:
    """A trainer state's parameters, both moments and step count, in the
    reference's leaf order."""
    from repro_torch.models.spec import tree_leaves

    opt = state["opt"]
    return (tree_leaves(state["params"]) + tree_leaves(opt.m)
            + tree_leaves(opt.v) + [opt.count])


def state_to_host(state) -> list:
    """:func:`state_leaves` copied to the host, for a bitwise comparison
    after the card's copy is freed."""
    return [x.cpu() for x in state_leaves(state)]


def same_state(label: str, state, host: list) -> None:
    got = state_leaves(state)
    if len(got) != len(host):
        raise AssertionError(f"{label}: {len(got)} leaves, {len(host)}")
    bad = [i for i, (g, h) in enumerate(zip(got, host))
           if not torch.equal(g.cpu(), h)]
    if bad:
        raise AssertionError(f"{label}: leaves {bad} of {len(host)} differ")


@contextlib.contextmanager
def codec_checks(rows: list):
    """While the block runs, every ``compression.compress_leaf`` call is
    held to the codec's contract: wire + new residual equals gradient +
    old residual within 1e-5 of the leaf's largest |g + r|; int8: every
    wire value q scale with |q| <= 127; topk: the wire is acc times the
    mask of the k largest |acc|, which keeps at least k.  A row a leaf
    goes to ``rows``."""
    from repro_torch.optim import compression

    orig = compression.compress_leaf

    def wrapped(g, r, gen, *, method, topk_frac=0.01):
        wire, res = orig(g, r, gen, method=method, topk_frac=topk_frac)
        acc = g.float() + r
        big = float(acc.abs().max())
        err = float(((wire + res) - acc).abs().max())
        row = dict(method=method, n=acc.numel(), err=err, big=big,
                   ok=err <= 1e-5 * big)
        if method == "int8":
            # The codec's scale, by the same float32 operations.
            scale = acc.abs().max() / 127.0
            scale = torch.where(scale == 0, torch.ones_like(scale), scale)
            q = torch.round(wire / scale)
            row["q_max"] = float(q.abs().max())
            row["ok"] &= (torch.equal(q * scale, wire)
                          and row["q_max"] <= 127)
        elif method == "topk":
            mask = compression._topk_mask(acc, topk_frac)
            row["k"] = max(1, int(acc.numel() * topk_frac))
            row["kept"] = int(mask.sum())
            row["ok"] &= (row["kept"] >= row["k"]
                          and torch.equal(wire, acc * mask))
        rows.append(row)
        return wire, res

    compression.compress_leaf = wrapped
    try:
        yield
    finally:
        compression.compress_leaf = orig


@contextlib.contextmanager
def count_all_reduces(store: list):
    """Count the host's ``torch.distributed.all_reduce`` calls while the
    block runs (``store`` gets one entry a call)."""
    import torch.distributed as dist

    orig = dist.all_reduce

    def wrapped(*args, **kwargs):
        store.append(1)
        return orig(*args, **kwargs)

    dist.all_reduce = wrapped
    try:
        yield
    finally:
        dist.all_reduce = orig


def _compressed_rank(rank: int, world: int, store: str, out: str,
                     seed: int) -> None:
    """A rank of the multi-GPU run (spawned, GPU ``rank``): one
    ``make_compressed_step(method="none")`` step of internlm2-1.8b on its
    half of the batch, then whether every leaf of its new state equals
    rank 0's (broadcast)."""
    import torch.distributed as dist

    from repro_torch import configs as C
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import pipeline as dp
    from repro_torch.launch import mesh as ms
    from repro_torch.launch import train
    from repro_torch.optim import compression

    torch.cuda.set_device(rank)
    device = torch.device("cuda", rank)
    dist.init_process_group("nccl", init_method="file://" + store,
                            rank=rank, world_size=world)
    try:
        cfg = C.get(COMPRESSED_ARCH)
        mesh = ms.make_host_mesh()
        state = train.build_train_state(
            torch.Generator(device=device).manual_seed(seed), cfg,
            device=device)
        state["ef"] = compression.ef_init(state["params"])
        batch = dp.to_device(dp.batch_at(
            cfg, ShapeConfig("train", 512, 4 * world, "train"), seed, 0),
            device)
        mine = {k: v[rank * 4:(rank + 1) * 4] for k, v in batch.items()}
        step = train.make_compressed_step(cfg, mesh, peak_lr=3e-4,
                                          total_steps=8, method="none")
        state, _ = step(state, mine, torch.Generator(device=device))
        equal = True
        for x in state_leaves(state):
            y = x.clone()
            dist.broadcast(y, src=0)
            equal &= torch.equal(x, y)
        torch.save(dict(equal=equal), f"{out}-{rank}.pt")
    finally:
        dist.destroy_process_group()


def compressed_phase(device, seed: int) -> tuple[dict, dict, dict]:
    """The data-parallel trainer with compressed gradients on the card:
    ``launch.train.make_compressed_step`` on a one-rank NCCL group
    (``launch.mesh.make_host_mesh()``, a (1, 1) ("data", "model") mesh),
    internlm2-1.8b at full width and depth (24 layers, d_model 2048),
    bf16, batch 4 x 512 from ``data.pipeline``, remat off.

    ``make_step`` takes a first step, then twice the same second step
    (timed); ``method="none"`` from the same
    state and batch must equal it bitwise in the new parameters, both
    moments and the loss (the wire is the float32 gradient plus a zero
    residual, the one-rank all-reduce divides by 1, ``adamw.update``
    casts each gradient to float32).  Then ``none``, ``int8`` and
    ``topk`` (``TOPK_FRAC``): int8 and topk first take their checked
    steps under :func:`codec_checks`, then each method its timed steps,
    then one step under the profiler (NCCL kernels by name, expected one
    all-reduce a leaf and one for the metrics).  Every step's loss must
    be finite and it must launch flash_attention and flash_attention_bwd
    24 times each and no other kernel; the host's all-reduce calls a
    compressed step must be one a leaf plus one.  With a second GPU,
    ``none`` at world 2 (spawned, last): the ranks' states must be
    bitwise equal.  Returns (launches, metrics, profile rows)."""
    import shutil
    import tempfile

    import torch.distributed as dist

    from repro_torch import configs as C
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import pipeline as dp
    from repro_torch.kernels import common as kc
    from repro_torch.launch import mesh as ms
    from repro_torch.launch import train
    from repro_torch.optim import compression

    cfg = C.get(COMPRESSED_ARCH)
    shape = ShapeConfig("train", 512, 4, "train")
    tokens = shape.global_batch * shape.seq_len
    want = {k: 0 for k in kc.KERNELS}
    want.update(flash_attention=flash_calls(cfg),
                flash_attention_bwd=flash_calls(cfg))
    tmp = tempfile.mkdtemp(prefix="compressed-")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                            rank=0, world_size=1)
    metrics, profile = {}, {}
    try:
        marks = [time.perf_counter()]
        mesh = ms.make_host_mesh()
        batches = [dp.to_device(dp.batch_at(cfg, shape, seed, i), device)
                   for i in range(4)]
        state = train.build_train_state(
            torch.Generator(device=device).manual_seed(seed), cfg,
            device=device)
        n_leaves = len(state_leaves(state)[:-1]) // 3
        wire_bytes = {m: compression.wire_bytes(state["params"], method=m,
                                                topk_frac=TOPK_FRAC)
                      for m in ("none", "int8", "topk")}
        plain = train.make_step(cfg, peak_lr=3e-4, total_steps=8,
                                remat=False)
        steps = {m: train.make_compressed_step(
            cfg, mesh, peak_lr=3e-4, total_steps=8, method=m,
            topk_frac=TOPK_FRAC) for m in ("none", "int8", "topk")}
        gen = torch.Generator(device=device).manual_seed(seed)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kc.reset_launches()
        rows = []

        def run(label, fn, *args):
            """One step, timed and checked: (state, metrics)."""
            before = dict(kc.launches)
            calls: list = []
            t_start = time.perf_counter()
            with count_all_reduces(calls):
                out, m = fn(*args)
            loss = float(m["loss"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t_start
            per = {k: kc.launches[k] - before[k] for k in want}
            rows.append(dict(label=label, loss=loss, wall_s=wall,
                             grad_norm=float(m["grad_norm"]),
                             all_reduces=len(calls)))
            print(f"[compressed] {label}: loss {loss:.4f}, grad_norm "
                  f"{float(m['grad_norm']):.4f}, {wall * 1e3:.1f} ms, "
                  f"{tokens / wall:.1f} tok/s, {len(calls)} all-reduce "
                  f"calls")
            if not np.isfinite(loss):
                raise AssertionError(f"compressed {label}: loss {loss}")
            if per != want:
                raise AssertionError(f"compressed {label}: launches {per}, "
                                     f"expected {want}")
            if fn is not plain and len(calls) != n_leaves + 1:
                raise AssertionError(f"compressed {label}: {len(calls)} "
                                     f"all-reduces, expected {n_leaves} "
                                     f"leaves + 1")
            return out, m

        # make_step: a first step, then its second step twice (timed).
        marks.append(time.perf_counter())
        s1, _ = run("make_step 1", plain, state, batches[0])
        del state
        s2, m2 = run("make_step 2", plain, s1, batches[1])
        host, loss2 = state_to_host(s2), m2["loss"].cpu()
        del s2
        run("make_step 2 again", plain, s1, batches[1])
        timed = {"make_step": [rows[-2]["wall_s"], rows[-1]["wall_s"]]}
        # "none" from the same state and batch: bitwise equal.
        s1["ef"] = compression.ef_init(s1["params"])
        cur, mn = run("none 1", steps["none"], s1, batches[1], gen)
        same_state("none against make_step", cur, host)
        if not torch.equal(mn["loss"].cpu(), loss2):
            raise AssertionError("none: the loss differs from make_step's")
        del s1, host
        marks.append(time.perf_counter())
        print(f"[compressed] none: new parameters, both moments and the "
              f"loss bitwise equal to make_step's ({n_leaves} leaves)")
        checks = {}
        for method, n in COMPRESSED_METHODS:
            checks[method] = []
            with codec_checks(checks[method]):
                for i in range(n):
                    cur, _ = run(f"{method} checked {i + 1}", steps[method],
                                 cur, batches[i % 4], gen)
            bad = [r for r in checks[method] if not r["ok"]]
            worst = max(r["err"] / r["big"] for r in checks[method]
                        if r["big"])
            extra = (f"largest |q| {max(r['q_max'] for r in checks[method])}"
                     if method == "int8" else
                     f"kept / k from {min(r['kept'] / r['k'] for r in checks[method]):.4f}"
                     f" to {max(r['kept'] / r['k'] for r in checks[method]):.4f}")
            print(f"[compressed] {method}: {n} steps x {n_leaves} leaves "
                  f"hold the codec: wire + residual within "
                  f"{worst:.3g} of each leaf's largest |g + r| (bound "
                  f"1e-5); {extra}")
            if bad or len(checks[method]) != n * n_leaves:
                raise AssertionError(f"compressed {method}: codec checks "
                                     f"failed {bad[:3]}")
        marks.append(time.perf_counter())
        for method in ("none", "int8", "topk"):
            timed[method] = []
            for i in range(COMPRESSED_TIMED):
                cur, _ = run(f"{method} timed {i + 1}", steps[method], cur,
                             batches[i % 4], gen)
                timed[method].append(rows[-1]["wall_s"])
        counts = dict(kc.launches)
        peak = torch.cuda.max_memory_allocated()
        marks.append(time.perf_counter())
        for method in ("none", "int8", "topk"):
            data = batches[3]

            def window(cur=cur, method=method, data=data):
                t_start = time.perf_counter()
                out = steps[method](cur, data, gen)
                torch.cuda.synchronize()
                return time.perf_counter() - t_start, out

            prof, (wall, (nxt, _)) = kc.profiled(
                window, f"profile of compressed {method}",
                expect="flash_attention_bwd")
            label = f"compressed {method}"
            row = profile_row(prof, wall, 1)
            nccl = [e for e in prof.key_averages()
                    if kc.on_device(e) and "nccl" in e.key.lower()]
            row["nccl_kernels"] = {e.key[:80]: e.count for e in nccl}
            row["nccl_kernels_per_step"] = sum(e.count for e in nccl)
            profile[label] = row
            print_profile(label, row)
            print(f"[compressed] {method}: NCCL kernels a step "
                  f"{row['nccl_kernels_per_step']} (expected {n_leaves + 1}"
                  f": one all-reduce a leaf, one for the metrics), by name "
                  f"{row['nccl_kernels']}")
            del nxt
        marks.append(time.perf_counter())
        parts = dict(zip(("setup", "make_step and none", "checked steps",
                          "timed steps", "profiles"), np.diff(marks)))
        print("[time] compressed: " + ", ".join(
            f"{k} {v:.1f} s" for k, v in parts.items()))
        tok_s = {m: tokens * len(w) / sum(w) for m, w in timed.items()}
        metrics = dict(
            steps=rows, tok_s=tok_s, wire_bytes=wire_bytes, peak_bytes=peak,
            n_leaves=n_leaves, topk_frac=TOPK_FRAC,
            launches_per_step={k: v for k, v in want.items() if v},
            codec_worst={m: max(r["err"] / r["big"] for r in c if r["big"])
                         for m, c in checks.items()})
        print(f"[compressed] {COMPRESSED_ARCH}, {cfg.n_layers} layers, "
              f"d_model {cfg.d_model}, {cfg.dtype}, batch {shape.global_batch} x "
              f"{shape.seq_len} a rank, world 1 on NCCL: tok/s after the "
              f"first step " + ", ".join(f"{m} {v:.1f}"
                                         for m, v in tok_s.items())
              + f"; wire bytes a step {wire_bytes}; peak memory {peak} B "
              f"({peak / 2**30:.2f} GiB); launches per step "
              f"{metrics['launches_per_step']}; {gpu_line()}")
        del cur, batches, steps, plain
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    try:
        n_dev = torch.cuda.device_count()
        if n_dev >= 2:
            import torch.multiprocessing as mp

            mp.spawn(_compressed_rank, args=(2, f"{tmp}/store2",
                                             f"{tmp}/out", seed),
                     nprocs=2, join=True)
            ranks = [torch.load(f"{tmp}/out-{r}.pt") for r in range(2)]
            if not all(r["equal"] for r in ranks):
                raise AssertionError("compressed: at world 2 the ranks' "
                                     "states differ")
            metrics["world2_equal"] = True
            print(f"[compressed] world 2 (NCCL, {n_dev} devices), none: "
                  f"the ranks' parameters and moments are bitwise equal")
        else:
            print(f"[compressed] world 2 did not run: {n_dev} CUDA device "
                  f"(the CPU tests hold worlds 2 and 4 on gloo)")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return counts, metrics, profile


def _tree_paths(tree, prefix=()):
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _tree_paths(tree[k],
                                                             prefix + (k,))]
    return [prefix]


def bf16_check(device, seed: int, layers: int = 2, prompt: int = 128) -> dict:
    """internlm2-1.8b at full width, ``layers`` layers, bf16, batch 1:
    the logits of a full forward over ``prompt`` tokens on the card (the
    wgmma flash kernel, cuBLAS bf16) against the plain path on the CPU
    from the same bf16 weights, within 2^-4 of the largest |logit|.  Each
    bf16 rounding (some 14 per layer and 2 at the head) may land one ulp
    apart on the two, at most 2^-7 of the element; such flips add up like
    a random walk, sqrt(30) 2^-7 = 0.043 for two layers, and the kernel's
    rounding of P adds 2^-8 of |v| per attention layer (its tolerance)."""
    from repro_torch import configs as C
    from repro_torch.models import lm
    from repro_torch.models import spec as sp
    from repro_torch.models import transformer as tfm

    cfg = dataclasses.replace(C.get("internlm2-1.8b"), n_layers=layers)
    params = lm.init(torch.Generator().manual_seed(seed), cfg, device="cpu")
    tokens = torch.as_tensor(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (1, prompt)).astype(np.int32))
    out = {}
    for dev in (device, torch.device("cpu")):
        p = sp.tree_map(lambda x: x.to(dev), params)
        t_start = time.perf_counter()
        with torch.no_grad():
            lg = tfm.forward(cfg, p, tokens.to(dev)).logits
        out[dev.type] = (lg.float().cpu(), time.perf_counter() - t_start)
        del p
    (gpu, t_gpu), (cpu, t_cpu) = out["cuda"], out["cpu"]
    scale = float(cpu.abs().max())
    err = float((gpu - cpu).abs().max())
    agree = float((gpu.argmax(-1) == cpu.argmax(-1)).float().mean())
    print(f"[bf16-check] internlm2-1.8b full width, {layers} layers, bf16, "
          f"prompt {prompt}: max |dlogit| {err:.4g} vs max |logit| "
          f"{scale:.4g} (rel {err / scale:.3g}, bound 2^-4); argmax equal "
          f"at {agree:.3f} of positions; card {t_gpu:.2f} s, CPU "
          f"{t_cpu:.2f} s")
    if not bool(torch.isfinite(gpu).all()) or err > 2**-4 * scale:
        raise AssertionError("bf16-check: the card's bf16 logits differ "
                             "from the CPU's beyond 2^-4 of max |logit|")
    return dict(rel_err=err / scale, argmax_equal=agree)


def _demo_on_cpu(demo):
    """The demo's spike times from the plain versions on the CPU."""
    import io

    with contextlib.redirect_stdout(io.StringIO()):
        return demo.main("cpu")


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=64)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import common as kc

    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}")
    t_start = time.perf_counter()
    build = kc.build()
    print(f"[build] {len(kc.SOURCES)} sources, {len(kc.KERNELS)} kernels in "
          f"{time.perf_counter() - t_start:.1f} s into {build}")
    marks = [("start", t_start)]

    def mark(phase: str) -> None:
        marks.append((phase, time.perf_counter()))
    for name in kc.SOURCES:
        log = build / f"{name}.log"
        if log.exists():
            for line in log.read_text().splitlines():
                if any(w in line for w in ("registers", "spill", "smem",
                                          "entry function")):
                    print(f"[build] {name}: {line.strip()}")
    fwd = ptxas_by_dn((build / "flash_attention.log").read_text(),
                      FLASH_INSTANCES.values())
    for kind, name in FLASH_INSTANCES.items():
        by_dn = {dn: spill for dn, (_, spill) in fwd[name].items()}
        print(f"[build] flash_attention {kind} spill bytes by DN: {by_dn}")
        for dn in ("80", "128"):
            if by_dn.get(dn) != 0:
                raise AssertionError(f"flash_attention {kind} DN {dn}: "
                                     f"ptxas spills {by_dn.get(dn)} bytes "
                                     f"(or no report)")
    bwd = ptxas_by_dn((build / "flash_attention_bwd.log").read_text(),
                      sum(FLASH_BWD_ROUTES.values(), ()))
    for name, by_args in bwd.items():
        print(f"[build] {name} (registers, spill bytes) by DN: "
              f"{by_args}")
    for name in sum(FLASH_BWD_ROUTES.values(), ()):
        dns = {int(key) for key in bwd[name]}
        bad = {key: rs for key, rs in bwd[name].items() if rs[1] != 0}
        if dns != set(FLASH_DNS) or bad:
            raise AssertionError(f"{name}: ptxas reports DNs {sorted(dns)}, "
                                 f"spills (or no report) at {bad}")
    # Both routes run on tensor cores (HMMA in every instance: bf16
    # HMMA.16816, float32 HMMA.1688 on TF32) and neither uses atomics.
    cuobjdump = Path(kc._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass",
                           str(build / "libflash_attention_bwd.so")],
                          capture_output=True, text=True, check=True).stdout
    counts = sass_instances(sass, sum(FLASH_BWD_ROUTES.values(), ()))
    print(f"[build] flash_attention_bwd SASS (HMMA, atomic) per instance: "
          f"{counts}")
    tf32 = sass_instances(sass, FLASH_BWD_ROUTES["mma_tf32x3"],
                          r"HMMA\S*\.TF32")
    print(f"[build] flash_attention_bwd SASS TF32 HMMA per float32 "
          f"instance: { {k: n for k, (n, _) in tf32.items()} }")
    if (len(counts) != 2 * len(FLASH_BWD_ROUTES) * len(FLASH_DNS)
            or any(hmma == 0 or atom for hmma, atom in counts.values())
            or len(tf32) != 2 * len(FLASH_DNS)
            or any(n == 0 for n, _ in tf32.values())):
        raise AssertionError(f"flash_attention_bwd SASS: {counts}")

    # The scan's general-A backward: each kernel's instances, none may
    # spill.
    log = (build / "ssm_scan_bwd.log").read_text()
    for kernel, count in SCAN_BWD_KERNELS.items():
        scan_bwd = ptxas_instances(log, kernel)
        print(f"[build] {kernel} (registers, spill bytes) by instance: "
              f"{scan_bwd}")
        if len(scan_bwd) != count or any(sp != 0
                                         for _, sp in scan_bwd.values()):
            raise AssertionError(f"{kernel}: ptxas reports {scan_bwd} "
                                 f"({count} instances, no spill)")
    # The per-head (chunked) backward: no spill, no stack frame, 3xTF32
    # on mma.sync (TF32 HMMA) in every instance and no atomic.
    heads = ptxas_frames((build / "ssm_scan_bwd_chunked.log").read_text(),
                         SCAN_HEADS_KERNELS)
    print(f"[build] ssm_scan_bwd_chunked (registers, spill bytes, stack "
          f"frame bytes) by instance: {heads}")
    sass = subprocess.run([str(cuobjdump), "-sass",
                           str(build / "libssm_scan_bwd_chunked.so")],
                          capture_output=True, text=True, check=True).stdout
    hmma = sass_instances(sass, SCAN_HEADS_KERNELS, r"HMMA\S*\.TF32")
    print(f"[build] ssm_scan_bwd_chunked SASS (TF32 HMMA, atomic) by "
          f"instance: {hmma}")
    if (len(heads) != SCAN_HEADS_INSTANCES or set(hmma) != set(heads)
            or any(r[1] != 0 or r[2] != 0 for r in heads.values())
            or any(n == 0 or atom for n, atom in hmma.values())):
        raise AssertionError(f"ssm_scan_bwd_chunked: ptxas {heads}, SASS "
                             f"{hmma} ({SCAN_HEADS_INSTANCES} instances, no "
                             f"spill, no stack frame, TF32 HMMA, no atomic)")

    paths = Paths(device, args.seed, args.steps)
    blocks = paths.first_blocks()
    cases = kernel_cases(blocks, paths, device) + lm_kernel_cases(
        device, args.seed)
    mark("build and case inputs")
    main_rows = kernel_phase(cases)
    del cases
    mark("kernel")
    new, old = (main_rows["ssm_scan_heads_bwd"],
                main_rows["ssm_scan_bwd zamba2"])
    print(f"[kernel] the scan's backward at [4, 512, 5120] N 64, x bf16, A "
          f"per head: per-head (chunked) ms={new['ms']:.5f} beside "
          f"per-channel ms={old['ms']:.5f} ({old['ms'] / new['ms']:.2f}x); "
          f"the chunked kernel's bound {new['bound_ms']:.5f} ms, "
          f"{new['bound_ms'] / new['ms']:.3f} of it")
    fwd, bwd = main_rows["ssm_scan falcon"], main_rows["ssm_scan_bwd"]
    print(f"[kernel] falcon-mamba's general routes: ssm_scan at its prefill "
          f"ms={fwd['ms']:.5f} (bound {fwd['bound_ms']:.5f} by "
          f"{fwd['bound_by']}, exp floor {fwd['exp_floor_ms']:.5f}), "
          f"ssm_scan_bwd at its training shape ms={bwd['ms']:.5f} (bound "
          f"{bwd['bound_ms']:.5f} by {bwd['bound_by']}, "
          f"{bwd['bound_ms'] / bwd['ms']:.3f} of it)")
    window, causal = (main_rows["long 32k window bf16"],
                      main_rows["long 32k causal bf16"])
    share = window["ms"] / causal["ms"]
    print(f"[kernel] flash_attention at [1, 32, 32768, 80] bf16: window "
          f"{LONG_WINDOW} ms={window['ms']:.5f} ({window['pairs']} pairs a "
          f"head) against causal ms={causal['ms']:.5f} ({causal['pairs']} "
          f"pairs): {share:.3f} of it (live pairs "
          f"{window['pairs'] / causal['pairs']:.3f}); SDPA with the mask "
          f"{window['library_ms']}")
    if share > WINDOW_SHARE:
        raise AssertionError(f"the windowed flash takes {share:.3f} of the "
                             f"causal call's time, above {WINDOW_SHARE}: "
                             f"the tiles outside the window are not skipped")
    ssd = main_rows["ssd_chunked"]
    print(f"[kernel] ssd_chunked at [1, 32768, 5120] bf16, chunk "
          f"{SSD_CHUNK}: ms={ssd['ms']:.5f} bound {ssd['bound_ms']:.5f} "
          f"({ssd['bound_by']}, {ssd['bound_ms'] / ssd['ms']:.3f} of it), "
          f"exp floor {ssd['exp_floor_ms']:.5f}; the scan route at [4, 2048, "
          f"5120] ms={main_rows['ssm_scan']['ms']:.5f}")
    whisper = {k: v for k, v in main_rows.items() if k.startswith("whisper")}
    dense = {k: v for k, v in main_rows.items()
             if k.startswith(KEYED) and k not in whisper}
    for key, row in {**whisper, **dense}.items():
        print(f"[kernel] {key}: {row['name']} ms={row['ms']:.5f} bound "
              f"{row['bound_ms']:.5f} ({row['bound_by']}, "
              f"{row['bound_ms'] / row['ms']:.3f} of it), SDPA "
              f"{row['library_ms']:.5f} ({row['ms'] / row['library_ms']:.2f}x)")
    entry = entry_phase(blocks, paths, device)
    counts = path_phase(paths, device)
    counts["entry"] = entry
    mark("entry and paths")
    counts["resilient"] = resilient_phase(paths, device)
    telemetry = telemetry_phase(paths, device)
    mark("resilient and telemetry")
    counts["shard"], shard_rows = shard_phase(paths, blocks, device,
                                              args.seed, args.steps)
    mark("shard")
    check = serve_check(device, args.seed)
    counts["serve-check"] = check["launches"]
    mark("serve-check")
    serve_counts, serve_metrics, serve_profiles = serve_phase(device,
                                                              args.seed)
    counts.update(serve_counts)
    mark("serve")
    bf16 = bf16_check(device, args.seed)
    tcheck = train_check(device, args.seed)
    counts["train-check"] = tcheck["launches"]
    mark("bf16-check and train-check")
    counts["train"], train_metrics, train_profile = train_phase(device,
                                                                args.seed)
    mark("train")
    profile = profile_phase(paths, device)
    mark("profile")
    counts["compressed"], compressed, compressed_profile = compressed_phase(
        device, args.seed)
    mark("compressed")
    profile.update(compressed_profile)
    profile.update(shard_rows)
    profile.update(serve_profiles)
    profile.update(train_profile)

    kernels = []
    for name, src in kc.KERNELS.items():
        row = main_rows[name]
        launches = {p: c[name] for p, c in counts.items() if c[name]}
        kernels.append(dict(
            name=name, route="cuda", source=f"src/repro_torch/csrc/{src}.cu",
            replaces=REPLACES[name], launches=sum(launches.values()),
            max_abs_err=row["max_abs_err"], ms=row["ms"],
            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=row["library_ms"],
            mode=row["mode"], device_ms=row["device_ms"],
            bytes=row["bytes"], ops=row["ops"], launches_by=launches,
            **{k: row[k] for k in ("host_us", "floor_ms", "split_ms")
               if k in row}))
        if not launches:
            raise AssertionError(f"kernel {name} launched on no path or "
                                 f"entry point")
        print(f"[kernel-summary] {name}: launches {launches} "
              f"ms={row['ms']:.5f} plain_ms={row['plain_ms']:.4f} "
              f"bytes={row['bytes']} bound_ms={row['bound_ms']:.5f} "
              f"({row['bound_by']}) library_ms={row['library_ms']} "
              f"[{row['mode']}]")
    summary = dict(
        launches={p: {k: v for k, v in c.items() if k in kc.KERNELS}
                  for p, c in counts.items()},
        steps_per_s={p: c["steps_per_s"] for p, c in counts.items()
                     if "steps_per_s" in c},
        serve=serve_metrics,
        serve_check={k: v for k, v in check.items() if k != "launches"},
        bf16_check=bf16, train_check=tcheck["rows"], train=train_metrics,
        compressed=compressed,
        whisper_kernels={k: {f: v[f] for f in ("ms", "bound_ms", "bound_by",
                                               "library_ms", "mode")}
                         for k, v in whisper.items()},
        dense_kernels={k: {f: v[f] for f in ("ms", "bound_ms", "bound_by",
                                             "library_ms", "mode")}
                       for k, v in dense.items()},
        long_context_kernels={
            k: {f: v.get(f) for f in ("ms", "device_ms", "plain_ms",
                                      "bound_ms", "bound_by", "library_ms",
                                      "exp_floor_ms", "max_abs_err", "mode",
                                      "split_ms", "tol_share",
                                      "want_mean_abs", "library_small")}
            for k, v in main_rows.items()
            if k.startswith(("long ", "window ", "ssd ",
                             "zamba2 prefill ssd"))},
        checkpoint=counts["resilient"]["checkpoint"], telemetry=telemetry,
        profile=profile)
    print(f"[summary] {json.dumps(summary)}")
    print(f"[time] {time.perf_counter() - t_start:.1f} s from the build to "
          f"the summary; by phase: " + ", ".join(
              f"{name} {t - marks[i][1]:.1f} s"
              for i, (name, t) in enumerate(marks[1:])))
    print(json.dumps({"kernels": kernels}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
