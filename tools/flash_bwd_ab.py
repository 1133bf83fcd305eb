"""The float32 flash-attention backward of this tree against another build
of ``csrc/flash_attention_bwd.cu`` (an earlier commit's, or a variant), in
turns on one card.

    PYTHONPATH=src python tools/flash_bwd_ab.py OTHER.cu

OTHER.cu is compiled with the port's nvcc flags and the port's ``csrc``
on its include path (``kc.build_variant``); its C entry point
``flash_attention_bwd_launch`` takes the arguments of this tree's, and
the tree's wrapper launches it (``kc.variant``).  For each shape both
builds are held against ``attention_bwd_ref`` within
``attention_bwd_bounds`` (``tf32x3_bwd_bounds`` where q is scaled up, a
peaked softmax), two calls of each must give the same bits, and each is
timed by CUDA events over a CUDA graph of 20 calls in the order this,
other, other, this; torch.profiler gives each kernel's device time per
call.  Prints the card's name and power limit.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import torch

from repro_torch.kernels import common as kc
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.flash_attention.ref import (
    attention_bwd_bounds, attention_bwd_ref, attention_with_lse_ref,
    tf32x3_bwd_bounds)

# label, (b, hq, hkv, sq, skv, d), causal, q_offset, factor on q
SHAPES = [
    ("internlm2 heads, batch 1", (1, 16, 8, 512, 512, 128), True, 0, 1.0),
    ("zamba2 heads", (1, 32, 32, 512, 512, 80), True, 0, 1.0),
    ("q_offset 71, GQA 4", (1, 32, 8, 129, 200, 80), True, 71, 1.0),
    ("train-check", (2, 16, 8, 64, 64, 128), True, 0, 1.0),
    ("peaked, q x 8", (1, 16, 8, 512, 512, 128), True, 0, 8.0),
    ("D 256", (1, 4, 2, 300, 300, 256), True, 0, 1.0),
    ("D 64, full mask", (1, 8, 8, 200, 300, 64), False, 0, 1.0)]


def kernel_ms(fn, iters: int = 10) -> dict[str, float]:
    """Device ms per call of the dQ and the dK/dV kernel (torch.profiler)."""
    fn()
    torch.cuda.synchronize()

    def window():
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()

    prof, _ = kc.profiled(window, "flash_bwd_ab")
    out = {}
    for evt in prof.key_averages():
        for name in ("dq", "dkdv"):
            if f"flash_attention_bwd_{name}_" in evt.key:
                t = getattr(evt, "device_time_total", 0.0)
                out[name] = t / iters / 1e3
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", type=Path, help="another flash_attention_bwd.cu")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("flash_bwd_ab: no CUDA device", file=sys.stderr)
        return 2
    kc.build()
    other, _ = kc.build_variant(args.other)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    for label, (b, hq, hkv, sq, skv, d), causal, q_offset, factor in SHAPES:
        randn = lambda *s: torch.randn(s, generator=gen,  # noqa: E731
                                       device=dev)
        q = randn(b, hq, sq, d) * factor
        k, v, dout = randn(b, hkv, skv, d), randn(b, hkv, skv, d), randn(
            b, hq, sq, d)
        kw = dict(causal=causal, q_offset=q_offset)
        out, lse = attention_with_lse_ref(q, k, v, **kw)
        xs = (q, k, v, out, lse, dout)
        want = attention_bwd_ref(*xs, **kw)
        bounds = (tf32x3_bwd_bounds if factor != 1.0
                  else attention_bwd_bounds)(*xs, **kw)

        def run_other(xs=xs, kw=kw):
            with kc.variant(fa.BWD_NAME, other):
                return fa.flash_attention_bwd(*xs, **kw)

        runs = {"this": lambda: fa.flash_attention_bwd(*xs, **kw),
                "other": run_other}
        for tag, run in runs.items():
            got, again = run(), run()
            torch.cuda.synchronize()
            ratios = [float(((g - w).abs() / bd).max())
                      for g, w, bd in zip(got, want, bounds)]
            if max(ratios) > 1 or not all(
                    torch.equal(x, y) for x, y in zip(got, again)):
                raise AssertionError(f"{label} [{tag}]: err / bound "
                                     f"{ratios}, or two calls differ")
            print(f"{label} {tuple(q.shape)} [{tag}]: max err / bound dq dk "
                  f"dv {', '.join(f'{r:.3g}' for r in ratios)}; kernels ms "
                  f"{kernel_ms(run)}")
        times = [kc.graph_ms(runs[tag]) for tag in ("this", "other",
                                                     "other", "this")]
        print(f"{label}: ms this {times[0]:.5f} {times[3]:.5f}, other "
              f"{times[1]:.5f} {times[2]:.5f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
