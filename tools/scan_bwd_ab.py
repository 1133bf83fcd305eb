"""The per-head (chunked) scan backward of this tree in turns with other
builds of its source on one card, beside the per-channel backward at the
same shape.

    PYTHONPATH=src python tools/scan_bwd_ab.py [--variant NAME ...]
        [--other X.cu ...] [--time-only]

At zamba2's training shape (x bf16 [4, 512, 5120], 80 heads of 64
channels, N 64, dy float32, no final-state gradient) and on a ragged one
(x float32 [2, 200, 640], 10 heads, with a final-state gradient),
``ssm_scan_heads_bwd`` is held against ``ssm_scan_heads_bwd_ref`` (every
gradient within 1e-4 of its largest, a bf16 dx also within a bf16 ulp),
two calls must give the same bits, and torch.profiler gives each
kernel's device time per call.  Each other build is run through the
tree's own wrapper (``kc.variant``), held and timed the same way
(``--time-only``: its errors printed, not held, for a variant that drops
part of the work to see its cost), by CUDA events over a CUDA graph of
20 calls in the order this, other, other, this.  Other builds:
``--variant NAME``, the tree's ``csrc/ssm_scan_bwd_chunked.cu`` with one
of the edits in ``VARIANTS``; ``--other X.cu``, any source with the same
C entry points (an earlier commit's).  The per-channel ``ssm_scan_bwd``
(``SSMScan``'s backward) is timed at the same shape with dt and A
broadcast.  Prints ptxas's registers and spills per instance and the
card's name and power limit.

``tools/scan_bwd_history/`` holds, as a chain of patches, the earlier
forms of the source that the grid, the group of heads and the product
form were chosen against (see its first patch's header).
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import torch

from repro_torch.kernels import common as kc
from repro_torch.kernels.ssm_scan import ops as scan
from repro_torch.kernels.ssm_scan.ref import (heads_to_channels,
                                              ssm_scan_heads_bwd_ref)

# label, (b, t, heads, P, N), x type, final-state gradient
SHAPES = [
    ("zamba2 training", (4, 512, 80, 64, 64), torch.bfloat16, False),
    ("ragged, x f32, dh", (2, 200, 10, 64, 64), torch.float32, True)]
KERNELS = ("ssm_scan_heads_dstate_kernel", "ssm_scan_heads_bwd_kernel")
SOURCE = kc.CSRC / "ssm_scan_bwd_chunked.cu"
_PRODUCT = """\
      if constexpr (kExactA) {
        sm::mma_tf32(acc[j], ah, bl);
        sm::mma_tf32(acc[j], ah, bh);
      } else if constexpr (kExactB) {
        sm::mma_tf32(acc[j], al, bh);
        sm::mma_tf32(acc[j], ah, bh);
      } else {
        sm::mma_tf32x3(acc[j], ah, al, bh, bl);
      }
"""
# Variants of the tree's source: (text, its replacement), each text found
# once.  "one_tf32" and "no_products" give wrong results and are for
# --time-only: the cost of the lo products, and of the products at all
# (each operand still read and split).
VARIANTS = {
    "heads8": [("constexpr int kGroup = 5;", "constexpr int kGroup = 8;")],
    "heads10": [("constexpr int kGroup = 5;", "constexpr int kGroup = 10;")],
    "bf16_lo": [("constexpr bool kBf16 = sizeof(TX) == 2;",
                 "constexpr bool kBf16 = false;")],
    "one_tf32": [(_PRODUCT, "        sm::mma_tf32(acc[j], ah, bh);\n")],
    "no_products": [(_PRODUCT, "        acc[j][0] += static_cast<float>("
                               "(ah[0] ^ al[1] ^ bh[0] ^ bl[1]) & 1u);\n")],
}


def variant_source(name: str) -> Path:
    """The tree's source with the edits of ``VARIANTS[name]``, written
    beside the tree's build."""
    text = SOURCE.read_text()
    for old, new in VARIANTS[name]:
        if text.count(old) != 1:
            raise RuntimeError(f"variant {name}: {old[:40]!r} is not in "
                               f"{SOURCE.name} exactly once")
        text = text.replace(old, new)
    out = kc.build_dir() / "variants" / f"ssm_scan_bwd_chunked_{name}.cu"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(text)
    return out


def inputs(gen, b, t, nh, p, n, x_type, with_dh):
    """(x, dt_h, a_h, Bm, Cm, D, h_chunks, dy, dh) on the card, the
    checkpoints from the forward kernel."""
    dev = gen.device
    randn = lambda *s: torch.randn(s, generator=gen, device=dev)  # noqa
    x = randn(b, t, nh * p).to(x_type)
    dt_h = torch.nn.functional.softplus(randn(b, t, nh) - 1.0)
    a_h = -torch.exp(randn(nh) * 0.5)
    bm, cm, d = randn(b, t, n), randn(b, t, n), randn(nh * p)
    dt, a = heads_to_channels(dt_h, a_h, p, n)
    _, _, hc = scan.ssm_scan_fwd(x, dt, a, bm, cm, d, with_states=True)
    dy = randn(b, t, nh * p)
    return (x, dt_h, a_h, bm, cm, d, hc, dy,
            randn(b, nh * p, n) if with_dh else None)


def check(label: str, got, want) -> float:
    """The largest error over the gradients as a share of each one's
    largest |want|; raises beyond 1e-4 (a bf16 dx also one bf16 ulp)."""
    worst = 0.0
    for name, a, w in zip(("dx", "ddt_h", "da_h", "dB", "dC", "dD"), got,
                          want):
        if a.shape != w.shape or not bool(torch.isfinite(a).all()):
            raise AssertionError(f"{label}: {name} {tuple(a.shape)} is not "
                                 f"finite or not {tuple(w.shape)}")
        diff, ref = (a.double() - w.double()).abs(), w.double().abs()
        scale = max(float(ref.max()), 1e-30)
        ulp = 2**-7 if w.dtype == torch.bfloat16 else 0.0
        if bool((diff > 1e-4 * scale + ulp * ref).any()):
            raise AssertionError(f"{label}: {name} off by "
                                 f"{float(diff.max()) / scale:.3g} of its "
                                 f"largest")
        worst = max(worst, float(diff.max()) / scale)
    return worst


def kernel_ms(fn, iters: int = 10) -> dict:
    """Device ms per call of each of ``KERNELS`` (torch.profiler)."""
    fn()
    torch.cuda.synchronize()

    def window():
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()

    prof, _ = kc.profiled(window, "scan_bwd_ab")
    out = {}
    for evt in prof.key_averages():
        for name in KERNELS:
            t = getattr(evt, "device_time_total", 0.0)
            if name in evt.key and t > 0:
                out[name] = out.get(name, 0.0) + t / iters / 1e3
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variant", nargs="*", default=[], choices=VARIANTS,
                    help="edits of the tree's source to build and time")
    ap.add_argument("--other", type=Path, nargs="*", default=[],
                    help="other builds of ssm_scan_bwd_chunked.cu")
    ap.add_argument("--time-only", action="store_true",
                    help="print the other builds' errors, do not hold them")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("scan_bwd_ab: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    out = kc.build(("ssm_scan", "ssm_scan_bwd", "ssm_scan_bwd_chunked"))
    for line in (out / "ssm_scan_bwd_chunked.log").read_text().splitlines():
        if any(w in line for w in ("entry function", "registers", "spill")):
            print(f"[ab] ptxas: {line.strip()}")
    sources = {name: variant_source(name) for name in args.variant}
    sources.update({f"other {i} ({src.name})": src
                    for i, src in enumerate(args.other)})
    dlls = {}
    for tag, src in sources.items():
        dlls[tag], log = kc.build_variant(src)
        print(f"[ab] {tag}: ptxas\n{log}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    for label, (b, t, nh, p, n), x_type, with_dh in SHAPES:
        xs = inputs(gen, b, t, nh, p, n, x_type, with_dh)
        want = ssm_scan_heads_bwd_ref(*xs)
        runs = {"this": lambda: scan.ssm_scan_heads_bwd(*xs)}
        for tag, dll in dlls.items():
            def run(dll=dll):
                with kc.variant(scan.HEADS_BWD_NAME, dll):
                    return scan.ssm_scan_heads_bwd(*xs)
            runs[tag] = run
        for tag, run in runs.items():
            got, again = run(), run()
            torch.cuda.synchronize()
            try:
                err = check(f"{label} [{tag}]", got, want)
            except AssertionError as e:
                if not (args.time_only and tag in dlls):
                    raise
                print(f"[ab] {label} [{tag}] not held: {e}")
                err = float("nan")
            if not all(torch.equal(g, a) for g, a in zip(got, again)):
                raise AssertionError(f"{label} [{tag}]: two calls differ")
            print(f"[ab] {label} {tuple(xs[0].shape)} [{tag}]: worst error "
                  f"{err:.3g} of a gradient's largest, two calls the same "
                  f"bits; kernels ms {kernel_ms(run)}")
        del want
        order = ["this"]
        for tag in dlls:
            order += ["this", tag, tag, "this"]
        times = [(tag, kc.graph_ms(runs[tag])) for tag in order]
        print(f"[ab] {label}: ms " + ", ".join(f"{tag} {ms:.5f}"
                                               for tag, ms in times))
        dt, a = heads_to_channels(xs[1], xs[2], p, n)
        old = (xs[0], dt, a) + xs[3:]
        print(f"[ab] {label}: per-channel ssm_scan_bwd ms "
              f"{kc.graph_ms(lambda: scan.ssm_scan_bwd(*old)):.5f}")
        del xs, old, runs
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
