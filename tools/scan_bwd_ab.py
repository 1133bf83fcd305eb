"""The scan's backward kernels of this tree in turns with other builds of
their source on one card.

    PYTHONPATH=src python tools/scan_bwd_ab.py [--backward heads|channel]
        [--variant NAME ...] [--other X.cu ...] [--time-only]

``--backward heads`` (the default): the per-head (chunked) backward,
``csrc/ssm_scan_bwd_chunked.cu``, at zamba2's training shape (x bf16 [4,
512, 5120], 80 heads of 64 channels, N 64, dy float32, no final-state
gradient) and on a ragged one (x float32 [2, 200, 640], 10 heads, with a
final-state gradient), held against ``ssm_scan_heads_bwd_ref``; the
per-channel ``ssm_scan_bwd`` is timed at the same shape with dt and A
broadcast.

``--backward channel``: the per-channel (general-A) backward,
``csrc/ssm_scan_bwd.cu``, at falcon-mamba-7b's training shape (x bf16 [4,
512, 8192], N 16, its published A = -(n + 1), no final-state gradient),
at zamba2's (x bf16 [4, 512, 5120], N 64, A per head of 64 channels) and
on a ragged mixed one (x float32 [2, 200, 640], N 16, A per head at even
channels and general at odd ones, with a final-state gradient), held
against ``ssm_scan_bwd_ref``.  A build whose source has
no chunk form (the parent's, say) runs through the walk form's entry
(``ops.ssm_scan_bwd_walk``), and an occupancy entry is added to its
source for the print.

Either way every gradient is held within 1e-4 of its largest (a bf16 dx
also within a bf16 ulp), two calls must give the same bits, and
torch.profiler gives each kernel's device time per call.  Each other
build is run through the tree's own wrapper (``kc.variant``), held and
timed the same way (``--time-only``: its errors printed, not held, for a
variant that drops part of the work to see its cost), by CUDA events
over a CUDA graph of 20 calls in the order this, other, other, this.
Other builds: ``--variant NAME``, the tree's source with one of the
edits in ``VARIANTS`` (the heads') or ``CHANNEL_VARIANTS``; ``--other
X.cu``, any source with the same C entry points (an earlier commit's).
Prints ptxas's registers and spills per instance, the resident warps an
SM of each kernel the shapes launch
(``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), and the card's name
and power limit.

``tools/scan_bwd_history/`` holds, as chains of patches, the earlier
forms of the sources: the per-head backward's (see its first patch's
header) and, under ``channel/``, the per-channel backward's.
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
                                              ssm_scan_bwd_ref,
                                              ssm_scan_heads_bwd_ref)

# label, (b, t, heads, P, N), x type, final-state gradient
SHAPES = [
    ("zamba2 training", (4, 512, 80, 64, 64), torch.bfloat16, False),
    ("ragged, x f32, dh", (2, 200, 10, 64, 64), torch.float32, True)]
KERNELS = ("ssm_scan_heads_dstate_kernel", "ssm_scan_heads_bwd_kernel")
SOURCE = kc.CSRC / "ssm_scan_bwd_chunked.cu"
# The per-channel backward: label, (b, t, di, N), x type, A, final-state
# gradient.
CHANNEL_SHAPES = [
    ("falcon-mamba training", (4, 512, 8192, 16), torch.bfloat16, "mamba1",
     False),
    ("zamba2's shape, A per head", (4, 512, 5120, 64), torch.bfloat16,
     "per_head", False),
    ("ragged, mixed A, x f32, dh", (2, 200, 640, 16), torch.float32, "mixed",
     True)]
CHANNEL_KERNELS = ("ssm_scan_bwd_carry_kernel", "ssm_scan_bwd_chunk_kernel",
                   "ssm_scan_bwd_kernel")
CHANNEL_SOURCE = kc.CSRC / "ssm_scan_bwd.cu"
# An occupancy entry for a source of ssm_scan_bwd.cu that has the walk
# form only: resident warps an SM of its instance for N and x's type.
WALK_OCCUPANCY = """
extern "C" int ssm_scan_bwd_resident_warps(int N, int x_bf16, int kernel) {
  if (kernel != 2) return -1;
  return for_states(N, [&](auto G, auto K) {
    using Sh = BwdShape<decltype(G)::value, decltype(K)::value>;
    const size_t smem = Sh::kXs * 4 + Sh::kXElems * (x_bf16 ? 2 : 4);
    auto at = [&](auto kernel) {
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
      int blocks = 0;
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                    Sh::kThreads, smem);
      return blocks * Sh::kThreads / 32;
    };
    return x_bf16 ? at(ssm_scan_bwd_kernel<__nv_bfloat16, decltype(G)::value,
                                           decltype(K)::value>)
                  : at(ssm_scan_bwd_kernel<float, decltype(G)::value,
                                           decltype(K)::value>);
  });
}
"""
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


# Variants of the per-channel source, as VARIANTS.
CHANNEL_VARIANTS = {
    # e = expf(dt A) in place of 2^(dt (A log2 e)).
    "expf": [("constexpr bool kExp2 = true;",
              "constexpr bool kExp2 = false;")],
    # exp2f (subnormal results kept) in place of ex2.approx.ftz.
    "exp2f": [('asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : '
               '"f"(__fmul_rn(dt, a)));', "e = exp2f(__fmul_rn(dt, a));")],
    # dB and dC added over the warps every 4 steps at every N.
    "r4": [("  static constexpr int kR = G >= 8 ? 4 : kTB;",
            "  static constexpr int kR = 4;")],
    # One block of 8 warps an SM, up to 255 registers a thread.
    "one_block": [("  static constexpr int kMinBlocks = 512 / kThreads;",
                   "  static constexpr int kMinBlocks = 1;")],
}


def variant_source(name: str, source: Path = SOURCE,
                   variants: dict = VARIANTS) -> Path:
    """The source with the edits of ``variants[name]``, written beside
    the tree's build."""
    text = source.read_text()
    for old, new in variants[name]:
        if text.count(old) != 1:
            raise RuntimeError(f"variant {name}: {old[:40]!r} is not in "
                               f"{source.name} exactly once")
        text = text.replace(old, new)
    out = kc.build_dir() / "variants" / f"{source.stem}_{name}.cu"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(text)
    return out


def with_occupancy(source: Path) -> Path:
    """A per-channel source as it is, or with ``WALK_OCCUPANCY`` added
    where it has no occupancy entry of its own."""
    text = Path(source).read_text()
    if "ssm_scan_bwd_resident_warps" in text:
        return Path(source)
    out = kc.build_dir() / "variants" / f"{Path(source).stem}_occupancy.cu"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(text + WALK_OCCUPANCY)
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


def channel_inputs(gen, b, t, di, n, x_type, kind, with_dh):
    """(x, dt, A, Bm, Cm, D, h_chunks, dy, dh) of the per-channel
    backward on the card, the checkpoints from the forward kernel; A
    falcon-mamba's published -(n + 1) ("mamba1"), per head of 64 channels
    ("per_head"), or per head at even channels and general at odd ones
    ("mixed")."""
    dev = gen.device
    randn = lambda *s: torch.randn(s, generator=gen, device=dev)  # noqa
    x = randn(b, t, di).to(x_type)
    dt = torch.nn.functional.softplus(randn(b, t, di) - 1.0)
    if kind == "mamba1":
        a = -torch.arange(1, n + 1, dtype=torch.float32,
                          device=dev).expand(di, n).contiguous()
    else:
        a_h = (-torch.exp(randn(-(-di // 64)) * 0.5)).repeat_interleave(64)
        odd = (a_h[:di, None].expand(di, n) if kind == "per_head"
               else -torch.exp(randn(di, n) * 0.5))
        a = torch.where((torch.arange(di, device=dev) % 2 == 0)[:, None],
                        a_h[:di, None].expand(di, n), odd).contiguous()
    bm, cm, d = randn(b, t, n), randn(b, t, n), randn(di)
    _, _, hc = scan.ssm_scan_fwd(x, dt, a, bm, cm, d, with_states=True)
    return (x, dt, a, bm, cm, d, hc, randn(b, t, di),
            randn(b, di, n) if with_dh else None)


def check(label: str, got, want, names=("dx", "ddt_h", "da_h", "dB", "dC",
                                         "dD")) -> float:
    """The largest error over the gradients as a share of each one's
    largest |want|; raises beyond 1e-4 (a bf16 dx also one bf16 ulp)."""
    worst = 0.0
    for name, a, w in zip(names, got, want):
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


def kernel_ms(fn, iters: int = 10, kernels=KERNELS) -> dict:
    """Device ms per call of each of ``kernels`` (torch.profiler)."""
    fn()
    torch.cuda.synchronize()

    def window():
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()

    prof, _ = kc.profiled(window, "scan_bwd_ab")
    out = {}
    for evt in prof.key_averages():
        for name in kernels:
            t = getattr(evt, "device_time_total", 0.0)
            if name in evt.key and t > 0:
                out[name] = out.get(name, 0.0) + t / iters / 1e3
    return out


def ptxas_lines(log: str) -> list[str]:
    return [line.strip() for line in log.splitlines()
            if any(w in line for w in ("entry function", "registers",
                                       "spill"))]


def time_in_turns(label: str, runs: dict, others) -> None:
    """Each other build in turns with this tree's: this, other, other,
    this, by CUDA events over a CUDA graph."""
    order = ["this"]
    for tag in others:
        order += ["this", tag, tag, "this"]
    times = [(tag, kc.graph_ms(runs[tag])) for tag in order]
    print(f"[ab] {label}: ms " + ", ".join(f"{tag} {ms:.5f}"
                                           for tag, ms in times))


def hold(label, tag, run, want, names, args, others, kernels) -> None:
    """Two calls of ``run``: held against ``want`` (printed only, for an
    other build under --time-only), the same bits, and the kernels'
    device ms."""
    got, again = run(), run()
    torch.cuda.synchronize()
    try:
        err = check(f"{label} [{tag}]", got, want, names)
    except AssertionError as e:
        if not (args.time_only and tag in others):
            raise
        print(f"[ab] {label} [{tag}] not held: {e}")
        err = float("nan")
    if not all(torch.equal(g, a) for g, a in zip(got, again)):
        raise AssertionError(f"{label} [{tag}]: two calls differ")
    print(f"[ab] {label} [{tag}]: worst error {err:.3g} of a gradient's "
          f"largest, two calls the same bits; kernels ms "
          f"{kernel_ms(run, kernels=kernels)}")


def heads_main(args, dlls) -> None:
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
        label = f"{label} {tuple(xs[0].shape)}"
        for tag, run in runs.items():
            hold(label, tag, run, want, ("dx", "ddt_h", "da_h", "dB", "dC",
                                         "dD"), args, dlls, KERNELS)
        del want
        time_in_turns(label, runs, dlls)
        dt, a = heads_to_channels(xs[1], xs[2], p, n)
        old = (xs[0], dt, a) + xs[3:]
        print(f"[ab] {label}: per-channel ssm_scan_bwd ms "
              f"{kc.graph_ms(lambda: scan.ssm_scan_bwd(*old)):.5f}")
        del xs, old, runs
        torch.cuda.empty_cache()


def channel_main(args, dlls) -> None:
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    for label, (b, t, di, n), x_type, kind, with_dh in CHANNEL_SHAPES:
        xs = channel_inputs(gen, b, t, di, n, x_type, kind, with_dh)
        bf16 = x_type == torch.bfloat16
        want = ssm_scan_bwd_ref(*xs)
        label = f"{label} {tuple(xs[0].shape)} N {n}"
        print(f"[ab] {label} [this]: route {scan.bwd_route(n)}, resident "
              f"warps an SM {scan.bwd_resident_warps(n, bf16)}")
        runs = {"this": lambda: scan.ssm_scan_bwd(*xs)}
        for tag, dll in dlls.items():
            chunks = hasattr(dll, "ssm_scan_bwd_chunks_launch")
            form = scan.ssm_scan_bwd if chunks else scan.ssm_scan_bwd_walk

            def run(dll=dll, form=form):
                with kc.variant(scan.BWD_NAME, dll):
                    return form(*xs)
            runs[tag] = run
            with kc.variant(scan.BWD_NAME, dll):
                warps = (scan.bwd_resident_warps(n, bf16) if chunks else
                         {"ssm_scan_bwd_kernel": kc.kernel_fn(
                             scan.BWD_NAME, "ssm_scan_bwd_resident_warps",
                             [kc.I] * 3)(n, int(bf16), 2)})
            print(f"[ab] {label} [{tag}]: "
                  f"{'chunk' if chunks else 'walk'} form, resident warps "
                  f"an SM {warps}")
        for tag, run in runs.items():
            hold(label, tag, run, want, ("dx", "ddt", "dA", "dB", "dC",
                                         "dD"), args, dlls, CHANNEL_KERNELS)
        del want
        time_in_turns(label, runs, dlls)
        del xs, runs
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--backward", choices=("heads", "channel"),
                    default="heads", help="which backward to run")
    ap.add_argument("--variant", nargs="*", default=[],
                    choices=sorted(VARIANTS) + sorted(CHANNEL_VARIANTS),
                    help="edits of the tree's source to build and time")
    ap.add_argument("--other", type=Path, nargs="*", default=[],
                    help="other builds of the backward's source")
    ap.add_argument("--time-only", action="store_true",
                    help="print the other builds' errors, do not hold them")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("scan_bwd_ab: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    channel = args.backward == "channel"
    source, variants = ((CHANNEL_SOURCE, CHANNEL_VARIANTS) if channel
                        else (SOURCE, VARIANTS))
    out = kc.build(("ssm_scan", "ssm_scan_bwd", "ssm_scan_bwd_chunked"))
    for line in ptxas_lines((out / f"{source.stem}.log").read_text()):
        print(f"[ab] ptxas: {line}")
    sources = {name: variant_source(name, source, variants)
               for name in args.variant}
    sources.update({f"other {i} ({src.name})": src
                    for i, src in enumerate(args.other)})
    dlls = {}
    for tag, src in sources.items():
        dlls[tag], log = kc.build_variant(with_occupancy(src) if channel
                                          else src)
        print(f"[ab] {tag}: ptxas\n" + "\n".join(ptxas_lines(log)))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    (channel_main if channel else heads_main)(args, dlls)
    return 0


if __name__ == "__main__":
    sys.exit(main())
