"""What the bf16 windowed flash's tolerance in ``chip_smoke.py`` lets
through, on the CPU.

    python tools/window_tolerance.py [--heads 2] [--seq 8192] [--window 4096]

A bf16 flash kernel rounds P to bf16 before P V and rounds its output to
bf16; the rest is float32.  This script does the same on the CPU (q, k, v
bf16 draws of N(0, 1), D 80, causal with the window) and holds the result
against the float32 attention on the same inputs, as
``chip_smoke.compare_rows`` does on the card: rtol 2^-8 plus a share of
the rms of each element's own row.  It prints the largest share of that
tolerance an element uses for a right kernel and for kernels whose window
is one key or one 64-key tile off, at 2^-5 and 2^-6 of the row's rms,
and whether the earlier tolerance (2^-8 |want| + 2^-8 max |v|) would have
passed each.  A share above 1 fails the check."""
import argparse

import torch


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--heads", type=int, default=2)
    ap.add_argument("--seq", type=int, default=8192)
    ap.add_argument("--window", type=int, default=4096)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    gen = torch.Generator().manual_seed(args.seed)
    h, s, d, w = args.heads, args.seq, 80, args.window
    q, k, v = (torch.randn(1, h, s, d, generator=gen).bfloat16().float()
               for _ in range(3))
    i, j = torch.arange(s)[:, None], torch.arange(s)[None]
    scores = q @ k.transpose(-1, -2) / d**0.5

    def attend(window: int, kernel: bool) -> torch.Tensor:
        sc = scores.masked_fill(~((j <= i) & (i - j < window)),
                                float("-inf"))
        p = torch.exp(sc - sc.amax(-1, keepdim=True))
        l = p.sum(-1, keepdim=True)
        if not kernel:
            return (p @ v) / l
        return ((p.bfloat16().float() @ v) / l).bfloat16().double()

    want = attend(w, False).double()
    rms = want.pow(2).mean(-1, keepdim=True).sqrt()
    old_atol = 2**-8 * float(v.abs().max())
    print(f"[1, {h}, {s}, {d}] window {w}: mean |want| "
          f"{float(want.abs().mean()):.4g}, over rows with the whole window "
          f"{float(want[:, :, w:].abs().mean()):.4g} (rms "
          f"{float(rms[:, :, w:].mean()):.4g}); earlier atol {old_atol:.4g}")
    for name, window in (("right", w), ("window - 1", w - 1),
                         ("window + 1", w + 1), ("window - 64", w - 64),
                         ("window + 64", w + 64)):
        diff = (attend(window, True) - want).abs()
        excess = diff - 2**-8 * want.abs()
        shares = "  ".join(
            f"{label}: {float((excess / (frac * rms)).max()):.3g}"
            for label, frac in (("2^-5", 2**-5), ("2^-6", 2**-6)))
        print(f"{name:12s} share of the row tolerance  {shares}  earlier "
              f"tolerance passes: {bool((excess <= old_atol).all())}")


if __name__ == "__main__":
    main()
