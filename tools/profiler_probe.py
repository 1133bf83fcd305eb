"""How often torch.profiler records no device activity on the card, and
after what.

    PYTHONPATH=src python tools/profiler_probe.py [--sessions 40]

Card tests and ``chip_smoke.py`` read torch.profiler; now and then a
session recorded no device activity at all.  This probe opens
``--sessions`` profiler sessions (CPU and CUDA activities, as the tests
ask) around one small kernel each and counts the sessions without a
device event, in this order: in a fresh process; after a spawned child
that ran only CPU work (no CUDA call); after a spawned child that ran
CUDA work; after a spawned child that ran its own profiler session;
after a spawned child that joined an NCCL group of one rank (through a
file store) and ran an all-reduce, as the world-1 card test does.  Each
child reports whether its own session saw device activity.  Prints
one line per condition and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from repro_torch.kernels import common as kc


def empty_sessions(sessions: int) -> int:
    """Sessions, of ``sessions``, in which torch.profiler recorded no
    device event around one ``torch.add`` on the card."""
    x = torch.ones(1 << 20, device="cuda")
    empty = 0
    for _ in range(sessions):
        with torch.profiler.profile(
                activities=list(kc.PROFILER_ACTS)) as prof:
            torch.add(x, 1.0)
            torch.cuda.synchronize()
        empty += not any(kc.on_device(e) for e in prof.events())
    return empty


def _child(rank: int, kind: str, store: str, out: str) -> None:
    seen = None
    if kind == "cpu":
        a = torch.randn(512, 512)
        (a @ a).sum().item()
        Path(out).write_text(str(seen))
        return
    torch.cuda.set_device(0)
    if kind == "nccl":
        import torch.distributed as dist

        dist.init_process_group("nccl", init_method="file://" + store,
                                rank=0, world_size=1)
        t = torch.ones(16, device="cuda")
        dist.all_reduce(t)
        torch.cuda.synchronize()
        dist.destroy_process_group()
    elif kind == "profiled":
        seen = empty_sessions(1) == 0
    else:
        a = torch.randn(512, 512, device="cuda")
        (a @ a).sum().item()
    Path(out).write_text(str(seen))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sessions", type=int, default=40)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profiler_probe: no CUDA device", file=sys.stderr)
        return 2
    import torch.multiprocessing as mp

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    n = args.sessions
    print(f"[probe] fresh process: {empty_sessions(n)} of {n} sessions "
          f"without device activity")
    with tempfile.TemporaryDirectory() as tmp:
        for kind in ("cpu", "cuda", "profiled", "nccl"):
            out = f"{tmp}/{kind}.txt"
            mp.spawn(_child, args=(kind, f"{tmp}/store-{kind}", out),
                     nprocs=1, join=True)
            child = Path(out).read_text()
            print(f"[probe] after a spawned {kind} child (its own session "
                  f"saw device activity: {child}): {empty_sessions(n)} of "
                  f"{n} sessions without device activity")
    return 0


if __name__ == "__main__":
    sys.exit(main())
