"""MoE token dispatch on the paper's bucket machinery (the port of
``examples/moe_routing.py``).

The same rank-within-bucket rule packs pulse events into per-destination
buckets and tokens into per-expert capacity slabs, with the same overflow
accounting.  First a capacity-factor sweep of one MoE layer of the
reduced granite-moe-1b-a400m (capacity, dropped share, bucket
utilisation, aux loss), then the check that the event path's
``compute_slots`` and the token path's ``compute_slots_sorted`` give the
same slots and counts on one stream of expert choices.

    PYTHONPATH=src python -m repro_torch.moe_routing               # card
    PYTHONPATH=src python -m repro_torch.moe_routing --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses

import torch

from repro_torch import configs as C
from repro_torch.core import buckets as bk
from repro_torch.kernels import common as kc
from repro_torch.models import lm, moe

FACTORS = (2.0, 1.0, 0.5, 0.25)


def sweep(cfg, params: dict, x: torch.Tensor,
          factors=FACTORS) -> list[dict]:
    """One MoE layer (``params``: its leaves, no repeat axis) on x [B, S,
    d] at each capacity factor: a row of capacity and the layer's
    metrics as floats."""
    rows = []
    with torch.no_grad():
        for cf in factors:
            c = dataclasses.replace(cfg, capacity_factor=cf)
            _, metrics = moe.moe_apply(c, params, x)
            rows.append(dict(capacity_factor=cf,
                             capacity=moe.capacity(c, x.shape[0] * x.shape[1]),
                             **{k: float(v) for k, v in metrics.items()}))
    return rows


def same_slots(dest: torch.Tensor, n_buckets: int) -> bool:
    """``compute_slots`` (events) and ``compute_slots_sorted`` (tokens)
    agree on every slot and count of the all-valid stream ``dest``."""
    valid = torch.ones_like(dest, dtype=torch.bool)
    s1, c1 = bk.compute_slots(dest, valid, n_buckets)
    s2, c2 = bk.compute_slots_sorted(dest, valid, n_buckets)
    return bool(torch.equal(s1, s2)) and bool(torch.equal(c1, c2))


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = kc.resolve_device(args.device)
    cfg = C.get("granite-moe-1b-a400m").reduced()
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = lm.init(gen, cfg, device=device)
    layer = {k: v[0] for k, v in params["blocks"]["pos0"]["moe"].items()}
    x = torch.randn((4, 32, cfg.d_model), generator=gen, device=device)

    print(f"{cfg.n_experts} experts, top-{cfg.top_k}, "
          f"capacity factor {cfg.capacity_factor}")
    rows = sweep(cfg, layer, x)
    for r in rows:
        print(f"  cf={r['capacity_factor']:4.2f}: capacity={r['capacity']:4d}"
              f"  dropped={r['drop_fraction']:.3f}  "
              f"bucket_util={r['bucket_utilization']:.3f}  "
              f"aux_loss={r['aux_loss']:.3f}")

    print("\nsame slot contract, pulse events vs tokens:")
    dest = torch.randint(0, cfg.n_experts, (64,), generator=gen,
                         device=device, dtype=torch.int32)
    if not same_slots(dest, cfg.n_experts):
        raise AssertionError("compute_slots and compute_slots_sorted differ")
    print("  compute_slots (events) == compute_slots_sorted (tokens, "
          "sort-based): VERIFIED")
    return rows


if __name__ == "__main__":
    main()
