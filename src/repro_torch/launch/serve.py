"""Serving entry point: batched prefill, then a greedy (or sampled) decode
loop, on random weights made from ``--seed`` (``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b \\
        --batch 4 --prompt-len 2048 --gen 32            # on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --arch zamba2-2.7b --reduced

Prefill runs the flash-attention and ssm_scan kernels on the card (their
plain versions on the CPU); decode is plain torch.  Weights and prompt
tokens come from ``torch.Generator``s, so they differ from those of
``repro.launch.serve`` for the same seed.

Telemetry: ``--metrics-out PATH`` writes a Prometheus text exposition of
the serve latencies and throughput (``repro_serve_*`` gauges labelled
with the arch and batch), and ``--events-jsonl PATH`` appends the
prefill and decode events as JSONL, both through
:mod:`repro_torch.obs`'s exporters.  ``SpanTimer`` spans time the
synchronised prefill (``serve/prefill``) and each decode step's dispatch
(``serve/decode_step``).
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch import configs as C
from repro_torch.kernels import common as kc
from repro_torch.models import lm
from repro_torch.obs import JsonlLogger, SpanTimer, prometheus_text


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--metrics-out",
                    help="write Prometheus text exposition here on exit")
    ap.add_argument("--events-jsonl",
                    help="append per-phase span events here (JSONL)")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> torch.Tensor:
    """Serve one batch; returns the generated ids [batch, gen] (int32, on
    the device)."""
    args = parse_args(argv)
    device = kc.resolve_device(args.device)
    cfg = C.get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = lm.init(gen, cfg, device=device)
    b, s = args.batch, args.prompt_len
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                           device=device, dtype=torch.int32)

    timer = SpanTimer()
    events = []                      # (kind, fields) for --events-jsonl

    _sync(device)
    t0 = time.perf_counter()
    with timer.span("serve/prefill"), torch.no_grad():
        logits, cache = lm.prefill(cfg, params, {"tokens": tokens})
        cache = lm.pad_cache(cfg, cache, s + args.gen)
        _sync(device)
    t_prefill = time.perf_counter() - t0
    print(f"prefill: {b}x{s} in {t_prefill * 1e3:.1f} ms "
          f"({b * s / t_prefill:,.0f} tok/s)")
    events.append(("prefill", dict(batch=b, prompt_len=s,
                                   ms=t_prefill * 1e3)))

    def sample(lg):
        if args.temperature <= 0:
            return torch.argmax(lg, dim=-1).to(torch.int32)
        probs = torch.softmax(lg.float() / args.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)[:, 0].to(
            torch.int32)

    tok = sample(logits)
    out_tokens = [tok]
    t0 = time.perf_counter()
    with torch.no_grad():
        for i in range(args.gen - 1):
            with timer.span("serve/decode_step"):
                logits_i, cache = lm.decode(cfg, params, tok, cache, s + i)
                tok = sample(logits_i)
            out_tokens.append(tok)
    _sync(device)
    t_dec = time.perf_counter() - t0
    ids = torch.stack(out_tokens, dim=1)
    tok_s = b * args.gen / max(t_dec, 1e-9)
    print(f"decode: {args.gen} steps x batch {b} in {t_dec * 1e3:.1f} ms "
          f"({tok_s:,.0f} tok/s)")
    print("sample output ids:", ids[0][:16].tolist())
    events.append(("decode", dict(batch=b, steps=args.gen, ms=t_dec * 1e3,
                                  tok_s=tok_s)))
    if args.events_jsonl:
        with JsonlLogger(args.events_jsonl) as log:
            for kind, fields in events:
                log.emit(kind, **fields)
    if args.metrics_out:
        spans = timer.summary()
        flat = {
            "prefill_ms": t_prefill * 1e3,
            "prefill_tok_s": b * s / max(t_prefill, 1e-9),
            "decode_ms": t_dec * 1e3,
            "decode_tok_s": tok_s,
            "decode_ms_per_step":
                spans.get("serve/decode_step", {}).get("mean_ms", 0.0),
            "tokens_generated": b * args.gen,
        }
        with open(args.metrics_out, "w") as f:
            f.write(prometheus_text(
                flat, prefix="repro_serve",
                labels={"arch": args.arch, "batch": str(b)}))
        print(f"# metrics exposition -> {args.metrics_out}")
    return ids


if __name__ == "__main__":
    main()
