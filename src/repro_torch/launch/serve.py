"""Serving launcher: batched decode with continuous batching (the port of
``repro.launch.serve``).

Example, on the CPU (the kernels' plain versions; keep it tiny)::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-7b \
        --preset tiny --device cpu

The default ``--device cuda`` runs on the card, the prefill attention
through the flash-attention kernel.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.device import resolve_device
from repro_torch.launch.train import reduced_config
from repro_torch.models import transformer as tr
from repro_torch.serve.engine import DecodeEngine, EngineConfig, Request

__all__ = ["reduced_config", "main"]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--preset", default="tiny")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the kernels) or cpu (their plain "
                         "versions)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        # the reference sums bf16 products in f32 (forward refuses less)
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False
    cfg = reduced_config(args.arch, args.preset)
    if not cfg.supports_decode:
        raise SystemExit(f"{args.arch} is encoder-only: no decode")
    params = tr.init(cfg, torch.Generator(dev).manual_seed(args.seed))
    ecfg = EngineConfig(n_slots=args.slots, max_len=64 + args.max_new,
                        max_new=args.max_new, temperature=args.temperature)
    engine = DecodeEngine(cfg, params, ecfg, seed=args.seed, device=dev)

    rng = torch.Generator().manual_seed(args.seed + 1)
    reqs = []
    for i in range(args.requests):
        plen = 4 + int(torch.randint(0, 12, (), generator=rng))
        reqs.append(Request(rid=i, prompt=list(range(1, plen + 1))))

    t0 = time.perf_counter()
    engine.run(reqs, max_steps=args.max_new * args.requests + 64)
    dt = time.perf_counter() - t0
    total_new = sum(len(r.generated) for r in reqs)
    for r in reqs:
        print(f"[serve] req {r.rid}: prompt={len(r.prompt)} "
              f"generated={r.generated[:8]}… ({len(r.generated)} tokens)")
    print(f"[serve] {total_new} tokens in {dt:.2f}s "
          f"({total_new / dt:.1f} tok/s, {engine.steps} engine steps) "
          f"on {dev}")
    return engine, reqs


if __name__ == "__main__":
    main()
