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
import dataclasses
import time

import torch

from repro_torch.configs.base import ArchConfig, get_config
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tr
from repro_torch.serve.engine import DecodeEngine, EngineConfig, Request

__all__ = ["reduced_config", "main"]


def reduced_config(arch: str, preset: str) -> ArchConfig:
    """``arch`` at the ``tiny`` or ``100m`` preset, or ``full`` as
    registered (a copy of ``repro.launch.train.reduced_config``)."""
    cfg = get_config(arch)
    if preset == "full":
        return cfg
    if preset == "tiny":
        over = dict(n_layers=2, d_model=128, d_ff=256, vocab=512)
        heads = dict(n_heads=4, n_kv_heads=min(cfg.n_kv_heads, 2) or 2,
                     head_dim=32)
    elif preset == "100m":
        over = dict(n_layers=12, d_model=768, d_ff=2048, vocab=32000)
        heads = dict(n_heads=12, n_kv_heads=min(cfg.n_kv_heads, 4) or 4,
                     head_dim=64)
    else:
        raise ValueError(preset)
    if cfg.n_heads:
        over.update(heads)
    if cfg.mla:
        over.update(q_lora_rank=over["d_model"] // 2,
                    kv_lora_rank=over["d_model"] // 4,
                    qk_nope_head_dim=32, qk_rope_head_dim=16,
                    v_head_dim=32)
    if cfg.moe:
        over.update(n_experts=8, top_k=min(cfg.top_k, 2),
                    expert_d_ff=over["d_ff"] // 4)
    if cfg.ssm:
        over.update(ssm_state=16, ssm_head_dim=32)
    if cfg.local_window:
        over.update(local_window=128)
    if cfg.global_layers:
        over.update(global_layers=(0, over["n_layers"] - 1))
    if cfg.img_tokens:
        over.update(img_tokens=16, frontend_dim=128)
    if cfg.frontend_dim and not cfg.img_tokens:
        over.update(frontend_dim=128)
    return dataclasses.replace(cfg, **over)


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
