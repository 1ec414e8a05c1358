"""Training launcher for the LLM stack (the port of
``repro.launch.train``).

On the card (the default ``--device cuda``; the train and prefill
attention through the flash-attention kernel, its backward a plain
recompute)::

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-7b \
        --preset tiny --steps 20

On the CPU (the kernels' plain versions; keep it tiny)::

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-7b \
        --preset tiny --steps 3 --batch 2 --seq 32 --device cpu

On a mesh (``--mesh DATA,MODEL``: that many ranks, spawned through
``launch.mesh.spawn`` and sharing the card, or on the CPU with
``--device cpu``)::

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-7b \
        --preset tiny --mesh 1,2

It composes ``init_train_state``, ``make_train_step`` (AdamW, the cosine
schedule, ``RunFlags(attn_impl="flash", remat=True)``), ``SyntheticLM``
batches through ``make_batch_fn`` and the fault-tolerant ``TrainLoop``
with checkpoints.  On a mesh the step takes the reference's
``build_cell`` shardings (:func:`train_shardings`: ``Rules(fsdp=True)``
masters, a tensor-parallel compute copy), the batch its rows
(``batch_sharding``), and rank 0 prints and writes the checkpoints.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import tempfile

import torch
import torch.distributed as dist

from repro_torch.configs.base import ArchConfig, get_config
from repro_torch.data.pipeline import SyntheticLM, make_batch_fn
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_local_mesh, spawn
from repro_torch.models import transformer as tr
from repro_torch.models.common import spec_shapes
from repro_torch.sharding import rules as R
from repro_torch.train.loop import LoopConfig, TrainLoop
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_state import init_train_state, make_train_step

__all__ = ["reduced_config", "train_shardings", "main"]


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


def train_shardings(cfg: ArchConfig, mesh, rules: R.Rules | None = None
                    ) -> tuple[dict, dict]:
    """``(compute, master)`` specs of ``cfg``'s parameters on ``mesh``, as
    the reference's ``build_cell`` builds a train cell's: the masters by
    ``rules`` (default ``Rules(fsdp=True)``), the compute copy by the
    same rules without FSDP (tensor-parallel only)."""
    rules = rules or R.Rules(fsdp=True)
    axes = tr.model_axes(cfg)
    shapes = spec_shapes(tr.model_specs(cfg))
    master = R.param_shardings(mesh, axes, shapes, rules)
    compute = R.param_shardings(mesh, axes, shapes,
                                dataclasses.replace(rules, fsdp=False))
    return compute, master


def _mesh_rank(argv, device: str) -> None:
    """One rank of ``--mesh``: :func:`main` with the process group up."""
    main(argv, _rank_device=device)


def main(argv=None, _rank_device: str | None = None
         ) -> tuple[TrainLoop, dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--preset", default="tiny",
                    choices=["tiny", "100m", "full"])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_lm_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the kernels) or cpu (their plain "
                         "versions)")
    ap.add_argument("--mesh", default=None,
                    help="DATA,MODEL: train on a mesh of that many ranks "
                         "(gloo; on the card all ranks share it)")
    argv = sys.argv[1:] if argv is None else list(argv)
    args = ap.parse_args(argv)

    if args.mesh and _rank_device is None:
        data, model = (int(v) for v in args.mesh.split(","))
        resolve_device(args.device)
        spawn(_mesh_rank, data * model, argv, args.device,
              device=args.device)
        return None, None
    dev = resolve_device(args.device)
    if _rank_device == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev.type == "cuda":
        # the reference sums bf16 products in f32 (forward refuses less)
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False
    cfg = reduced_config(args.arch, args.preset)
    lead = _rank_device is None or dist.get_rank() == 0
    log = print if lead else (lambda s: None)
    log(f"[train] arch={args.arch} preset={args.preset} "
        f"params={tr.count_params(cfg):,} device={dev}"
        + (f" mesh={args.mesh}" if args.mesh else ""))

    opt_cfg = AdamWConfig(peak_lr=args.lr, warmup_steps=20,
                          total_steps=args.steps)
    mesh = None
    shardings = {}
    if _rank_device is not None:
        data, model = (int(v) for v in args.mesh.split(","))
        mesh = make_local_mesh(data, model, device_type=dev.type)
        compute, master = train_shardings(cfg, mesh)
        shardings = dict(compute_shardings=compute, master_shardings=master)
    flags = tr.RunFlags(attn_impl="flash", remat=True, mesh=mesh)
    step_fn = make_train_step(cfg, opt_cfg, flags,
                              grad_accum=args.grad_accum, **shardings)
    state = init_train_state(cfg, torch.Generator(dev).manual_seed(args.seed))
    src = SyntheticLM(cfg, args.batch, args.seq, seed=args.seed,
                      microbatches=args.grad_accum)
    batch_kw = {"device": dev}
    if mesh is not None:
        state = R.shard_tree(state, step_fn.state_specs, mesh)
        lead_shape = (args.grad_accum, args.batch // args.grad_accum) \
            if args.grad_accum > 1 else (args.batch,)
        bdim = len(lead_shape) - 1
        batch_kw.update(mesh=mesh, shardings=R.batch_sharding(
            mesh, len(lead_shape) + 1, batch_dim=bdim,
            batch_size=lead_shape[bdim]))
    loop = TrainLoop(
        LoopConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                   ckpt_every=args.ckpt_every, log_every=1),
        step_fn, make_batch_fn(src, **batch_kw), state, log_fn=log)
    state = loop.run()
    log("[train] done")
    return loop, state


if __name__ == "__main__":
    main()
