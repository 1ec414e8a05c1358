"""AdamW, its learning-rate schedules and global-norm clipping (the port
of ``repro.train.optimizer``).

The math is the reference's, in its order: the gradients are clipped
by their global norm, the moments are bias-corrected, and the decoupled
weight decay applies to leaves of ``ndim >= 2`` only.  The moments are
f32 and ``count`` is an int32 scalar tensor.  Trees are nested dicts of
tensors, walked in sorted-key order (``train.checkpoint.tree_leaves``).

:func:`adamw_update` updates the parameters and the moments **in
place**, leaf by leaf, and returns the same tensors: the reference's
jitted step donates its state, so XLA updates it in place too, and a
functional update would hold a second copy of the parameters and both
moments (22.7 GB at Gemma-7B's full width with 4 of its 28 layers).

On a mesh (``specs`` and ``mesh`` given) each rank holds blocks:
:func:`global_norm` sums each leaf's squares over the ranks that hold
its distinct blocks, once, and :func:`adamw_update` updates the rank's
blocks, a ZeRO-1 moment's slice of its parameter block and the step
gathered back over ``data``, so the clip and the update are the
unsharded ones.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from repro_torch.sharding.collectives import (all_gather, all_reduce,
                                              axes_group)
from repro_torch.sharding.rules import spec_axes_used, spec_leaves
from repro_torch.train.checkpoint import tree_leaves

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "cosine_schedule",
           "global_norm", "linear_warmup"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    peak_lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def _steps(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def cosine_schedule(cfg: AdamWConfig) -> Callable[[torch.Tensor],
                                                  torch.Tensor]:
    """Linear warm-up to ``peak_lr``, then a cosine decay to
    ``min_lr_ratio * peak_lr`` at ``total_steps``; an f32 scalar on the
    step's device."""
    def lr(step):
        step = _steps(step)
        warm = torch.clamp(step / max(1, cfg.warmup_steps), max=1.0)
        t = torch.clamp((step - cfg.warmup_steps)
                        / max(1, cfg.total_steps - cfg.warmup_steps),
                        0.0, 1.0)
        cos = 0.5 * (1 + torch.cos(math.pi * t))
        frac = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos
        return cfg.peak_lr * warm * frac
    return lr


def linear_warmup(cfg: AdamWConfig) -> Callable[[torch.Tensor],
                                                torch.Tensor]:
    def lr(step):
        return cfg.peak_lr * torch.clamp(
            _steps(step) / max(1, cfg.warmup_steps), max=1.0)
    return lr


def adamw_init(params) -> dict:
    """Zero f32 moments shaped as ``params``, and ``count`` 0, on the
    parameters' device."""
    def zeros(tree):
        return {k: zeros(v) if isinstance(v, dict) else
                torch.zeros(v.shape, dtype=torch.float32, device=v.device)
                for k, v in tree.items()}
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else torch.device("cpu")
    return {"mu": zeros(params), "nu": zeros(params),
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree, specs: dict | None = None, mesh=None
                ) -> torch.Tensor:
    """sqrt of the sum over the leaves of their f32 sums of squares.
    With ``specs`` (a tree of specs shaped as ``tree``) on the
    ``DeviceMesh`` ``mesh``, ``tree`` holds this rank's blocks: the
    leaves' sums are summed over the group of the axes each leaf splits
    over (one ``all_reduce`` an axis set), so a split leaf counts all
    its blocks and a replicated one counts once."""
    leaves = tree_leaves(tree)
    if specs is None:
        return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                              for x in leaves))
    parts: dict = {}
    for x, spec in zip(leaves, spec_leaves(specs)):
        axes = spec_axes_used(spec)
        sq = torch.sum(torch.square(x.float()))
        parts[axes] = sq if axes not in parts else parts[axes] + sq
    total = 0.0
    for axes, sq in sorted(parts.items(), key=lambda kv: sorted(kv[0])):
        total = total + (sq if not axes else
                         all_reduce(sq, axes_group(mesh, axes), "+".join(
                             sorted(axes))))
    return torch.sqrt(total)


def _zero1_dim(p: torch.Tensor, mu: torch.Tensor) -> int | None:
    """The dim on which a moment block is a ``data`` slice of its
    parameter block (ZeRO-1, ``opt_state_shardings``), None where they
    are the same block."""
    diff = [i for i, (a, b) in enumerate(zip(p.shape, mu.shape)) if a != b]
    if len(diff) > 1 or (diff and p.shape[diff[0]] % mu.shape[diff[0]]):
        raise ValueError(f"a moment block {tuple(mu.shape)} is no data "
                         f"slice of its parameter block {tuple(p.shape)}")
    return diff[0] if diff else None


def adamw_update(params, grads, state: dict, cfg: AdamWConfig,
                 lr_fn: Callable | None = None, specs: dict | None = None,
                 mesh=None):
    """One AdamW step, in place.  Returns ``(params, state, stats)``:
    the same parameter tree and state dict, updated, and ``{"grad_norm",
    "lr"}`` as device scalars (no synchronisation).  With ``specs`` (the
    parameters' layout) on the ``DeviceMesh`` ``mesh``: ``params`` and
    ``grads`` are this rank's blocks, each moment the block
    ``opt_state_shardings`` gives it; the norm is the global one
    (:func:`global_norm`), and where a moment is a ``data`` slice of its
    parameter block the rank updates that slice and the step is
    gathered over ``data`` onto the whole block."""
    lr_fn = lr_fn or cosine_schedule(cfg)
    with torch.no_grad():
        count = state["count"]
        count.add_(1)
        gnorm = global_norm(grads, specs, mesh)
        scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                            max=1.0) if cfg.grad_clip > 0 else 1.0
        lr = lr_fn(count)
        n = count.to(torch.float32)
        bc1 = 1 - torch.pow(cfg.b1, n)
        bc2 = 1 - torch.pow(cfg.b2, n)
        for p, g, mu, nu in zip(tree_leaves(params), tree_leaves(grads),
                                tree_leaves(state["mu"]),
                                tree_leaves(state["nu"])):
            dim = None if specs is None else _zero1_dim(p, mu)
            whole = p
            if dim is not None:
                lo = mesh.get_local_rank("data") * mu.shape[dim]
                p, g = (t.narrow(dim, lo, mu.shape[dim]) for t in (p, g))
            g = g.float() * scale
            mu.mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)
            nu.mul_(cfg.b2).addcmul_(g, g, value=1 - cfg.b2)
            del g
            denom = torch.sqrt(nu / bc2).add_(cfg.eps)
            step = torch.div(mu, bc1).div_(denom)
            del denom
            if p.ndim >= 2:   # decoupled weight decay on matrices only
                step.add_(p.float(), alpha=cfg.weight_decay)
            step.mul_(lr)
            if dim is not None:
                p = whole
                step = all_gather(step, dim, mesh.get_group("data"), "data")
            if p.dtype == torch.float32:
                p.sub_(step)
            else:
                p.copy_(p.float() - step)
    return params, state, {"grad_norm": gnorm, "lr": lr}
