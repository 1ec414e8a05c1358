"""Train state assembly and the LLM train step, with microbatching (the
port of ``repro.train.train_state``).

The state is ``{"params": f32 masters, "opt": {"mu", "nu", "count"},
"step": int32 scalar}``, nested dicts of tensors on one device.  The
step differentiates the loss with respect to the f32 masters through
the activation-dtype cast of ``forward`` and updates the whole state in
place (``adamw_update``): the reference's jitted step donates its state.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tr
from repro_torch.models.common import init_tree
from repro_torch.train.checkpoint import tree_leaves, tree_unflatten
from repro_torch.train.optimizer import (AdamWConfig, adamw_init,
                                         adamw_update, cosine_schedule)

__all__ = ["init_train_state", "make_train_step"]


def init_train_state(cfg: ArchConfig, gen: torch.Generator,
                     opt_cfg: AdamWConfig | None = None) -> dict:
    """Random f32 master parameters drawn on ``gen``'s device (the card
    for a CUDA generator, never through host memory), zero AdamW
    moments and step 0.  The masters are f32 whatever the config's
    activation dtype: ``forward`` casts them at use."""
    resolve_device(gen.device)
    params = init_tree(gen, tr.model_specs(cfg), torch.float32)
    return {"params": params, "opt": adamw_init(params),
            "step": torch.zeros((), dtype=torch.int32, device=gen.device)}


def make_train_step(cfg: ArchConfig, opt_cfg: AdamWConfig,
                    flags: tr.RunFlags = tr.RunFlags(),
                    grad_accum: int = 1,
                    grad_transform: Callable | None = None,
                    compute_shardings=None, master_shardings=None):
    """Build ``train_step(state, batch) -> (state, metrics)``.

    ``grad_accum > 1``: the batch leaves carry a leading microbatch axis
    ``(A, mb, ...)``; the f32 gradient sums over the microbatches are
    divided by A, the loss is averaged and the metrics meaned, as the
    reference's ``lax.scan`` does, and memory scales with the
    microbatch.  ``grad_transform``: a hook on the mean gradient tree
    (e.g. ``train.compress.ErrorFeedbackState``), applied before
    ``adamw_update``.  The state is updated in place and returned.
    ``metrics``: ``loss``, ``aux_lb``, ``aux_z``, ``tokens``,
    ``grad_norm``, ``lr`` and ``total_loss``, device scalars.

    ``train_step.value_and_grad(params, batch) -> (total, metrics,
    grads)`` is the step's differentiation alone (before the hook and
    the update): ``grads`` is an f32 tree shaped as ``params``.

    ``compute_shardings`` and ``master_shardings`` place the compute
    copy and the gradients on a mesh in the reference; the mesh is not
    ported, so either raises."""
    if compute_shardings is not None or master_shardings is not None:
        raise NotImplementedError(f"compute_shardings and master_shardings: "
                                  f"{tr._ITEM_MESH}")
    lr_fn = cosine_schedule(opt_cfg)

    def grads_of(master, mb):
        leaves = [t.detach().requires_grad_() for t in tree_leaves(master)]
        params = tree_unflatten(master, leaves)
        total, metrics = tr.loss_fn(params, mb, cfg, flags)
        grads = torch.autograd.grad(total, leaves, materialize_grads=True)
        return total.detach(), {k: v.detach() for k, v in metrics.items()}, \
            list(grads)

    def value_and_grad(master, batch):
        if grad_accum == 1:
            total, metrics, grads = grads_of(master, batch)
        else:
            grads, total, per_mb = None, 0.0, []
            for a in range(grad_accum):
                l_a, m_a, g_a = grads_of(master, {k: v[a] for k, v in
                                                  batch.items()})
                if grads is None:
                    grads = g_a
                else:
                    for acc, g in zip(grads, g_a):
                        acc.add_(g)
                    del g_a
                total = total + l_a
                per_mb.append(m_a)
            grads = [g.div_(grad_accum) for g in grads]
            total = total / grad_accum
            metrics = {k: torch.stack([m[k] for m in per_mb]).mean()
                       for k in per_mb[0]}
        return total, metrics, tree_unflatten(master, grads)

    def train_step(state, batch):
        master = state["params"]
        total, metrics, grads = value_and_grad(master, batch)
        if grad_transform is not None:
            grads = grad_transform(grads)
        _, _, stats = adamw_update(master, grads, state["opt"], opt_cfg,
                                   lr_fn)
        del grads
        state["step"].add_(1)
        metrics = dict(metrics)
        metrics.update(stats)
        metrics["total_loss"] = total
        return state, metrics

    train_step.value_and_grad = value_and_grad
    return train_step
