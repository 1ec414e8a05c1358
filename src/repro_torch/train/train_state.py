"""Train state assembly and the LLM train step, with microbatching (the
port of ``repro.train.train_state``).

The state is ``{"params": f32 masters, "opt": {"mu", "nu", "count"},
"step": int32 scalar}``, nested dicts of tensors on one device.  The
step differentiates the loss with respect to the f32 masters through
the activation-dtype cast of ``forward`` and updates the whole state in
place (``adamw_update``): the reference's jitted step donates its state.

On a mesh (``compute_shardings`` / ``master_shardings``, with
``flags.mesh``) every rank holds its blocks of the state and its rows of
the batch, and the step does what the reference's GSPMD step does with
its sharding constraints: the f32 masters (FSDP-sharded over ``data``)
are gathered over ``data`` to the compute layout (tensor-parallel only)
and cast to the activation dtype; the loss is differentiated with
respect to that compute copy; the gradients, carried in f32, are
averaged over ``data`` and cut back to the masters' blocks (a
reduce-scatter), and on a mesh with a ``pod`` axis (the reference's
multi-pod mesh, whose pods hold replicas of the state) also averaged
over the pods; AdamW updates the rank's blocks.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tr
from repro_torch.models.common import init_tree, spec_shapes
from repro_torch.sharding.collectives import (all_gather, all_reduce,
                                              reduce_scatter)
from repro_torch.sharding.rules import axis_sizes, spec_leaves, zero1_spec
from repro_torch.train.checkpoint import tree_leaves, tree_unflatten
from repro_torch.train.optimizer import (AdamWConfig, adamw_init,
                                         adamw_update, cosine_schedule)

__all__ = ["init_train_state", "make_train_step", "moment_specs",
           "state_specs", "average_over_data", "average_over_pods"]


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

    ``compute_shardings`` and ``master_shardings`` (trees of specs, as
    ``sharding.rules.param_shardings`` gives them: the reference's
    ``build_cell`` builds the first without and the second with
    ``Rules(fsdp=True)``) run the step on ``flags.mesh``, a
    ``DeviceMesh`` over the process group (module docstring): ``state``
    holds the rank's blocks (``params`` by ``master_shardings``, the
    moments by :func:`moment_specs`; ``sharding.rules.shard_tree`` of
    the whole state by ``train_step.state_specs``) and
    ``batch`` the rank's rows (``make_batch_fn(shardings=...)``; with
    ``grad_accum > 1`` the batch is split on dim 1).  Either alone takes
    the other's layout.  ``train_step.mesh`` is the mesh and
    ``train_step.state_specs`` the state's layout (None unsharded),
    which ``TrainLoop`` reads to save and restore the state whole."""
    lr_fn = cosine_schedule(opt_cfg)
    mesh = None
    if compute_shardings is not None or master_shardings is not None:
        if flags.mesh is None:
            raise ValueError("compute_shardings / master_shardings place "
                             "the step on a mesh: give RunFlags(mesh=...)")
        mesh = flags.mesh
        tr.check_mesh(cfg, mesh)
        compute_shardings = compute_shardings or master_shardings
        master_shardings = master_shardings or compute_shardings
        c_specs = spec_leaves(compute_shardings)
        m_specs = spec_leaves(master_shardings)
        data = mesh.get_group("data")
        n_data = axis_sizes(mesh)["data"]
        # a mesh with a pod axis: the pods hold replicas of the state
        n_pod = axis_sizes(mesh).get("pod", 1)
        pod = mesh.get_group("pod") if n_pod > 1 else None

    def gathered(t, c_spec, m_spec):
        """A master block gathered over ``data`` to the compute layout."""
        for dim, (c, m) in enumerate(zip(c_spec + (None,) * t.ndim,
                                         m_spec)):
            if m == "data" and c != "data":
                t = all_gather(t, dim, data, "data")
        return t

    def grads_of(master, mb):
        if mesh is None:
            leaves = [t.detach().requires_grad_()
                      for t in tree_leaves(master)]
        else:
            dt = cfg.activation_dtype
            with torch.no_grad():
                leaves = [gathered(t, c, m).to(dt).detach()
                          for t, c, m in zip(tree_leaves(master), c_specs,
                                             m_specs)]
            leaves = [t.requires_grad_() for t in leaves]
        params = tree_unflatten(master, leaves)
        total, metrics = tr.loss_fn(params, mb, cfg, flags)
        grads = torch.autograd.grad(total, leaves, materialize_grads=True)
        if mesh is not None:
            grads = [g.float() for g in grads]
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
        if mesh is not None and (n_data > 1 or pod is not None):
            # leaf by leaf, each whole gradient freed as its block lands
            for i, (c, m) in enumerate(zip(c_specs, m_specs)):
                if n_data > 1:
                    grads[i] = average_over_data(grads[i], c, m, data,
                                                 n_data)
                if pod is not None:
                    grads[i] = average_over_pods(grads[i], pod, n_pod)
        return total, metrics, tree_unflatten(master, grads)

    def train_step(state, batch):
        master = state["params"]
        total, metrics, grads = value_and_grad(master, batch)
        if grad_transform is not None:
            grads = grad_transform(grads)
        _, _, stats = adamw_update(
            master, grads, state["opt"], opt_cfg, lr_fn,
            specs=None if mesh is None else master_shardings, mesh=mesh)
        del grads
        state["step"].add_(1)
        metrics = dict(metrics)
        metrics.update(stats)
        metrics["total_loss"] = total
        return state, metrics

    train_step.value_and_grad = value_and_grad
    train_step.mesh = mesh
    train_step.state_specs = None if mesh is None \
        else state_specs(cfg, master_shardings, mesh)
    return train_step


def average_over_data(g: torch.Tensor, c_spec: tuple, m_spec: tuple,
                      group, n: int) -> torch.Tensor:
    """The ``n`` data ranks' f32 gradients ``g`` of a compute block
    averaged, cut to the master block (``m_spec`` adds ``data`` to
    ``c_spec`` on the FSDP dim: a reduce-scatter), else whole (an
    ``all_reduce``)."""
    dims = [d for d, (c, m) in enumerate(zip(c_spec + (None,) * g.ndim,
                                             m_spec))
            if m == "data" and c != "data"]
    g = reduce_scatter(g, group, dims[0]) if dims \
        else all_reduce(g, group, "data")
    return g.div_(n)


def average_over_pods(g: torch.Tensor, group, n: int) -> torch.Tensor:
    """The ``n`` pods' f32 gradients ``g`` of one block averaged (the
    pods hold replicas of the state): an ``all_reduce``."""
    return all_reduce(g, group, "pod").div_(n)


def state_specs(cfg: ArchConfig, master_shardings: dict, mesh) -> dict:
    """The layout of a mesh step's state: the masters by
    ``master_shardings``, the moments by :func:`moment_specs`, the
    counters replicated."""
    moments = moment_specs(cfg, master_shardings, mesh)
    return {"params": master_shardings,
            "opt": {"mu": moments, "nu": moments, "count": ()}, "step": ()}


def moment_specs(cfg: ArchConfig, master_shardings: dict, mesh) -> dict:
    """The moments' layout: ZeRO-1 on top of each master spec
    (``sharding.rules.zero1_spec``, the reference's default ``zero1``)."""
    shapes = spec_shapes(tr.model_specs(cfg))

    def walk(specs, shapes_):
        return {k: (walk(v, shapes_[k]) if isinstance(v, dict)
                    else zero1_spec(tuple(v), tuple(shapes_[k].shape),
                                    mesh))
                for k, v in specs.items()}
    return walk(master_shardings, shapes)
