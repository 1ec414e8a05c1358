"""Per-cell (architecture × input shape) plans for the dry-run (the port
of ``repro.launch.specs``).

:func:`build_cell` assembles one cell on a mesh, branch by branch as the
reference's: the step function, a global ``meta`` tensor of the right
shape and dtype for every input (no allocation: the port's stand-in for
``jax.ShapeDtypeStruct``), and each input's spec, which cuts a rank's
block out of it (``sharding/rules.py`` ``local_block``; the port's
stand-in for placing an array by a ``NamedSharding``).  The step takes
the rank's blocks (:meth:`CellPlan.local_args`) and runs as that rank of
a ``DeviceMesh`` over the process group.

Shape semantics (the reference's):
  * ``train_*``   → ``make_train_step`` (forward, backward, AdamW,
    microbatches of gradient accumulation)
  * ``prefill_*`` → ``forward(mode="prefill", last_logit_only=True)``:
    the last position's logits and the cache
  * ``decode_*`` / ``long_*`` → ``decode_step``: ONE new token against a
    cache ``seq_len`` rows deep
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from repro_torch.configs.base import SHAPES, cell_supported, get_config
from repro_torch.models import transformer as tr
from repro_torch.models.common import spec_shapes
from repro_torch.sharding import rules as R
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_state import make_train_step

__all__ = ["CellPlan", "build_cell", "GRAD_ACCUM"]

# Grad-accumulation (microbatch) schedule per arch family for train_4k
# (the reference's): bigger models → more accumulation so the
# per-microbatch activation footprint fits HBM.
GRAD_ACCUM: dict[str, int] = {
    "qwen1.5-32b": 16,
    "internvl2-26b": 16,
    "llama4-scout-17b-a16e": 16,
    "minicpm3-4b": 8,
    "gemma-7b": 8,
    "gemma3-4b": 8,
    "mamba2-2.7b": 4,
    "olmoe-1b-7b": 2,
    "hubert-xlarge": 2,
    "hymba-1.5b": 2,
}


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _tree(fn, tree, *rest):
    """``fn`` over the leaves of a nested dict (and trees shaped as it)."""
    if isinstance(tree, dict):
        return {k: _tree(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


@dataclasses.dataclass
class CellPlan:
    """One cell: ``fn`` takes the rank's blocks of ``args`` (global
    ``meta`` tensors, nested dicts as the step takes them) under
    ``specs`` (a spec a leaf, the same nesting); ``meta`` has the
    reference's keys."""
    arch: str
    shape: str
    fn: Callable
    args: tuple
    meta: dict
    specs: tuple = ()
    mesh: object = None

    def local_args(self, coords=None) -> tuple:
        """The blocks of ``args`` that the rank at ``coords`` (``{axis:
        index}``; default this process's place on the mesh) holds: new
        ``meta`` tensors, so that each is a storage of its own."""
        coords = R.mesh_coords(self.mesh) if coords is None else coords
        return tuple(_tree(lambda t, spec: _meta(
            R.local_block(t, spec, self.mesh, coords).shape, t.dtype),
            a, s) for a, s in zip(self.args, self.specs))


def _batch(cfg, shape, mesh, rules, grad_accum: int):
    """Global ``meta`` tensors and specs of the input batch."""
    gb, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        mb = gb // grad_accum
        lead = (grad_accum, mb) if grad_accum > 1 else (mb,)
        bdim = 1 if grad_accum > 1 else 0
    else:
        lead, bdim = (gb,), 0
    if cfg.family == "encoder":
        batch = {"features": _meta(lead + (s, cfg.frontend_dim),
                                   torch.float32),
                 "labels": _meta(lead + (s,), torch.int32),
                 "label_mask": _meta(lead + (s,), torch.float32)}
    else:
        batch = {"tokens": _meta(lead + (s,), torch.int32)}
        if cfg.family == "vlm":
            batch["img_embeds"] = _meta(
                lead + (cfg.img_tokens, cfg.frontend_dim), torch.float32)
    specs = {k: R.batch_sharding(mesh, v.ndim, rules, batch_dim=bdim,
                                 batch_size=lead[bdim])
             for k, v in batch.items()}
    return batch, specs


def build_cell(arch: str, shape_name: str, mesh, *,
               rules: R.Rules | None = None,
               flags: tr.RunFlags | None = None,
               kv_dtype: str = "bf16") -> CellPlan:
    """The plan of cell ``arch`` × ``shape_name`` on ``mesh`` (a
    ``DeviceMesh`` over the process group's ranks): the reference's
    ``build_cell``.  Raises ``ValueError`` on a cell that
    ``cell_supported`` rejects.  The reference's ``donate`` has no
    counterpart: the port's train and decode steps update their state
    and cache in place."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, why = cell_supported(cfg, shape)
    if not ok:
        raise ValueError(f"cell {arch}×{shape_name} unsupported: {why}")
    # training shards params FSDP-style over (data × model); serving keeps
    # bf16 weights replicated across data replicas (no per-step gather).
    rules = rules or R.Rules(allow_uneven=False,
                             fsdp=(shape.kind == "train"))
    long_ctx = shape.name.startswith("long")
    flags = flags or tr.RunFlags(
        attn_impl="flash", remat=True, mesh=mesh,
        seq_shard_decode=long_ctx and cfg.family != "ssm")

    axes = tr.model_axes(cfg)
    shapes = spec_shapes(tr.model_specs(cfg))
    if shape.kind != "train":   # serving weights in bf16
        shapes = _tree(lambda sd: sd._replace(
            dtype=torch.bfloat16 if sd.dtype == torch.float32
            else sd.dtype), shapes)
    p_sh = R.param_shardings(mesh, axes, shapes, rules)
    params = _tree(lambda sd: _meta(sd.shape, sd.dtype), shapes)

    # 6·N per token for training (fwd+bwd), 2·N for forward-only serving
    flops_tok = tr.model_flops_per_token(cfg)
    if shape.kind != "train":
        flops_tok /= 3.0
    sizes = R.axis_sizes(mesh)
    meta = {"arch": arch, "shape": shape_name,
            "params": tr.count_params(cfg),
            "model_flops_per_token": flops_tok,
            "mesh": dict(sizes)}

    def plan(fn, args, specs):
        return CellPlan(arch, shape_name, fn, args, meta, specs, mesh)

    if shape.kind == "train":
        accum = GRAD_ACCUM.get(arch, 4)
        # the microbatch must still cover the batch mesh axes, or whole
        # pods silently replicate work
        bs_prod = math.prod(sizes[a] for a in ("pod", "data")
                            if a in sizes)
        accum = max(1, min(accum, shape.global_batch // bs_prod))
        batch, b_sh = _batch(cfg, shape, mesh, rules, accum)
        opt_cfg = AdamWConfig(total_steps=10_000)
        # compute copy: TP-only sharding (the FSDP gather hoisted out of
        # the accumulation loop); master grads reduce-scattered back to
        # the FSDP layout before AdamW
        nofsdp = dataclasses.replace(rules, fsdp=False)
        c_sh = R.param_shardings(mesh, axes, shapes, nofsdp)
        step_fn = make_train_step(cfg, opt_cfg, flags, grad_accum=accum,
                                  compute_shardings=c_sh,
                                  master_shardings=p_sh)

        def moments():      # f32, whatever the parameters' dtype
            return _tree(lambda sd: _meta(sd.shape, torch.float32), shapes)
        state = {"params": params,
                 "opt": {"mu": moments(), "nu": moments(),
                         "count": _meta((), torch.int32)},
                 "step": _meta((), torch.int32)}
        meta["grad_accum"] = accum
        meta["tokens_per_step"] = shape.global_batch * shape.seq_len
        return plan(step_fn, (state, batch), (step_fn.state_specs, b_sh))

    if shape.kind == "prefill":
        batch, b_sh = _batch(cfg, shape, mesh, rules, 1)

        def prefill_step(params, batch):
            logits, cache = tr.forward(params, batch, cfg, mode="prefill",
                                       flags=flags, last_logit_only=True)
            return logits[:, -1], cache

        meta["tokens_per_step"] = shape.global_batch * shape.seq_len
        return plan(prefill_step, (params, batch), (p_sh, b_sh))

    # decode
    gb, s = shape.global_batch, shape.seq_len
    cache = tr.init_cache(cfg, gb, s, kv_dtype=kv_dtype, device="meta")
    seq_shard = bool(flags.seq_shard_decode)
    c_sh = R.cache_shardings(mesh, cache, rules, seq_shard=seq_shard)
    tok = _meta((gb, 1), torch.int32)
    lens = _meta((gb,), torch.int32)
    tok_sh = R.batch_sharding(mesh, 2, rules, batch_size=gb) \
        if not seq_shard else ()
    len_sh = R.batch_sharding(mesh, 1, rules, batch_size=gb) \
        if not seq_shard else ()

    def serve_step(params, cache, tokens, lengths):
        return tr.decode_step(params, cache, tokens, lengths, cfg, flags)

    meta["tokens_per_step"] = gb
    meta["cache_len"] = s
    meta["seq_shard"] = seq_shard
    return plan(serve_step, (params, cache, tok, lens),
                (p_sh, c_sh, tok_sh, len_sh))
