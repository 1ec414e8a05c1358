"""Logical-axis → mesh-axis sharding rules (the port of
``repro.sharding.rules``).

Model parameters carry *logical* axis names (``models/common.PSpec``;
``models.transformer.model_axes`` gives the tree of them).  This module
maps them onto a mesh's axes, with the reference's rules:

* a default table (tensor-parallel over ``model``, replicated
  elsewhere), :data:`DEFAULT_TABLE`;
* divisibility checking with a fallback to replication (``allow_uneven``
  keeps the axis where the reference lets GSPMD pad);
* ZeRO-1 sharding of the optimizer moments over ``data``
  (:func:`opt_state_shardings`) and, with ``fsdp``, of the parameters'
  ``"embed"`` dims (:data:`FSDP_TABLE`);
* the batch over ``("pod", "data")`` (:func:`batch_sharding`) and the
  KV/SSM cache's layout (:func:`cache_shardings`), its sequence over
  ``data`` for the sequence-sharded decode.

A spec is a plain tuple with one entry a dim, as ``PartitionSpec``'s:
``None`` (replicated), an axis name, or a tuple of names; trailing
``None`` entries are dropped, as the reference drops them.  The
functions read only the mesh's axis sizes (:func:`axis_sizes`): a
``DeviceMesh`` with its ``mesh_dim_names``, the
``(data, model)`` pair of ``launch.mesh.mesh_shape``, or any object with
a ``shape`` mapping of axis name to size (the reference tests'
``FakeMesh``).  :func:`local_block` cuts one rank's block out of a
global tensor by such a spec: the port's stand-in for placing an array
by a ``NamedSharding``; :func:`shard_tree` cuts a whole tree and
:func:`gather_tree`, its inverse, gathers a rank's blocks back over the
process group.  :func:`check_whole_heads` refuses a ``model`` split
that cuts an SSM head (attention and MLA heads are padded, as the
reference's ``_pad_heads_even``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping

import torch

from repro_torch.sharding.collectives import all_gather, rows

__all__ = ["Rules", "DEFAULT_TABLE", "FSDP_TABLE", "DEFAULT_RULES",
           "axis_sizes", "spec_for_axes", "param_shardings",
           "opt_state_shardings", "zero1_spec", "batch_sharding", "cache_shardings",
           "local_block", "mesh_coords", "shard_tree", "gather_tree",
           "spec_axes_used", "spec_leaves", "check_whole_heads"]

Spec = tuple


@dataclasses.dataclass(frozen=True)
class Rules:
    """Logical → mesh axis map."""
    table: Mapping[str, str | None] = dataclasses.field(
        default_factory=lambda: dict(DEFAULT_TABLE))
    allow_uneven: bool = False   # keep an axis that does not divide a dim
    zero1: bool = True           # shard optimizer moments over data
    fsdp: bool = False           # also shard params' "embed" dims on data
    batch_axes: tuple[str, ...] = ("pod", "data")

    def mesh_axis(self, logical: str | None) -> str | None:
        if logical is None:
            return None
        return self.table.get(logical)


FSDP_TABLE: dict[str, str] = {"embed": "data"}


DEFAULT_TABLE: dict[str, str | None] = {
    "vocab": "model",
    "embed": None,
    "mlp": "model",
    "heads": "model",        # flattened n_heads*head_dim
    "kv_heads": "model",     # flattened n_kv*head_dim
    "expert": "model",
    "expert_mlp": None,
    "ssm_inner": "model",
    "ssm_conv_dim": "model",
    "ssm_heads": "model",
    "q_lora": "model",
    "kv_lora": None,
    "conv_in": None,
    "conv_out": "model",
    "layers": None,
}

DEFAULT_RULES = Rules()


def axis_sizes(mesh) -> dict[str, int]:
    """``{axis name: size}`` of ``mesh``: a ``DeviceMesh`` (its
    ``mesh_dim_names``), a ``(data, model)`` pair (``mesh_shape``'s), or
    an object whose ``shape`` maps names to sizes."""
    if isinstance(mesh, tuple) and len(mesh) == 2:
        return {"data": int(mesh[0]), "model": int(mesh[1])}
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return {n: int(v) for n, v in zip(names, mesh.shape)}
    return {n: int(v) for n, v in dict(mesh.shape).items()}


def _trim(entries: list) -> Spec:
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


def spec_for_axes(axes: tuple[str | None, ...], shape: tuple[int, ...],
                  mesh, rules: Rules = DEFAULT_RULES) -> Spec:
    """The spec of one parameter: each dim's logical axis mapped by
    ``rules``, kept only where the mesh has it, no earlier dim took it,
    and it divides the dim (unless ``allow_uneven``); with ``fsdp`` the
    first divisible ``"embed"`` dim of a matrix also takes ``data``."""
    sizes = axis_sizes(mesh)
    entries: list = []
    used = set()
    for dim, logical in zip(shape, axes):
        axis = rules.mesh_axis(logical)
        if axis is None or axis not in sizes or axis in used:
            entries.append(None)
            continue
        if dim % sizes[axis] != 0 and not rules.allow_uneven:
            entries.append(None)     # fallback: replicate this dim
            continue
        entries.append(axis)
        used.add(axis)
    if rules.fsdp and len(shape) >= 2:
        for i, (dim, logical) in enumerate(zip(shape, axes)):
            axis = FSDP_TABLE.get(logical or "")
            if (axis and axis in sizes and axis not in used
                    and entries[i] is None and dim % sizes[axis] == 0):
                entries[i] = axis
                used.add(axis)
    return _trim(entries)


def _map(fn, axes_tree: dict, shapes_tree: dict) -> dict:
    return {k: (_map(fn, a, shapes_tree[k]) if isinstance(a, dict)
                else fn(tuple(a), tuple(shapes_tree[k].shape)))
            for k, a in axes_tree.items()}


def param_shardings(mesh, axes_tree: dict, shapes_tree: dict,
                    rules: Rules = DEFAULT_RULES) -> dict:
    """The spec of every parameter: ``axes_tree`` the logical axes per
    leaf (``models.transformer.model_axes``), ``shapes_tree`` the
    matching tensors or ``ShapeDtype`` records (``spec_shapes``)."""
    return _map(lambda axes, shape: spec_for_axes(axes, shape, mesh, rules),
                axes_tree, shapes_tree)


def zero1_spec(spec: Spec, shape: tuple[int, ...], mesh) -> Spec:
    """A moment's spec under ZeRO-1: its parameter's ``spec`` plus
    ``data`` on the first unsharded dim that ``data`` divides (where the
    spec has no ``data`` yet)."""
    sizes = axis_sizes(mesh)
    spec = list(spec) + [None] * (len(shape) - len(spec))
    if "data" in sizes and "data" not in spec:
        dp = sizes["data"]
        for i, (dim, cur) in enumerate(zip(shape, spec)):
            if cur is None and dim % dp == 0 and dim >= dp:
                spec[i] = "data"
                break
    return _trim(spec)


def opt_state_shardings(mesh, axes_tree: dict, shapes_tree: dict,
                        rules: Rules = DEFAULT_RULES) -> dict:
    """ZeRO-1: a moment's spec is its parameter's plus ``data`` on the
    first unsharded dim that ``data`` divides (:func:`zero1_spec`)."""
    def one(axes, shape):
        spec = spec_for_axes(axes, shape, mesh, rules)
        return zero1_spec(spec, shape, mesh) if rules.zero1 else spec
    return _map(one, axes_tree, shapes_tree)


def _batch_entry(axes: tuple[str, ...]):
    return axes if len(axes) > 1 else (axes[0] if axes else None)


def batch_sharding(mesh, ndim: int, rules: Rules = DEFAULT_RULES,
                   batch_dim: int = 0, seq_axis_dim: int | None = None,
                   seq_axis: str | None = None,
                   batch_size: int | None = None) -> Spec:
    """A batch input's spec: its batch dim over the mesh's batch axes
    (the largest prefix-dropped run of them that divides ``batch_size``,
    when given: batch 1 is replicated), optionally a sequence dim over
    ``seq_axis``."""
    sizes = axis_sizes(mesh)
    entries: list = [None] * ndim
    axes = tuple(a for a in rules.batch_axes if a in sizes)
    if batch_size is not None:
        while axes and batch_size % math.prod(sizes[a] for a in axes):
            axes = axes[1:]
    entries[batch_dim] = _batch_entry(axes)
    if seq_axis_dim is not None and seq_axis in sizes:
        entries[seq_axis_dim] = seq_axis
    return _trim(entries)


def cache_shardings(mesh, cache_tree: dict, rules: Rules = DEFAULT_RULES,
                    *, seq_shard: bool = False) -> dict:
    """The spec of every cache leaf (tensors or ``ShapeDtype`` records;
    a leading ``layers`` axis from the segment stacking):

    * attention ``k``/``v`` ``(L, B, T, Hkv, hd)``: batch over the batch
      axes (not with ``seq_shard``, nor where they do not divide B), T
      over ``data`` with ``seq_shard``, the heads over ``model`` where it
      divides them, else ``hd``;
    * the int8 cache's scales ``k_s``/``v_s`` ``(L, B, T, 1, 1)``: the
      same batch and T, the unit head dim over ``model`` where it
      divides it (a model axis of 1);
    * MLA ``ckv``/``krope`` ``(L, B, T, R)``: T over ``data`` with
      ``seq_shard``;
    * SSM ``h`` ``(L, B, H, P, N)``: H over ``model``, else P; ``conv``
      ``(L, B, W-1, C)``: C over ``model``."""
    sizes = axis_sizes(mesh)
    axes = tuple(a for a in rules.batch_axes if a in sizes)
    batch_entry = _batch_entry(axes)
    bs_prod = math.prod(sizes[a] for a in axes) if axes else 1
    model_div = sizes.get("model", 1)
    seq = seq_shard and "data" in sizes

    def one(names: list[str], shape: tuple[int, ...]) -> Spec:
        spec: list = [None] * len(shape)
        if not seq_shard and shape[1] % bs_prod == 0:
            spec[1] = batch_entry
        if "k_s" in names or "v_s" in names:
            if seq:
                spec[2] = "data"
            if shape[3] % model_div == 0:
                spec[3] = "model"
        elif "k" in names or "v" in names:
            if seq:
                spec[2] = "data"
            if shape[3] % model_div == 0:
                spec[3] = "model"
            elif shape[4] % model_div == 0:   # shard head_dim instead
                spec[4] = "model"
        elif "ckv" in names or "krope" in names:
            if seq:
                spec[2] = "data"
        elif "h" in names:
            if shape[2] % model_div == 0:
                spec[2] = "model"
            elif shape[3] % model_div == 0:
                spec[3] = "model"
        elif "conv" in names:
            if shape[3] % model_div == 0:
                spec[3] = "model"
        return _trim(spec)

    def walk(tree: dict, path: list[str]) -> dict:
        return {k: (walk(v, path + [k]) if isinstance(v, dict)
                    else one(path + [k], tuple(v.shape)))
                for k, v in tree.items()}
    return walk(cache_tree, [])


def local_block(t: torch.Tensor, spec: Spec, mesh,
                coords: Mapping[str, int]) -> torch.Tensor:
    """The block of the global tensor ``t`` that the rank at ``coords``
    (``{axis name: index}``) holds under ``spec``: each dim sharded over
    one axis, or a tuple of axes (major first), cut to its part by
    :func:`~repro_torch.sharding.collectives.rows` (a view; raises where
    the axes do not divide the dim)."""
    sizes = axis_sizes(mesh)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        names = entry if isinstance(entry, tuple) else (entry,)
        parts, index = 1, 0
        for name in names:
            parts, index = parts * sizes[name], index * sizes[name] \
                + int(coords[name])
        lo, hi = rows(t.shape[dim], parts, index)
        t = t.narrow(dim, lo, hi - lo)
    return t


def mesh_coords(mesh) -> dict[str, int]:
    """``{axis name: this rank's index}`` on a ``DeviceMesh``."""
    return {n: int(mesh.get_local_rank(n)) for n in mesh.mesh_dim_names}


def _entry_axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def spec_axes_used(spec: Spec) -> frozenset:
    """The mesh axes a spec splits over."""
    return frozenset(a for e in spec for a in _entry_axes(e))


def spec_leaves(spec_tree: dict) -> list:
    """The specs of a tree of specs in the order of
    ``train.checkpoint.tree_leaves`` (sorted keys): a spec is a tuple,
    a leaf here."""
    out = []
    for _, v in sorted(spec_tree.items()):
        out += spec_leaves(v) if isinstance(v, dict) else [tuple(v)]
    return out


def _walk(fn, tree: dict, specs: dict) -> dict:
    return {k: (_walk(fn, v, specs[k]) if isinstance(v, dict)
                else fn(v, tuple(specs[k])))
            for k, v in tree.items()}


def shard_tree(tree: dict, spec_tree: dict, mesh) -> dict:
    """Every leaf of ``tree`` (whole tensors) cut to the block this rank
    of the ``DeviceMesh`` ``mesh`` holds under the matching spec of
    ``spec_tree`` (:func:`local_block`); each block a copy of its
    own."""
    coords = mesh_coords(mesh)
    return _walk(lambda t, spec: local_block(t, spec, mesh, coords).clone(),
                 tree, spec_tree)


def gather_tree(tree: dict, spec_tree: dict, mesh) -> dict:
    """The inverse of :func:`shard_tree` on the ``DeviceMesh`` ``mesh``:
    each leaf, this rank's block, gathered over the axes of its spec to
    the whole tensor (every rank of the group calls it and gets the
    whole tree)."""
    def whole(t, spec):
        for dim, entry in enumerate(spec):
            for name in reversed(_entry_axes(entry)):   # minor axis first
                t = all_gather(t, dim, mesh.get_group(name), name)
        return t
    return _walk(whole, tree, spec_tree)


def check_whole_heads(name: str, heads: Mapping[str, int], head_dim: int,
                      mesh, rules: Rules = DEFAULT_RULES) -> None:
    """Raise ``ValueError`` where ``rules`` would split the flattened
    ``heads·head_dim`` dim of a logical axis (``heads``: ``{logical axis:
    head count}``, e.g. ``{"ssm_heads": H}``) over a mesh axis that does
    not divide the head count, cutting a head the port cannot pad (an
    SSM head: its state and its norm's channels are the head's)."""
    sizes = axis_sizes(mesh)
    for logical, n in heads.items():
        axis = rules.mesh_axis(logical)
        m = sizes.get(axis, 1) if axis else 1
        split = m > 1 and ((n * head_dim) % m == 0 or rules.allow_uneven)
        if split and n % m:
            raise ValueError(
                f"{name}: a {axis} axis of {m} splits the {n} {logical} "
                f"of {head_dim} ({n * head_dim} columns) inside a head; "
                f"the port splits whole SSM heads only")
