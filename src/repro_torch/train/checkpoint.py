"""Atomic, asynchronous checkpoints of a tree of tensors.

The port of ``repro.train.checkpoint``, with its on-disk layout (one
directory per step)::

    <dir>/step_00000123/
        meta.json            # step, mesh, and per key: file, shape, dtype
        arrays/<key>.npy

A tree is nested tuples, lists and dicts of tensors; a leaf's key joins
its path with ``::`` (tuple and list positions, dict keys in sorted
order), as ``jax.tree_util`` names the paths of the same tree.  So a
``(g_params, d_params)`` state writes the reference's keys (``0::proj_w``,
``1::c0_w``, ...) and either package restores the other's checkpoint.

* **Atomicity**: written to ``step_N.tmp``, then renamed; a crash
  mid-save never corrupts the latest checkpoint.
* **Async**: :func:`save_async` copies the tensors to the host at once
  and writes them on a background thread; :func:`wait_pending` joins.
* **Meshes**: a state held as blocks on a mesh (``shardings``, trees of
  ``sharding.rules`` specs) is saved whole: the blocks are gathered and
  rank 0 writes the global arrays.  :func:`restore` with ``shardings``
  gives each rank its blocks of the saved global arrays, on any mesh:
  the elastic reshard.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
import warnings
from typing import Any, Callable

import numpy as np
import torch

__all__ = ["save", "save_async", "wait_pending", "restore", "arrays",
           "latest_step",
           "all_steps", "tree_items", "tree_leaves", "tree_map",
           "tree_unflatten"]

_SEP = "::"


def _flatten(tree, path: tuple[str, ...] = ()) -> dict[str, Any]:
    if isinstance(tree, dict):
        items = sorted(tree.items())
    elif isinstance(tree, (tuple, list)):
        items = enumerate(tree)
    else:
        return {_SEP.join(path): tree}
    out = {}
    for k, v in items:
        out.update(_flatten(v, path + (str(k),)))
    return out


def _rebuild(template, leaves: dict[str, Any], path: tuple[str, ...] = ()):
    """``template``'s structure with the leaf at each key from
    ``leaves``."""
    if isinstance(template, dict):
        return {k: _rebuild(v, leaves, path + (str(k),))
                for k, v in template.items()}
    if isinstance(template, (tuple, list)):
        return type(template)(_rebuild(v, leaves, path + (str(i),))
                              for i, v in enumerate(template))
    return leaves[_SEP.join(path)]


def tree_items(tree) -> dict[str, Any]:
    """The leaves of ``tree`` in key order, each by its path (the keys
    joined by ``"::"``, as the checkpoint files name them)."""
    return _flatten(tree)


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in key order."""
    return list(_flatten(tree).values())


def tree_map(fn: Callable, tree):
    """``tree`` with ``fn`` applied to each leaf."""
    return _rebuild(tree, {k: fn(v) for k, v in _flatten(tree).items()})


def tree_unflatten(template, leaves: list):
    """``template``'s structure with ``leaves`` in key order (the order
    of :func:`tree_leaves`)."""
    return _rebuild(template, dict(zip(_flatten(template), leaves)))


def _to_host(leaf) -> np.ndarray:
    """A host copy of ``leaf`` that later in-place updates do not reach
    (through pinned memory from the card: a pageable copy runs at a
    tenth of the rate)."""
    if isinstance(leaf, torch.Tensor):
        out = torch.empty(leaf.shape, dtype=leaf.dtype,
                          pin_memory=leaf.is_cuda)
        return out.copy_(leaf.detach()).numpy()
    return np.array(leaf, copy=True)


def save(state, ckpt_dir: str, step: int, mesh=None,
         shardings=None) -> str:
    """Write ``state`` as ``<ckpt_dir>/step_<step>``; returns its path.
    ``mesh`` is the ``(data, model)`` shape of the ranks that trained it
    (or their ``DeviceMesh``; None: one device), kept in ``meta.json``
    as data: the arrays are the whole tensors either way, so any mesh
    restores them.  With ``shardings`` (a tree of specs shaped as
    ``state``) ``state`` holds this rank's blocks on the ``DeviceMesh``
    ``mesh``: every rank calls, each leaf's blocks are gathered
    (``sharding.rules.gather_tree``) and rank 0 writes it before the
    next, and a barrier follows."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    if shardings is None:
        if mesh is not None and hasattr(mesh, "mesh_dim_names"):
            mesh = tuple(int(v) for v in mesh.shape)
        _write(final, step, mesh, ((k, _to_host(v))
                                   for k, v in _flatten(state).items()))
        return final
    import torch.distributed as dist

    from repro_torch.sharding.rules import gather_tree, spec_leaves
    lead = dist.get_rank() == 0

    def gathered():
        for (key, t), spec in zip(_flatten(state).items(),
                                  spec_leaves(shardings)):
            whole = gather_tree({"t": t}, {"t": spec}, mesh)["t"]
            yield key, _to_host(whole) if lead else None
            del whole
    if lead:
        _write(final, step, tuple(mesh.shape), gathered())
    else:
        for _ in gathered():
            pass
    dist.barrier()
    return final


def _write(final: str, step: int, mesh, items) -> None:
    """The arrays of ``items`` (``(key, host array)``, written as they
    come) and ``meta.json`` into ``final + ".tmp"``, renamed to
    ``final``."""
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(os.path.join(tmp, "arrays"))
    meta = {"step": int(step), "keys": {},
            "mesh": None if mesh is None else [int(v) for v in mesh]}
    for key, arr in items:
        fn = re.sub(r"[^A-Za-z0-9_.:-]", "_", key)
        np.save(os.path.join(tmp, "arrays", fn + ".npy"), arr)
        meta["keys"][key] = {"file": fn + ".npy",
                             "shape": list(arr.shape),
                             "dtype": str(arr.dtype)}
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)


_pending: list[threading.Thread] = []


def save_async(state, ckpt_dir: str, step: int,
               mesh: tuple[int, int] | None = None) -> threading.Thread:
    """Copy ``state`` to the host now (waiting for the device), write it
    on a thread."""
    host_state = tree_map(_to_host, state)
    t = threading.Thread(target=save, args=(host_state, ckpt_dir, step,
                                            mesh), daemon=True)
    t.start()
    _pending.append(t)
    return t


def wait_pending() -> None:
    """Join every save started by :func:`save_async`."""
    while _pending:
        _pending.pop().join()


def all_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    steps = []
    for name in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d+)", name)
        if m:
            steps.append(int(m.group(1)))
    return sorted(steps)


def latest_step(ckpt_dir: str) -> int | None:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def _read_meta(step_dir: str) -> dict:
    with open(os.path.join(step_dir, "meta.json")) as f:
        return json.load(f)


def arrays(ckpt_dir: str, step: int | None = None) -> dict[str, np.ndarray]:
    """The saved arrays of ``step`` (default: the latest) by key, memory
    mapped (read-only: pages are read as they are touched)."""
    step = latest_step(ckpt_dir) if step is None else step
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    return {key: np.load(os.path.join(d, "arrays", info["file"]),
                         mmap_mode="r")
            for key, info in _read_meta(d)["keys"].items()}


def restore(template, ckpt_dir: str, step: int | None = None,
            shardings=None, mesh=None):
    """The checkpoint of ``step`` (default: the latest) in the structure
    of ``template``, a tree of tensors: new tensors, each with its
    template's dtype and device.  Keys of the checkpoint that the
    template lacks are skipped; a key the checkpoint lacks, or a shape
    that differs, raises.

    ``shardings`` (a tree of specs shaped as ``template``, the
    reference's ``NamedSharding`` tree) on the ``DeviceMesh`` ``mesh``:
    the elastic reshard.  ``template`` holds the rank's blocks
    and each leaf is the rank's block of the saved global array
    (``sharding.rules.local_block``), whatever mesh saved it."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    meta = _read_meta(d)
    flat_t = _flatten(template)
    flat_s, cut = {}, None
    if shardings is not None:
        from repro_torch.sharding.rules import (local_block, mesh_coords,
                                                spec_leaves)
        flat_s = dict(zip(flat_t, spec_leaves(shardings)))
        coords = mesh_coords(mesh)

        def cut(arr, spec):
            with warnings.catch_warnings():   # a read-only memory map
                warnings.simplefilter("ignore", UserWarning)
                t = torch.from_numpy(arr)
            return local_block(t, spec, mesh, coords)
    out = {}
    for key, info in meta["keys"].items():
        if key not in flat_t:
            continue    # restoring a subset
        # a rank's block reads only its pages of the file
        arr = np.load(os.path.join(d, "arrays", info["file"]),
                      mmap_mode="r" if cut is not None else None)
        tmpl = flat_t[key]
        t = torch.from_numpy(arr) if cut is None else cut(arr, flat_s[key])
        if tuple(t.shape) != tuple(tmpl.shape):
            raise ValueError(f"shape mismatch for {key}: "
                             f"{tuple(t.shape)} vs {tuple(tmpl.shape)}")
        if tmpl.device.type == "cuda":     # through pinned memory
            t = torch.empty(t.shape, dtype=t.dtype,
                            pin_memory=True).copy_(t)
        out[key] = t.to(device=tmpl.device, dtype=tmpl.dtype, copy=True)
    missing = set(flat_t) - set(out)
    if missing:
        raise ValueError(f"checkpoint missing keys: {sorted(missing)[:5]}…")
    return _rebuild(template, out)
