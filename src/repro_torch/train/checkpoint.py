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
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Callable

import numpy as np
import torch

__all__ = ["save", "save_async", "wait_pending", "restore", "latest_step",
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
    """A host copy of ``leaf`` that later in-place updates do not reach."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf, copy=True)


def save(state, ckpt_dir: str, step: int,
         mesh: tuple[int, int] | None = None) -> str:
    """Write ``state`` as ``<ckpt_dir>/step_<step>``; returns its path.
    ``mesh`` is the ``(data, model)`` shape of the ranks that trained it
    (None: one device), kept in ``meta.json`` as data: the arrays are
    the whole replicated tensors either way, so any mesh restores
    them."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(os.path.join(tmp, "arrays"))
    meta = {"step": int(step), "keys": {},
            "mesh": None if mesh is None else [int(v) for v in mesh]}
    for key, leaf in _flatten(state).items():
        arr = _to_host(leaf)
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
    return final


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


def restore(template, ckpt_dir: str, step: int | None = None):
    """The checkpoint of ``step`` (default: the latest) in the structure
    of ``template``, a tree of tensors: new tensors, each with its
    template's dtype and device.  Keys of the checkpoint that the
    template lacks are skipped; a key the checkpoint lacks, or a shape
    that differs, raises."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    flat_t = _flatten(template)
    out = {}
    for key, info in meta["keys"].items():
        if key not in flat_t:
            continue    # restoring a subset
        arr = np.load(os.path.join(d, "arrays", info["file"]))
        tmpl = flat_t[key]
        if tuple(arr.shape) != tuple(tmpl.shape):
            raise ValueError(f"shape mismatch for {key}: "
                             f"{arr.shape} vs {tuple(tmpl.shape)}")
        out[key] = torch.from_numpy(arr).to(device=tmpl.device,
                                            dtype=tmpl.dtype)
    missing = set(flat_t) - set(out)
    if missing:
        raise ValueError(f"checkpoint missing keys: {sorted(missing)[:5]}…")
    return _rebuild(template, out)
