"""Data pipeline: deterministic synthetic streams and memmap token files
(the port of ``repro.data.pipeline``).

Determinism contract (fault tolerance): batch contents are a pure
function of ``(seed, step)``, so a restarted job that resumes at step N
sees exactly the batches it would have seen, with no iterator state to
checkpoint.  :class:`SyntheticLM` and :class:`MemmapTokens` build host
batches of numpy arrays, equal to the reference's bit for bit;
:func:`make_batch_fn` moves them to the device.

:class:`Prefetcher` overlaps host batch construction with the previous
step's compute (queue depth 2 by default).
"""

from __future__ import annotations

import queue
import threading
from typing import Callable

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.sharding.rules import local_block, mesh_coords

__all__ = ["SyntheticLM", "MemmapTokens", "Prefetcher", "make_batch_fn"]


class SyntheticLM:
    """Zipf-ish synthetic token stream, pure function of (seed, step)."""

    def __init__(self, cfg: ArchConfig, batch: int, seq_len: int,
                 seed: int = 0, microbatches: int = 1):
        self.cfg = cfg
        self.batch = batch
        self.seq = seq_len
        self.seed = seed
        self.micro = microbatches

    def __call__(self, step: int) -> dict:
        mix = (0x9E3779B97F4A7C15 * (step + 1)) % (1 << 64)
        rng = np.random.Philox(key=np.uint64(self.seed) ^ np.uint64(mix))
        gen = np.random.Generator(rng)
        shape = (self.batch, self.seq) if self.micro == 1 else \
            (self.micro, self.batch // self.micro, self.seq)
        # zipf-like marginal over the vocab, cheap to sample
        u = gen.random(shape)
        toks = np.minimum(
            (np.exp(u * np.log(self.cfg.vocab)) - 1).astype(np.int32),
            self.cfg.vocab - 1)
        batch = {"tokens": toks}
        if self.cfg.family == "vlm":
            img_shape = shape[:-1] + (self.cfg.img_tokens,
                                      self.cfg.frontend_dim)
            batch["img_embeds"] = gen.standard_normal(
                img_shape, dtype=np.float32)
        if self.cfg.family == "encoder":
            feat_shape = shape + (self.cfg.frontend_dim,)
            batch = {
                "features": gen.standard_normal(feat_shape,
                                                dtype=np.float32),
                "labels": gen.integers(0, self.cfg.vocab, shape,
                                       dtype=np.int32),
                "label_mask": (gen.random(shape) < 0.08).astype(np.float32),
            }
        return batch


class MemmapTokens:
    """Flat binary token file (uint16/uint32), deterministic slicing by
    step: the production input path (one shared file per host group)."""

    def __init__(self, path: str, cfg: ArchConfig, batch: int, seq_len: int,
                 dtype=np.uint16, microbatches: int = 1):
        self.data = np.memmap(path, dtype=dtype, mode="r")
        self.cfg = cfg
        self.batch = batch
        self.seq = seq_len
        self.micro = microbatches
        self.tokens_per_step = batch * seq_len

    def __call__(self, step: int) -> dict:
        n = len(self.data)
        start = (step * self.tokens_per_step) % max(
            1, n - self.tokens_per_step)
        flat = np.asarray(self.data[start:start + self.tokens_per_step],
                          dtype=np.int32) % self.cfg.vocab
        shape = (self.batch, self.seq) if self.micro == 1 else \
            (self.micro, self.batch // self.micro, self.seq)
        return {"tokens": flat.reshape(shape)}


def make_batch_fn(source: Callable[[int], dict], shardings=None,
                  device: str | torch.device = "cuda", mesh=None
                  ) -> Callable[[int], dict]:
    """Wrap a host batch source: ``fn(step)`` returns its arrays as
    tensors on ``device`` (default: the card), of the arrays' dtypes.

    ``shardings`` (a spec for every array, or a dict of them by key, as
    ``sharding.rules.batch_sharding`` gives them) on the ``DeviceMesh``
    ``mesh``: each array is cut to this rank's block
    (``local_block``) on the host, before it moves, where the
    reference places the global batch on the mesh."""
    dev = resolve_device(device)
    if shardings is not None:
        if mesh is None:
            raise ValueError("batch shardings need the mesh they cut over")
        coords = mesh_coords(mesh)

    def place(key, v):
        t = torch.from_numpy(np.ascontiguousarray(v))
        if shardings is not None:
            spec = shardings[key] if isinstance(shardings, dict) \
                else shardings
            t = local_block(t, tuple(spec), mesh, coords)
        return t.to(dev, copy=True) if shardings is not None else t.to(dev)

    def fn(step: int) -> dict:
        return {k: place(k, v) for k, v in source(step).items()}
    return fn


class Prefetcher:
    """Depth-k host-side prefetch: batch (step+i) builds while step runs."""

    def __init__(self, batch_fn: Callable[[int], dict], start_step: int = 0,
                 depth: int = 2):
        self.batch_fn = batch_fn
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._next = start_step
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self):
        step = self._next
        while not self._stop.is_set():
            try:
                self.q.put((step, self.batch_fn(step)), timeout=0.2)
                step += 1
            except queue.Full:
                continue

    def get(self) -> tuple[int, dict]:
        return self.q.get()

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=2)
