"""Batched decode engine with slot-based continuous batching (the port of
``repro.serve.engine``).

The engine keeps a fixed pool of ``n_slots`` sequence slots sharing one
static-shaped cache on the device.  Requests are admitted into free
slots (the prefill writes the prompt's cache entries into the slot's
rows), every :meth:`DecodeEngine.step` decodes *all* slots in one
batched forward, and finished sequences (EOS, ``max_new`` or the cache's
length) free their slots at once, so new requests are admitted between
any two steps.

Where the reference donates the cache to a jitted step and updates it
with ``dynamic_update_slice``, the port writes each step's k/v into the
cache in place, at the per-slot ``lengths``, by indexed writes, and an
SSM block's state (``h`` and the conv window) of every slot in place.
As in the reference, a decode step advances the state of idle slots
too; a request's prefill then overwrites its slot's row whole.  The
prefill runs through the flash-attention kernel on the card.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tr
from repro_torch.serve.sampling import sample

__all__ = ["EngineConfig", "DecodeEngine", "Request"]


@dataclasses.dataclass
class EngineConfig:
    n_slots: int = 8
    max_len: int = 512
    max_new: int = 0           # 0 → generate until max_len
    eos_id: int = -1           # -1 → never stop on token
    temperature: float = 0.0   # greedy by default
    top_k: int = 0


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list[int]
    generated: list[int] = dataclasses.field(default_factory=list)
    done: bool = False


class DecodeEngine:
    """Serves ``cfg`` from ``params`` (a nested dict of tensors on
    ``device``, default: the card); samples from a generator seeded by
    ``seed``.  ``lengths`` (host, per slot) is the index at which each
    slot's next token is written."""

    def __init__(self, cfg: ArchConfig, params, ecfg: EngineConfig,
                 flags: tr.RunFlags = tr.RunFlags(), seed: int = 0,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"the parameters lie on "
                             f"{params['embed'].device}, the engine on "
                             f"{self.device}")
        self.cfg = cfg
        self.params = params
        self.ecfg = ecfg
        self.flags = flags
        n = ecfg.n_slots
        self.cache = tr.init_cache(cfg, n, ecfg.max_len, device=self.device)
        self.lengths = np.zeros((n,), np.int64)
        self.active = np.zeros((n,), bool)
        self.slot_req: list[Request | None] = [None] * n
        self.last_tokens = torch.zeros((n, 1), dtype=torch.int64,
                                       device=self.device)
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self.steps = 0

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        return sample(logits, self.gen, temperature=self.ecfg.temperature,
                      top_k=self.ecfg.top_k)

    # -- slot management ------------------------------------------------------
    def try_admit(self, req: Request) -> bool:
        """Prefill ``req`` into the first free slot and sample its first
        token; False when every slot is busy."""
        free = np.flatnonzero(~self.active)
        if free.size == 0:
            return False
        slot = int(free[0])
        s = len(req.prompt)
        if s >= self.ecfg.max_len:
            raise ValueError(f"prompt of {s} tokens too long for an engine "
                             f"of max_len {self.ecfg.max_len}")
        toks = torch.tensor(req.prompt, dtype=torch.int64,
                            device=self.device)[None]
        logits, pcache = tr.forward(self.params, {"tokens": toks}, self.cfg,
                                    mode="prefill", flags=self.flags)
        _merge_slot_cache(self.cache, pcache, slot, s)
        first = self._sample(logits[:, -1])
        req.generated.append(int(first[0]))
        self.last_tokens[slot, 0] = first[0]
        self.lengths[slot] = s
        self.active[slot] = True
        self.slot_req[slot] = req
        return True

    # -- stepping -------------------------------------------------------------
    def step(self):
        """One batched decode step over all slots."""
        if not self.active.any():
            return
        logits, self.cache = tr.decode_step(
            self.params, self.cache, self.last_tokens,
            torch.as_tensor(self.lengths, device=self.device), self.cfg,
            self.flags)
        toks = self._sample(logits)
        self.steps += 1
        self.lengths += self.active
        toks_np = toks.cpu().numpy()
        self.last_tokens = toks[:, None]
        for slot in np.flatnonzero(self.active):
            req = self.slot_req[slot]
            tok = int(toks_np[slot])
            req.generated.append(tok)
            if tok == self.ecfg.eos_id or \
                    (self.ecfg.max_new and
                     len(req.generated) >= self.ecfg.max_new) or \
                    self.lengths[slot] >= self.ecfg.max_len - 1:
                req.done = True
                self.active[slot] = False
                self.slot_req[slot] = None

    def run(self, requests: list[Request], max_steps: int = 10_000):
        """Admit and step until every request completes (continuous
        batching)."""
        pending = list(requests)
        while (pending or self.active.any()) and self.steps < max_steps:
            while pending and self.try_admit(pending[0]):
                pending.pop(0)
            self.step()
        return requests


def _merge_slot_cache(cache: dict, pcache: dict, slot: int, s: int,
                      state: bool = False) -> dict:
    """Write a prefill cache into row ``slot`` of the engine cache, in
    place.  A sequence cache, ``(layers, 1, S, ...)``, covers the prompt
    only and fills the row's first ``S`` positions; a state cache (an
    SSM block's ``{"ssm": {"h", "conv"}}``: the state after the prompt,
    ``(layers, 1, ...)`` at the engine's own shape) replaces the whole
    row, as the reference's."""
    for key, c in cache.items():
        p = pcache[key]
        if isinstance(c, dict):
            _merge_slot_cache(c, p, slot, s, state or key == "ssm")
        elif state and p.shape[1] == 1 and p.shape[2:] == c.shape[2:]:
            c[:, slot:slot + 1] = p
        elif not state and p.shape[1] == 1 and p.shape[2] == s <= c.shape[2]:
            c[:, slot:slot + 1, :s] = p
        else:
            raise ValueError((tuple(c.shape), tuple(p.shape)))
    return cache
