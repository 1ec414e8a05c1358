"""Batched GAN image generation (the port of ``repro.serve.gan``'s
synchronous path).

``generate(n)`` rounds work up to full batches of ``batch_size`` but
discards nothing: tail samples beyond ``n`` are carried in a remainder
buffer and served first on the next call.  The counters account for
every sample the generator produced:
``samples_served + samples_buffered + samples_discarded ==
batches_served * batch_size`` (``samples_discarded`` stays 0 while the
buffer carries the remainders).
"""

from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models.gan import GanConfig, Generator

__all__ = ["GanServer"]


class GanServer:
    """Serves images of ``cfg``'s generator from a latent stream seeded
    by ``seed``, on ``device`` (default: the card), under
    ``torch.inference_mode()``."""

    def __init__(self, cfg: GanConfig, g_params: dict[str, torch.Tensor],
                 batch_size: int = 8, seed: int = 0,
                 device: str | torch.device = "cuda"):
        if int(batch_size) <= 0:
            raise ValueError(f"batch_size must be positive, "
                             f"got {batch_size}")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.batch_size = int(batch_size)
        self.generator = Generator(cfg, g_params,
                                   self.device).requires_grad_(False)
        self._rng = torch.Generator(device=self.device)
        self._rng.manual_seed(int(seed))
        self._spare: torch.Tensor | None = None    # carried tail samples
        self.batches_served = 0
        self.samples_served = 0
        self.samples_discarded = 0

    @property
    def samples_buffered(self) -> int:
        return 0 if self._spare is None else len(self._spare)

    def _next_latents(self) -> torch.Tensor:
        """The next batch's latents (advances the stream)."""
        return torch.randn((self.batch_size, self.cfg.z_dim),
                           generator=self._rng, device=self.device)

    def generate(self, n: int) -> torch.Tensor:
        """``n`` images ``(n, *spatial, C)`` on the server's device (3D-GAN:
        volumes ``(n, 64, 64, 64, 1)``).  Remainder samples of the last
        batch are buffered for the next call, never discarded."""
        if int(n) <= 0:
            raise ValueError(f"n must be positive, got {n}")
        remaining = int(n)
        outs = []
        with torch.inference_mode():
            if self._spare is not None:
                take = min(len(self._spare), remaining)
                outs.append(self._spare[:take])
                rest = self._spare[take:]
                self._spare = rest if len(rest) else None
                self.samples_served += take
                remaining -= take
            while remaining > 0:
                img = self.generator(self._next_latents())
                self.batches_served += 1
                take = min(self.batch_size, remaining)
                self.samples_served += take
                remaining -= take
                outs.append(img[:take])
                if take < self.batch_size:
                    self._spare = img[take:]
            return torch.cat(outs)

    def __repr__(self) -> str:
        return (f"GanServer(model={self.cfg.name!r}, "
                f"batch_size={self.batch_size}, device={self.device}, "
                f"served={self.samples_served}, "
                f"buffered={self.samples_buffered}, "
                f"discarded={self.samples_discarded})")
