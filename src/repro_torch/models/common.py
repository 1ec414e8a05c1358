"""Parameter specs and their initializer (the port of the GAN part of
``repro.models.common``).

A :class:`PSpec` declares one parameter's shape, logical axes and
initializer; :func:`init_params` materializes a dict of them from an
explicit ``torch.Generator``.  The draw differs from ``jax.random``'s at
equal seeds: tests that compare the two packages convert the JAX
parameters instead (``repro_torch.convert``).
"""

from __future__ import annotations

import dataclasses
import math

import torch

__all__ = ["PSpec", "init_params"]


@dataclasses.dataclass(frozen=True)
class PSpec:
    """Declarative parameter spec: shape + logical axes + initializer
    (``"normal"``: truncated normal in [-2, 2] times ``scale``,
    default 1/sqrt(fan_in); ``"zeros"``)."""
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]
    init: str = "normal"
    scale: float | None = None

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} "
                             f"differ in rank")
        if self.init not in ("normal", "zeros"):
            raise ValueError(f"unknown initializer {self.init!r}")


def _init_leaf(gen: torch.Generator, spec: PSpec) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape)
    # truncated-normal fan-in scaling, as the reference
    fan_in = spec.shape[0] if len(spec.shape) > 1 else spec.shape[-1]
    scale = spec.scale if spec.scale is not None else 1.0 / math.sqrt(fan_in)
    t = torch.empty(spec.shape)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return scale * t


def init_params(gen: torch.Generator, specs: dict[str, PSpec],
                device: torch.device) -> dict[str, torch.Tensor]:
    """Materialize ``specs`` as float32 tensors on ``device``.  The draw
    runs on the CPU generator ``gen`` in sorted-name order, so a seed
    gives the same parameters on every device."""
    return {name: _init_leaf(gen, specs[name]).to(device)
            for name in sorted(specs)}
