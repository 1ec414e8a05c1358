"""Parameter specs and their initializers, norms and rotary embeddings
(the port of ``repro.models.common``).

A :class:`PSpec` declares one parameter's shape, logical axes and
initializer.  :func:`init_params` materializes a flat dict of them (the
GAN networks) from a CPU ``torch.Generator``; :func:`init_tree`
materializes a nested dict (the LLM stack) on the generator's own
device, so a full-width model is drawn on the card.  The draws differ
from ``jax.random``'s at equal seeds: tests that compare the two
packages convert the JAX parameters instead (``repro_torch.convert``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

__all__ = ["PSpec", "ShapeDtype", "init_params", "init_tree", "spec_axes",
           "spec_shapes", "stack_specs", "rms_norm", "layer_norm",
           "rope_angles", "apply_rope"]


@dataclasses.dataclass(frozen=True)
class PSpec:
    """Declarative parameter spec: shape + logical axes + initializer
    (``"normal"``: truncated normal in [-2, 2] times ``scale``, default
    1/sqrt(fan_in); ``"zeros"``; ``"ones"``; ``"embed"``: standard
    normal)."""
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]
    init: str = "normal"
    scale: float | None = None

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} "
                             f"differ in rank")
        if self.init not in ("normal", "zeros", "ones", "embed"):
            raise ValueError(f"unknown initializer {self.init!r}")


def _draw(gen: torch.Generator, spec: PSpec,
          shape: tuple[int, ...]) -> torch.Tensor:
    """One f32 draw of ``spec``'s distribution, of ``shape`` (the spec's
    or one layer of it), on ``gen``'s device."""
    if spec.init == "zeros":
        return torch.zeros(shape, device=gen.device)
    if spec.init == "ones":
        return torch.ones(shape, device=gen.device)
    t = torch.empty(shape, device=gen.device)
    if spec.init == "embed":
        return t.normal_(generator=gen)
    # truncated-normal fan-in scaling, as the reference: fan_in is the
    # spec's leading dim (for a stacked spec, the layer count)
    fan_in = spec.shape[0] if len(spec.shape) > 1 else spec.shape[-1]
    scale = spec.scale if spec.scale is not None else 1.0 / math.sqrt(fan_in)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return t.mul_(scale)


def init_params(gen: torch.Generator, specs: dict[str, PSpec],
                device: torch.device) -> dict[str, torch.Tensor]:
    """Materialize ``specs`` as float32 tensors on ``device``.  The draw
    runs on the CPU generator ``gen`` in sorted-name order, so a seed
    gives the same parameters on every device."""
    return {name: _draw(gen, specs[name], specs[name].shape).to(device)
            for name in sorted(specs)}


def init_tree(gen: torch.Generator, specs: dict, dtype: torch.dtype
              ) -> dict:
    """Materialize a nested dict of PSpecs as ``dtype`` tensors on
    ``gen``'s device, leaf by leaf in sorted-key order.  A stacked leaf
    (leading ``"layers"`` axis) is drawn one layer at a time, so the f32
    scratch never exceeds one layer of one leaf."""
    out = {}
    for key in sorted(specs):
        spec = specs[key]
        if not isinstance(spec, PSpec):
            out[key] = init_tree(gen, spec, dtype)
            continue
        leaf = torch.empty(spec.shape, dtype=dtype, device=gen.device)
        if spec.axes[:1] == ("layers",):
            for i in range(spec.shape[0]):
                leaf[i] = _draw(gen, spec, spec.shape[1:])
        else:
            leaf.copy_(_draw(gen, spec, spec.shape))
        out[key] = leaf
    return out


class ShapeDtype(NamedTuple):
    """A leaf's shape and dtype, as the reference's
    ``jax.ShapeDtypeStruct``: what the sharding rules read of it."""
    shape: tuple[int, ...]
    dtype: torch.dtype


def spec_axes(specs: dict) -> dict:
    """The parallel nested dict of each spec's logical-axis tuple."""
    return {k: (s.axes if isinstance(s, PSpec) else spec_axes(s))
            for k, s in specs.items()}


def spec_shapes(specs: dict) -> dict:
    """The parallel nested dict of each spec's :class:`ShapeDtype`
    (float32, the reference's spec dtype)."""
    return {k: (ShapeDtype(s.shape, torch.float32) if isinstance(s, PSpec)
                else spec_shapes(s))
            for k, s in specs.items()}


def stack_specs(specs: dict, n: int) -> dict:
    """Prepend a stacked ``"layers"`` axis of size ``n`` to every spec of
    a nested dict."""
    return {k: (PSpec((n,) + s.shape, ("layers",) + s.axes, s.init, s.scale)
                if isinstance(s, PSpec) else stack_specs(s, n))
            for k, s in specs.items()}


# ---------------------------------------------------------------------------
# Norms (computed in f32, cast back).
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMS norm over the last dim with a ``1 + scale`` gain, in f32."""
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(dt)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """Layer norm over the last dim (mean and biased variance) with gain
    ``scale`` and ``bias``, in f32."""
    dt = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dt)


# ---------------------------------------------------------------------------
# Rotary position embeddings.
# ---------------------------------------------------------------------------

def rope_angles(positions: torch.Tensor, dim: int, theta: float
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(…,) int positions → cos/sin of shape (…, dim/2), in f32."""
    log_theta = torch.tensor(theta, dtype=torch.float32,
                             device=positions.device).log()
    freqs = torch.exp(-log_theta * torch.arange(
        0, dim, 2, dtype=torch.float32, device=positions.device) / dim)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (..., S, H, hd); cos/sin: (..., S, hd/2) broadcast over heads.
    Rotates the two halves of hd (not interleaved pairs), in f32."""
    dt = x.dtype
    x1, x2 = x.float().chunk(2, dim=-1)
    c = cos[..., None, :]
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(dt)
