"""Gated MLP variants (SwiGLU / GeGLU / plain GELU): the port of
``repro.models.mlp``.  The GELUs are the tanh approximation, which is
what JAX's ``gelu(approximate=True)`` computes."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.common import PSpec
from repro_torch.sharding import collectives

__all__ = ["mlp_specs", "mlp_apply"]


def mlp_specs(cfg: ArchConfig, kind: str, d_ff: int | None = None
              ) -> dict[str, PSpec]:
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    if kind in ("swiglu", "geglu"):
        return {
            "wi": PSpec((d, f), ("embed", "mlp")),
            "wg": PSpec((d, f), ("embed", "mlp")),
            "wo": PSpec((f, d), ("mlp", "embed")),
        }
    if kind == "gelu":
        return {
            "wi": PSpec((d, f), ("embed", "mlp")),
            "bi": PSpec((f,), ("mlp",), init="zeros"),
            "wo": PSpec((f, d), ("mlp", "embed")),
            "bo": PSpec((d,), (None,), init="zeros"),
        }
    raise ValueError(kind)


def mlp_apply(params: dict[str, torch.Tensor], x: torch.Tensor,
              kind: str, tp=None) -> torch.Tensor:
    """The MLP of ``kind`` on ``x``.  ``tp`` (a ``TensorGroup``) with
    ``params`` the rank's blocks of a ``d_ff`` split over the group:
    ``wi``/``wg`` (and ``bi``) column-parallel, ``wo`` row-parallel,
    its partials summed over the group; the replicated ``bo`` is added
    once, after the sum."""
    if kind not in ("swiglu", "geglu", "gelu"):
        raise ValueError(kind)
    if tp is not None:
        x = collectives.sum_grad(x, tp.group, "model", f32=True)
    if kind == "swiglu":
        h = F.silu(x @ params["wg"]) * (x @ params["wi"])
    elif kind == "geglu":
        h = F.gelu(x @ params["wg"], approximate="tanh") * (x @ params["wi"])
    else:
        h = F.gelu(x @ params["wi"] + params["bi"].to(x.dtype),
                   approximate="tanh")
    out = h @ params["wo"]
    if tp is not None:
        out = collectives.reduce_from_model(out, tp.group)
    return out + params["bo"].to(x.dtype) if kind == "gelu" else out
