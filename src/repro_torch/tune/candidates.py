"""Candidate enumeration: (backend × GANAX kernel route) configurations
valid for one layer geometry.

The port of ``repro.tune.candidates``.  The fused epilogue rides in the
:class:`~repro_torch.tune.planner.PlanKey`, not in the candidates: every
candidate of an epilogue-carrying key is measured running the fused op.

The enumerator is pure geometry.  It reads the layer's kernel call from
the cached μop compilation
(:func:`~repro_torch.core.dataflow.kernel_call_geometry`: phases, taps,
phase grid) and emits, per backend of the pool:

* ``ganax``: :func:`~repro_torch.kernels.ganax_conv.kernel_route`'s
  route first (the heuristic is always in the measured pool), then the
  other routes of :func:`~repro_torch.kernels.ganax_conv.route_options`
  (``tc`` tile widths and split counts, ``narrow`` split counts), none
  whose output or split-K scratch passes the kernels' 32-bit indexing,
  at most :data:`MAX_BLOCK_CANDIDATES` in all.  The reference's Pallas
  block shapes become these routes on Hopper: what the tile and the
  split take of shared memory is the route table's business, which
  holds every route to the ones the kernels compile.
* every other backend: one candidate, no route.

Pools: on ``"cpu"`` the reference's CPU pool, ``polyphase`` and
``zero-insert`` (``ganax-plain`` is the interpret-mode counterpart, a
correctness tool that is never a plan unless asked for by
``backends=``); on a card (``"sm_90"``) the GANAX kernel's routes only.
There the plain-PyTorch oracles (``polyphase``, ``zero-insert``: cuDNN
behind ``core.tconv``) are measured only where ``backends=`` names them,
so an ``auto`` layer on the card runs the kernel unless its user asked
for an oracle.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

from repro_torch.core.dataflow import backend_supports, kernel_call_geometry
from repro_torch.kernels.ganax_conv import (KernelRoute, kernel_route,
                                            route_options)
from repro_torch.quant.precision import storage_itemsize
from repro_torch.tune.planner import PlanKey

__all__ = ["Candidate", "enumerate_candidates", "default_backend_pool",
           "kernel_candidates", "MAX_BLOCK_CANDIDATES"]

# Most candidates per kernel backend (the heuristic's route included).
MAX_BLOCK_CANDIDATES = 12
_INT32_MAX = 2 ** 31 - 1


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One runnable configuration: a port backend and, on ``ganax``, the
    kernel route to run."""

    backend: str
    route: KernelRoute | None = None

    def describe(self) -> str:
        if self.route is None:
            return self.backend
        return f"{self.backend}[{self.route.describe()}]"


def default_backend_pool(platform: str) -> tuple[str, ...]:
    """The backends measured on ``platform`` unless ``backends=`` names
    others: the reference's CPU pool, or on a card the GANAX kernel."""
    if platform == "cpu":
        return ("polyphase", "zero-insert")
    return ("ganax",)


def kernel_candidates(key: PlanKey) -> list[KernelRoute]:
    """The GANAX kernel routes worth measuring for ``key``:
    ``kernel_route``'s first, then the other routes the kernels take for
    the geometry, at most :data:`MAX_BLOCK_CANDIDATES`; none past the
    kernels' 32-bit indexing at the key's batch."""
    p, t, q = kernel_call_geometry(key.kind, key.in_spatial, key.kernel,
                                   key.strides, key.paddings)
    itemsize = storage_itemsize(key.dtype)
    k = t * key.cin
    rows = key.batch * math.prod(q)
    options = route_options(key.cin, key.cout, k, itemsize)
    out_numel = p * rows * key.cout
    routes = [r for r in options if max(r.splits, 1) * out_numel
              <= _INT32_MAX]
    heuristic = kernel_route(key.cin, key.cout, rows, k, p, itemsize)
    if heuristic in routes:
        routes.remove(heuristic)
        routes.insert(0, heuristic)
    return routes[:MAX_BLOCK_CANDIDATES]


def enumerate_candidates(key: PlanKey,
                         backends: Sequence[str] | None = None
                         ) -> list[Candidate]:
    """Every configuration worth measuring for ``key``, the heuristic's
    route first among the kernel's."""
    pool = tuple(backends) if backends is not None else \
        default_backend_pool(key.platform)
    out: list[Candidate] = []
    for backend in pool:
        if not backend_supports(backend, key.nd):
            continue
        if backend == "ganax":
            out.extend(Candidate(backend, r) for r in kernel_candidates(key))
        else:
            out.append(Candidate(backend))
    return out
