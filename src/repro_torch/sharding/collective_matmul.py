"""Collective matmul: a ring all-gather overlapped with compute.

The port of ``repro.sharding.collective_matmul``.  A tensor-parallel
product ``Y = all_gather(X, axis) @ W`` is decomposed into a ring:
each step multiplies the resident X shard while the next shard travels
from the ring neighbour, so the transfer of step i+1 overlaps the
product of step i (Wang et al., "Overlap communication with
computation").  :func:`ring_matmul_reducescatter` is the matching
reduce-scatter form.

One process per rank: each function takes this rank's shards and
returns its shard of the result, over the ``axis`` group of a
``DeviceMesh``.  The ring's transfers are ``isend``/``irecv`` pairs
issued together (``batch_isend_irecv``) and waited on after the step's
product; the product is a plain ``torch.matmul``, as the reference's is
``x @ w`` outside any Pallas kernel.  A CUDA shard over a ``gloo`` group
travels through pinned host memory (the rule of
:func:`repro_torch.sharding.collectives.staged`).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.sharding.collectives import p2p_start

__all__ = ["ring_allgather_matmul", "ring_matmul_reducescatter"]


def ring_allgather_matmul(x: torch.Tensor, w: torch.Tensor, mesh,
                          axis: str = "model") -> torch.Tensor:
    """``Y = all_gather(x, axis) @ w`` with the gather overlapped.

    ``x``: this rank's ``(m_loc, k)`` rows of the row-sharded X;
    ``w``: its ``(k, n_loc)`` column shard of W.  Returns this rank's
    ``(m_loc·P, n_loc)`` column shard of Y."""
    group = mesh.get_group(axis)
    p, idx = dist.get_world_size(group), dist.get_rank(group)
    m = x.shape[0]
    out = x.new_empty((m * p, w.shape[1]))
    cur = x.contiguous()
    for i in range(p):
        # `cur` holds shard (idx + i) mod p; the next one comes from the
        # rank after this one while this one's product runs
        pending = p2p_start(cur, to=(idx - 1) % p, frm=(idx + 1) % p,
                            group=group) if i < p - 1 else None
        row = ((idx + i) % p) * m
        out[row:row + m] = cur @ w
        if pending is not None:
            cur = pending()
    return out


def ring_matmul_reducescatter(x: torch.Tensor, w: torch.Tensor, mesh,
                              axis: str = "model") -> torch.Tensor:
    """``Y = reduce_scatter(x @ w, axis)`` with the scatter overlapped.

    ``x``: this rank's ``(m, k_loc)`` column shard of X; ``w``: its
    ``(k_loc, n)`` row shard of W.  Returns this rank's ``(m / P, n)``
    rows of the fully summed product, the backward / row-parallel dual
    of :func:`ring_allgather_matmul`.  The partial sums travel in f32."""
    group = mesh.get_group(axis)
    p, idx = dist.get_world_size(group), dist.get_rank(group)
    m_loc = x.shape[0] // p
    if m_loc * p != x.shape[0]:
        raise ValueError(f"{x.shape[0]} rows do not divide over the "
                         f"{p} ranks of {axis!r}")

    def contrib(b: int) -> torch.Tensor:
        return (x[b * m_loc:(b + 1) * m_loc] @ w).float()

    own = contrib(idx)
    if p == 1:
        return own.to(x.dtype)
    # row block b's partial sum starts at rank b - 1 and travels b,
    # b + 1, ..., each rank adding its term, and reaches rank b summed
    # but for b's own term after p - 1 hops; each hop's transfer runs
    # under the next term's product
    buf = contrib((idx - 1) % p)
    for t in range(1, p):
        pending = p2p_start(buf, to=(idx + 1) % p, frm=(idx - 1) % p,
                            group=group)
        term = contrib((idx - 1 - t) % p) if t < p - 1 else own
        buf = pending() + term
    return buf.to(x.dtype)
