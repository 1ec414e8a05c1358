"""The collectives of a sharded GAN program, with their gradient rules.

What ``jax.lax`` collectives and the transpose of ``shard_map`` do in
``repro.program.runtime``, on ``torch.distributed``: one process per
rank, every rank holding the same value of each replicated tensor.  A
sharded program takes the global batch and returns the global output on
every rank, so every loss computed from it is computed identically on
every rank, and its cotangent is replicated.  The rules that make the
backward of such a program equal to the unsharded one:

* **Tiled all-gather on the channels over ``model``**
  (:func:`gather_channels`): the forward gathers the ranks' Cout shards
  rank-major and moves the rank axis to just before the channels, so the
  result is ``concat(shard_0 … shard_{M-1})`` on the last axis.  The
  backward takes the rank's own Cout slice of the cotangent, **no
  sum**: the consumer runs replicated on every model rank, so each holds
  the whole cotangent already.
* **The same on the batch axis over ``data``** (:func:`gather_batch`),
  for the program's output.
* **Replicated in, sharded use**: a value that is replicated over an
  axis and consumed by sharded compute has its cotangent **summed over
  that axis**.  :func:`sum_grad` is the identity forward and that sum
  backward: on the input of a ``"cout"`` layer over ``model`` (each
  rank's ``dx`` is a partial sum over its Cout slice), on replicated
  parameters over ``data`` (each rank saw its rows), and on a ``"cout"``
  layer's parameters over the whole world (each rank's gradient is
  non-zero on its slice alone).  :func:`shard_batch` is the case where
  the sharded use is a slice: it takes the rank's rows of a replicated
  batch, and its backward sums the ranks' disjoint row cotangents, which
  is the all-gather of them.

**Host staging.**  ``gloo`` runs only some collectives on CUDA tensors.
The rule is stated, never found by catching an error: a collective
named in :data:`GLOO_CUDA` runs on the card's tensors as they are;
another, on a CUDA tensor over a ``gloo`` group, is staged through
pinned host memory (:func:`staged`).  A staged call records
``staged="host"`` on its ``mesh.collective`` span and counts
``mesh.staged``.  ``tools/gloo_cuda_probe.py`` reads the table off the
card.  Every call counts ``mesh.collectives`` (label ``op``) and, with
tracing on, records a ``mesh.collective`` span (``op``, ``axis``,
``bytes``, the rank count ``ranks``).

Only APIs of both torch 2.11 and 2.13: the list form of ``all_gather``
(``all_gather_into_tensor`` warns of deprecation on 2.13), ``all_reduce``,
``broadcast``, ``batch_isend_irecv``.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch
import torch.distributed as dist

from repro_torch import obs as _obs

__all__ = ["MeshAxes", "GLOO_CUDA", "staged", "all_gather", "all_reduce",
           "broadcast", "p2p_start", "gather_channels", "gather_batch",
           "shard_batch", "sum_grad", "rows"]

# The collectives gloo runs on CUDA tensors, as tools/gloo_cuda_probe.py
# read them on the H100 under torch 2.11: all_gather (list and tensor
# forms), all_reduce and broadcast give the right values; send/recv and
# batch_isend_irecv abort the rank (gloo writes the device pointer to its
# socket).  The rest ("p2p") are staged through host memory.
GLOO_CUDA = frozenset({"all_gather", "all_reduce", "broadcast"})

_NO_SPAN = contextlib.nullcontext()


@dataclasses.dataclass(frozen=True, eq=False)
class MeshAxes:
    """This rank's place on a ``("data", "model")`` mesh that spans the
    whole process group: the mesh ``shape``, the rank's ``data`` and
    ``model`` indices, and the groups of its axes (``data_group``: the
    ranks of its model index, ``model_group``: the ranks of its data
    index; ``world_group``: every rank)."""

    shape: tuple[int, int]
    data: int
    model: int
    data_group: object
    model_group: object
    world_group: object

    @classmethod
    def of(cls, mesh) -> "MeshAxes":
        """The axes of a :func:`repro_torch.launch.mesh.make_local_mesh`
        mesh over every rank."""
        shape = tuple(int(v) for v in mesh.shape)
        if shape[0] * shape[1] != dist.get_world_size():
            raise ValueError(f"mesh {shape} does not span the "
                             f"{dist.get_world_size()} ranks")
        return cls(shape=shape, data=mesh.get_local_rank("data"),
                   model=mesh.get_local_rank("model"),
                   data_group=mesh.get_group("data"),
                   model_group=mesh.get_group("model"),
                   world_group=dist.group.WORLD)


def rows(n: int, parts: int, index: int) -> tuple[int, int]:
    """``[lo, hi)`` of part ``index`` of ``n`` rows split evenly in
    ``parts``, as ``shard_map``'s ``P("data")`` and a tiled gather lay
    them out."""
    if n % parts:
        raise ValueError(f"{n} does not divide over {parts}")
    k = n // parts
    return index * k, (index + 1) * k


def staged(op: str, t: torch.Tensor, group) -> bool:
    """Whether ``op`` on ``t`` over ``group`` goes through host memory:
    a CUDA tensor over a ``gloo`` group, for a collective gloo does not
    run on the card (not in :data:`GLOO_CUDA`)."""
    return t.is_cuda and op not in GLOO_CUDA and \
        dist.get_backend(group) == "gloo"


def _host(t: torch.Tensor) -> torch.Tensor:
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    return out.copy_(t)


def _span(op: str, t: torch.Tensor, group, axis: str | None, host: bool,
          **extra):
    _obs.counter("mesh.collectives", op=op).inc()
    if host:
        _obs.counter("mesh.staged", op=op).inc()
    if not _obs.is_enabled():
        return _NO_SPAN
    attrs = dict(op=op, axis=axis, bytes=t.numel() * t.element_size(),
                 ranks=dist.get_world_size(group), **extra)
    if host:
        attrs["staged"] = "host"
    return _obs.trace("mesh.collective", **attrs)


def all_gather(t: torch.Tensor, dim: int, group, axis: str | None = None
               ) -> torch.Tensor:
    """The ranks' ``t`` concatenated on ``dim`` in group-rank order."""
    host = staged("all_gather", t, group)
    with _span("all_gather", t, group, axis, host):
        src = _host(t) if host else t.contiguous()
        parts = [torch.empty_like(src)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, src, group=group)
        out = torch.cat(parts, dim=dim)
        return out.to(t.device, non_blocking=True) if host else out


_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def all_reduce(t: torch.Tensor, group, axis: str | None = None,
               op: str = "sum") -> torch.Tensor:
    """The sum (``op="sum"``) or the elementwise max (``op="max"``) over
    the group's ranks of ``t`` (a new tensor).  Either counts as an
    ``all_reduce`` (its span records ``reduce=op``) and is staged as
    :data:`GLOO_CUDA` says."""
    if op not in _REDUCE_OPS:
        raise ValueError(f"all_reduce op {op!r}: one of {tuple(_REDUCE_OPS)}")
    host = staged("all_reduce", t, group)
    with _span("all_reduce", t, group, axis, host, reduce=op):
        buf = _host(t) if host else t.contiguous().clone()
        dist.all_reduce(buf, op=_REDUCE_OPS[op], group=group)
        return buf.to(t.device, non_blocking=True) if host else buf


def broadcast(t: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """``t`` of global rank ``src`` on every rank, in place (``t`` is
    returned)."""
    host = staged("broadcast", t, group)
    with _span("broadcast", t, group, None, host):
        if not host:
            dist.broadcast(t, src, group=group)
            return t
        buf = _host(t)
        dist.broadcast(buf, src, group=group)
        return t.copy_(buf)


def p2p_start(t: torch.Tensor, to: int, frm: int, group):
    """Send ``t`` to group rank ``to`` and receive a tensor like it from
    group rank ``frm``, both started at once (``batch_isend_irecv``);
    returns a function that waits for both and gives the received
    tensor (on ``t``'s device)."""
    host = staged("p2p", t, group)
    with _span("p2p", t, group, None, host):
        src = _host(t) if host else t.contiguous()
        got = torch.empty_like(src)
        works = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, src, dist.get_global_rank(group, to),
                       group),
            dist.P2POp(dist.irecv, got, dist.get_global_rank(group, frm),
                       group)])

    def wait(src=src) -> torch.Tensor:   # the send buffer lives until then
        for work in works:
            work.wait()
        return got.to(t.device, non_blocking=True) if host else got

    return wait


class _GatherLast(torch.autograd.Function):
    """Tiled all-gather on the last axis; backward: the own slice."""

    @staticmethod
    def forward(ctx, x, group, axis):
        ctx.group = group
        ctx.width = x.shape[-1]
        return all_gather(x, x.ndim - 1, group, axis)

    @staticmethod
    def backward(ctx, g):
        k = ctx.width
        i = dist.get_rank(ctx.group)
        return g[..., i * k:(i + 1) * k], None, None


class _GatherRows(torch.autograd.Function):
    """Tiled all-gather on the batch axis; backward: the own rows."""

    @staticmethod
    def forward(ctx, x, group, axis):
        ctx.group = group
        ctx.n = x.shape[0]
        return all_gather(x, 0, group, axis)

    @staticmethod
    def backward(ctx, g):
        i = dist.get_rank(ctx.group)
        return g[i * ctx.n:(i + 1) * ctx.n], None, None


class _ShardRows(torch.autograd.Function):
    """The rank's rows of a replicated batch; backward: the ranks' row
    cotangents summed, i.e. gathered."""

    @staticmethod
    def forward(ctx, x, group, axis):
        ctx.group, ctx.axis = group, axis
        lo, hi = rows(x.shape[0], dist.get_world_size(group),
                      dist.get_rank(group))
        return x[lo:hi]

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, 0, ctx.group, ctx.axis), None, None


class _SumGrad(torch.autograd.Function):
    """Identity; backward: the cotangent summed over the group."""

    @staticmethod
    def forward(ctx, x, group, axis):
        ctx.group, ctx.axis = group, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group, ctx.axis), None, None


def _trivial(group) -> bool:
    return dist.get_world_size(group) == 1


def gather_channels(x: torch.Tensor, group, axis: str = "model"
                    ) -> torch.Tensor:
    """``x``'s Cout shards of the group's ranks, whole on the last axis
    (a no-op over one rank)."""
    return x if _trivial(group) else _GatherLast.apply(x, group, axis)


def gather_batch(x: torch.Tensor, group, axis: str = "data"
                 ) -> torch.Tensor:
    """The group's batch shards of ``x``, whole on axis 0."""
    return x if _trivial(group) else _GatherRows.apply(x, group, axis)


def shard_batch(x: torch.Tensor, group, axis: str = "data"
                ) -> torch.Tensor:
    """The rank's rows of the replicated batch ``x``."""
    return x if _trivial(group) else _ShardRows.apply(x, group, axis)


def sum_grad(x: torch.Tensor, group, axis: str | None = None
             ) -> torch.Tensor:
    """``x``, whose cotangent is summed over the group's ranks."""
    if _trivial(group) or not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _SumGrad.apply(x, group, axis)
