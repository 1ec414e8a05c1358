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

**The transports.**  Each collective has one body; :func:`_transport`
picks how it moves the tensors: gloo as it is, gloo staged through host
memory, or the shared-card staging buffers below.

**Ranks sharing one card.**  This transport exists only for ranks that
share one card, as a mesh rehearsed on one device does; ranks on cards
of their own never take it.  gloo moves a CUDA tensor through host
memory and its TCP loopback, about 0.35 GB/s between two ranks on the
H100's host.  Where every rank of a gloo group holds the same card
(:func:`shares_card`, read once a group), ``all_gather``,
``all_reduce`` and ``broadcast`` instead go through each rank's
staging buffer on the card (``STAGING_BYTES``), which every other rank
of the group maps once by CUDA IPC (:func:`_exchange`): chunk by chunk
each rank copies its part in, a barrier, every rank reads all the
buffers in group-rank order (so a sum is added in the same order on
every rank and its result is the same everywhere), a barrier.  The
buffers are the process's own for its life: CUDA IPC keeps a shared
allocation alive past its tensor, so the callers' tensors are never
shared.  Such a call records ``transport="ipc"`` on its span and counts
``mesh.ipc``.

**Host staging.**  ``gloo`` runs only some collectives on CUDA tensors.
The rule is stated, never found by catching an error: a collective
named in :data:`GLOO_CUDA` runs on the card's tensors as they are;
another, on a CUDA tensor over a ``gloo`` group, is staged through
pinned host memory (:func:`staged`).  A staged call records
``staged="host"`` on its ``mesh.collective`` span and counts
``mesh.staged``.  ``tools/gloo_cuda_probe.py`` reads the table off the
card.  Every call counts ``mesh.collectives`` (label ``op``) and, with
tracing on, records a ``mesh.collective`` span (``op``, ``axis``,
``bytes``, the rank count ``ranks``); a count of a step in progress
(``utils/opcount.py``) gets its kind, bytes and group.

Only APIs of both torch 2.11 and 2.13: the list form of ``all_gather``
(``all_gather_into_tensor`` warns of deprecation on 2.13), ``all_reduce``,
``broadcast``, ``batch_isend_irecv``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import socket

import torch
import torch.distributed as dist

from repro_torch import obs as _obs
from repro_torch.utils.opcount import record_collective

__all__ = ["MeshAxes", "TensorGroup", "axes_group", "GLOO_CUDA", "staged",
           "all_gather", "all_reduce", "broadcast", "p2p_start",
           "gather_channels", "gather_batch", "shard_batch", "sum_grad", "rows", "reduce_from_model",
           "reduce_scatter", "model_sum", "leaf_whole", "leaf_part",
           "vocab_embed", "vocab_logsumexp", "vocab_pick",
           "release_staging", "shares_card"]

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


@dataclasses.dataclass(frozen=True, eq=False)
class TensorGroup:
    """A mesh axis's group as the LLM's layers use it: the process
    ``group``, its ``size`` and this rank's ``index`` on it."""

    group: object
    size: int
    index: int

    @classmethod
    def of(cls, mesh, axis: str) -> "TensorGroup":
        """The group of ``axis`` on the ``DeviceMesh`` ``mesh``."""
        return cls(group=mesh.get_group(axis),
                   size=int(mesh.size(mesh.mesh_dim_names.index(axis))),
                   index=int(mesh.get_local_rank(axis)))

    @classmethod
    def over(cls, mesh, axes) -> "TensorGroup":
        """The group of the ranks that differ from this one only on
        ``axes`` (:func:`axes_group`), its size and this rank's index on
        it (the axes in the mesh's order, the first the major)."""
        names = [a for a in mesh.mesh_dim_names if a in axes]
        if len(names) == 1:
            return cls.of(mesh, names[0])
        size, index = 1, 0
        for a in names:
            n = int(mesh.size(mesh.mesh_dim_names.index(a)))
            size, index = size * n, index * n + int(mesh.get_local_rank(a))
        return cls(group=axes_group(mesh, names), size=size, index=index)


def axes_group(mesh, axes):
    """The process group of this rank and the ranks that differ from it
    only on the ``DeviceMesh`` ``mesh``'s ``axes``: one axis's group,
    the whole world where ``axes`` are all of the mesh's, else the
    group of the sub-mesh over ``axes`` flattened (on a mesh with a
    ``pod`` axis: its ``("pod", "data")`` or ``("data", "model")``
    ranks)."""
    names = tuple(a for a in mesh.mesh_dim_names if a in axes)
    if len(names) == 1:
        return mesh.get_group(names[0])
    if len(names) == len(mesh.mesh_dim_names):
        return dist.group.WORLD
    return mesh[names]._flatten().get_group()


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


def _span(op: str, t: torch.Tensor, group, axis: str | None, how: str,
          **extra):
    record_collective(op, t, group)
    _obs.counter("mesh.collectives", op=op).inc()
    if how == "host":
        _obs.counter("mesh.staged", op=op).inc()
    elif how == "ipc":
        _obs.counter("mesh.ipc", op=op).inc()
    if not _obs.is_enabled():
        return _NO_SPAN
    attrs = dict(op=op, axis=axis, bytes=t.numel() * t.element_size(),
                 ranks=dist.get_world_size(group), **extra)
    if how == "host":
        attrs["staged"] = "host"
    elif how == "ipc":
        attrs["transport"] = "ipc"
    return _obs.trace("mesh.collective", **attrs)


def _transport(op: str, t: torch.Tensor, group) -> str:
    """How ``op`` moves ``t`` over ``group``: ``"ipc"`` where every rank
    of the gloo group holds ``t``'s card (:func:`shares_card`; the
    collectives of :data:`_IPC` only), ``"host"`` where :func:`staged`
    says so, else ``"gloo"`` (the backend as it is)."""
    if op in _IPC and shares_card(t, group):
        return "ipc"
    return "host" if staged(op, t, group) else "gloo"


def _collective(op: str, how: str, *args, group) -> None:
    """``op`` on contiguous tensors, in place as ``torch.distributed``'s,
    through ``how`` (:func:`_transport`; ``"host"``: the caller has
    staged the tensors already)."""
    (_IPC if how == "ipc" else _GLOO)[op](*args, group)


# -- the shared-card transport: only for ranks that share one card (the
# ranks of a mesh rehearsed on one device); ranks on cards of their own
# never take it

# (group, card index) -> whether every rank of the group holds that card
_SHARED_CARD: dict = {}


def shares_card(t: torch.Tensor, group) -> bool:
    """Whether ``t`` is a CUDA tensor and every rank of the gloo group
    ``group`` holds its card (the same host and device UUID), read once a
    group by an ``all_gather_object`` that every rank's first collective
    on the group makes."""
    if not t.is_cuda or dist.get_backend(group) != "gloo":
        return False
    key = (group or dist.group.WORLD, t.device.index)
    if key not in _SHARED_CARD:
        mine = (socket.gethostname(),
                str(torch.cuda.get_device_properties(t.device).uuid))
        everyone = [None] * dist.get_world_size(group)
        dist.all_gather_object(everyone, mine, group=group)
        _SHARED_CARD[key] = all(e == mine for e in everyone)
    return _SHARED_CARD[key]


# each rank's staging buffer on the shared card, and per group the
# buffers of its ranks (this rank's own among them) in group-rank order
STAGING_BYTES = 256 << 20
_STAGING: dict = {}


def _staging(group, device) -> list[torch.Tensor]:
    """The group's ranks' staging buffers (bytes) in group-rank order:
    this rank's own, the others' mapped by CUDA IPC (the handles cross
    over gloo once a group)."""
    from torch.multiprocessing.reductions import reduce_tensor
    key = (group or dist.group.WORLD, device.index)
    if key not in _STAGING:
        mine = _STAGING.get(("own", device.index))
        if mine is None:
            mine = _STAGING[("own", device.index)] = torch.empty(
                STAGING_BYTES, dtype=torch.uint8, device=device)
        shared = [None] * dist.get_world_size(group)
        dist.all_gather_object(shared, reduce_tensor(mine), group=group)
        me = dist.get_rank(group)
        _STAGING[key] = [mine if i == me else rebuild(*args)
                         for i, (rebuild, args) in enumerate(shared)]
    return _STAGING[key]


def release_staging() -> None:
    """Every rank, as it finishes: drops its maps of the other ranks'
    staging buffers, then a barrier, so that no rank's buffers leave
    before the others have let them go."""
    for key in [k for k in _STAGING if k[0] != "own"]:
        del _STAGING[key]
    dist.barrier()
    _STAGING.clear()


def _exchange(src: torch.Tensor, group, read) -> None:
    """Every rank's contiguous ``src`` (same shape and dtype on each)
    through the staging buffers, a chunk at a time: ``read(lo, hi,
    parts)`` gets the group's ranks' bytes ``[lo, hi)`` of their ``src``
    in group-rank order (``uint8`` views, valid until it returns), and
    may write ``src[lo:hi]``: its chunk is staged already."""
    bufs = _staging(group, src.device)
    flat = src.detach().view(-1).view(torch.uint8)
    me = dist.get_rank(group)
    stream = torch.cuda.current_stream(src.device)
    for lo in range(0, flat.numel(), STAGING_BYTES):
        hi = min(flat.numel(), lo + STAGING_BYTES)
        bufs[me][:hi - lo].copy_(flat[lo:hi])
        stream.synchronize()
        dist.barrier(group=group)
        read(lo, hi, [b[:hi - lo] for b in bufs])
        stream.synchronize()
        dist.barrier(group=group)


def _bytes(t: torch.Tensor) -> torch.Tensor:
    return t.view(-1).view(torch.uint8)


def _ipc_all_gather(parts: list, src: torch.Tensor, group) -> None:
    dests = [_bytes(p) for p in parts]

    def read(lo, hi, staged_parts):
        for d, part in zip(dests, staged_parts):
            d[lo:hi].copy_(part)
    _exchange(src, group, read)


def _ipc_all_reduce(buf: torch.Tensor, op: str, group) -> None:
    """The sum (or max) added in group-rank order on every rank, so each
    holds the same bits."""
    dest = _bytes(buf)

    def read(lo, hi, staged_parts):
        acc = dest[lo:hi].view(buf.dtype)
        acc.copy_(staged_parts[0].view(buf.dtype))
        for part in staged_parts[1:]:
            if op == "max":
                torch.maximum(acc, part.view(buf.dtype), out=acc)
            else:
                acc.add_(part.view(buf.dtype))
    _exchange(buf, group, read)


def _ipc_broadcast(buf: torch.Tensor, src: int, group) -> None:
    dest = _bytes(buf)
    owner = src if group is None else dist.get_group_rank(group, src)

    def read(lo, hi, staged_parts):
        dest[lo:hi].copy_(staged_parts[owner])
    _exchange(buf, group, read)


_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}
_IPC = {"all_gather": _ipc_all_gather, "all_reduce": _ipc_all_reduce,
        "broadcast": _ipc_broadcast}
_GLOO = {"all_gather": lambda parts, src, group: dist.all_gather(
             parts, src, group=group),
         "all_reduce": lambda buf, op, group: dist.all_reduce(
             buf, op=_REDUCE_OPS[op], group=group),
         "broadcast": lambda buf, src, group: dist.broadcast(
             buf, src, group=group)}


def all_gather(t: torch.Tensor, dim: int, group, axis: str | None = None
               ) -> torch.Tensor:
    """The ranks' ``t`` concatenated on ``dim`` in group-rank order."""
    how = _transport("all_gather", t, group)
    with _span("all_gather", t, group, axis, how):
        src = _host(t) if how == "host" else t.contiguous()
        parts = [torch.empty_like(src)
                 for _ in range(dist.get_world_size(group))]
        _collective("all_gather", how, parts, src, group=group)
        out = torch.cat(parts, dim=dim)
        return out.to(t.device, non_blocking=True) if how == "host" else out


def all_reduce(t: torch.Tensor, group, axis: str | None = None,
               op: str = "sum") -> torch.Tensor:
    """The sum (``op="sum"``) or the elementwise max (``op="max"``) over
    the group's ranks of ``t`` (a new tensor).  Either counts as an
    ``all_reduce`` (its span records ``reduce=op``)."""
    if op not in _REDUCE_OPS:
        raise ValueError(f"all_reduce op {op!r}: one of {tuple(_REDUCE_OPS)}")
    how = _transport("all_reduce", t, group)
    with _span("all_reduce", t, group, axis, how, reduce=op):
        buf = _host(t) if how == "host" else t.contiguous().clone()
        _collective("all_reduce", how, buf, op, group=group)
        return buf.to(t.device, non_blocking=True) if how == "host" else buf


def broadcast(t: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """``t`` of global rank ``src`` on every rank, in place (``t`` is
    returned)."""
    how = _transport("broadcast", t, group)
    with _span("broadcast", t, group, None, how):
        buf = _host(t) if how == "host" else t.contiguous()
        _collective("broadcast", how, buf, src, group=group)
        return t if buf is t else t.copy_(buf)


def p2p_start(t: torch.Tensor, to: int, frm: int, group):
    """Send ``t`` to group rank ``to`` and receive a tensor like it from
    group rank ``frm``, both started at once (``batch_isend_irecv``);
    returns a function that waits for both and gives the received
    tensor (on ``t``'s device)."""
    how = _transport("p2p", t, group)
    host = how == "host"
    with _span("p2p", t, group, None, how):
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


def _sum_f32(t: torch.Tensor, group, axis: str | None) -> torch.Tensor:
    """The group's sum of ``t`` carried in f32 and rounded once to
    ``t``'s dtype: partial sums of a low-precision tensor cross the wire
    at the accumulation precision."""
    return all_reduce(t.float(), group, axis).to(t.dtype)


class _SumGrad(torch.autograd.Function):
    """Identity; backward: the cotangent summed over the group."""

    @staticmethod
    def forward(ctx, x, group, axis, f32):
        ctx.group, ctx.axis, ctx.f32 = group, axis, f32
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        total = _sum_f32(g, ctx.group, ctx.axis) if ctx.f32 \
            else all_reduce(g, ctx.group, ctx.axis)
        return total, None, None, None


class _ReduceFrom(torch.autograd.Function):
    """The group's sum (in f32, rounded once); backward: identity."""

    @staticmethod
    def forward(ctx, x, group, axis):
        return _sum_f32(x, group, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherLeaf(torch.autograd.Function):
    """Tiled all-gather on ``dim``; backward: the cotangents summed over
    the group (in f32, rounded once), this rank's block."""

    @staticmethod
    def forward(ctx, x, group, dim, axis):
        ctx.group, ctx.dim, ctx.axis, ctx.n = group, dim, axis, x.shape[dim]
        return all_gather(x, dim, group, axis)

    @staticmethod
    def backward(ctx, g):
        i = dist.get_rank(ctx.group)
        return _sum_f32(g, ctx.group, ctx.axis).narrow(
            ctx.dim, i * ctx.n, ctx.n).contiguous(), None, None, None


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


def sum_grad(x: torch.Tensor, group, axis: str | None = None,
             f32: bool = False) -> torch.Tensor:
    """``x``, whose cotangent is summed over the group's ranks (``f32``:
    carried in f32 and rounded once)."""
    if _trivial(group) or not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _SumGrad.apply(x, group, axis, f32)


# -- tensor parallelism of the LLM (Megatron's pair) ----------------------
#
# Every rank of a ``model`` group computes the same loss, so a cotangent
# reaching a replicated activation is the same on every rank.
# ``sum_grad(x, group, f32=True)`` enters sharded compute from a
# replicated ``x`` (each rank's ``dx`` is a partial sum over its heads or
# columns); :func:`reduce_from_model` leaves it, summing the ranks'
# partial outputs.


def reduce_from_model(x: torch.Tensor, group, axis: str = "model"
                      ) -> torch.Tensor:
    """The sum over the group's ranks of their partial ``x`` (carried in
    f32, rounded once to ``x``'s dtype); its backward is the identity."""
    return x if _trivial(group) else _ReduceFrom.apply(x, group, axis)


def model_sum(x: torch.Tensor, group, axis: str = "model") -> torch.Tensor:
    """The group's sum of the ranks' partial ``x`` (in f32, rounded once)
    where each rank's use of the sum differs (a norm's sum of squares
    over channels split over the group): the backward sums the ranks'
    cotangents too."""
    if _trivial(group):
        return x
    return reduce_from_model(sum_grad(x, group, axis, f32=True), group, axis)


def leaf_whole(w: torch.Tensor, shape: tuple, tp) -> torch.Tensor:
    """The whole of a parameter of ``shape`` held as this rank's block
    (``tp``: the model's ``TensorGroup``) for compute that each rank runs
    on a part of its own (its padded heads, its SSM heads' columns of a
    packed projection): gathered on the dim the rules split, the
    backward summing the ranks' cotangents and keeping this rank's block
    (a reduce-scatter); or, replicated, with its cotangent summed over
    the group (:func:`sum_grad`)."""
    split = [d for d in range(w.ndim) if w.shape[d] < shape[d]]
    if not split:
        return sum_grad(w, tp.group, "model", f32=True)
    if _trivial(tp.group):
        return w
    return _GatherLeaf.apply(w, tp.group, split[0], "model")


def leaf_part(w: torch.Tensor, shape: tuple, tp, dim: int, lo: int,
              hi: int) -> torch.Tensor:
    """``[lo, hi)`` on ``dim`` of a parameter of ``shape`` as this rank's
    compute reads it: its own block where the rules cut exactly that
    part, else the part of :func:`leaf_whole`.  Without ``tp`` ``w`` is
    whole and cut."""
    dim %= w.ndim
    if tp is not None:
        n = w.shape[dim]
        if n < shape[dim] and tp.index * n == lo and hi - lo == n:
            return w
        w = leaf_whole(w, shape, tp)
    return w.narrow(dim, lo, hi - lo)


def reduce_scatter(t: torch.Tensor, group, dim: int, axis: str = "data"
                   ) -> torch.Tensor:
    """The group's sum of ``t`` (f32 on the wire, rounded once), cut to
    this rank's block of ``dim`` (:func:`rows`).  ``gloo`` has no
    reduce-scatter: an ``all_reduce`` then the own block, the same
    values."""
    if _trivial(group):
        return t
    lo, hi = rows(t.shape[dim], dist.get_world_size(group),
                  dist.get_rank(group))
    # a copy of the block: a view would keep the whole sum alive
    return _sum_f32(t, group, axis).narrow(dim, lo, hi - lo).clone()


def vocab_embed(tokens: torch.Tensor, table: torch.Tensor, offset: int,
                group) -> torch.Tensor:
    """Rows ``tokens`` of a table split over the group on its rows (this
    rank's block holds rows ``offset + 0..len-1``): each rank looks up
    the tokens it holds, zeros elsewhere, and one sum over the group
    assembles them; differentiable (each block gets its own rows'
    gradients)."""
    local = tokens - offset
    mine = (local >= 0) & (local < table.shape[0])
    rows_ = torch.nn.functional.embedding(local.clamp(0, table.shape[0] - 1),
                                          table)
    rows_ = torch.where(mine[..., None], rows_, rows_.new_zeros(()))
    return reduce_from_model(rows_, group)


def vocab_logsumexp(logits: torch.Tensor, group) -> torch.Tensor:
    """``logsumexp`` over the last axis of logits split over the group on
    it (each rank its columns): one ``max`` (no gradient, as the shift
    of any logsumexp) and one sum of ``exp``; differentiable."""
    with torch.no_grad():
        m = logits.amax(dim=-1)
        if not _trivial(group):
            m = all_reduce(m, group, "model", op="max")
    s = torch.exp(logits - m[..., None]).sum(dim=-1)
    return m + torch.log(reduce_from_model(s, group))


def vocab_pick(logits: torch.Tensor, labels: torch.Tensor, offset: int,
               group) -> torch.Tensor:
    """``logits[..., labels]`` of logits split over the group on the last
    axis (this rank's columns ``offset + 0..n-1``): the rank holding a
    label gives its logit, the others 0, and one sum; differentiable."""
    local = labels - offset
    mine = (local >= 0) & (local < logits.shape[-1])
    got = torch.gather(logits, -1,
                       local.clamp(0, logits.shape[-1] - 1)[..., None])[..., 0]
    return reduce_from_model(torch.where(mine, got, got.new_zeros(())), group)
