"""Counted cost of one rank's step: FLOPs, HBM bytes, collective bytes,
and argument, output and peak memory (the port of ``repro.utils.hlo``).

The reference compiles a step with XLA and parses the optimized HLO
text (``analyze_hlo``), multiplying each ``while`` body by its trip
count.  The port has no XLA: :func:`count` runs the step once under a
``TorchDispatchMode`` and counts every aten op it dispatches.  PyTorch
runs eagerly, so each layer and each microbatch dispatches its own ops,
and the count is already what the reference's ``known_trip_count``
multipliers rebuild.  Run on ``meta`` tensors (``launch/specs.py``) the
step allocates nothing and needs no card; run on the card it counts
what the card runs.

The model:

* **FLOPs**: the products only, as the reference's ``dot`` and
  ``convolution``: ``mm``, ``addmm``, ``bmm`` and ``baddbmm`` count
  2·|result|·contracted, ``convolution`` 2·|result|·K_spatial·Cin/groups
  and ``convolution_backward`` that of each gradient it computes (the
  formulas of ``torch.utils.flop_counter``).  Elementwise FLOPs are not
  counted.  A hand-written kernel is not an aten op: its ``meta``
  launcher reports its launch with its own cost rule
  (:func:`record_kernel`; ``kernels/flash_attention.py``
  ``flash_attention_meta``), counted here beside the aten ops and
  listed apart under ``kernels``.
* **Bytes**: here the port departs from the reference.  XLA on a TPU
  fuses elementwise chains, so ``analyze_hlo`` counts only an
  elementwise op's result (``hlo.py`` ``_RESULT_ONLY_OPS``).  The port
  runs eagerly and fuses nothing: every op that writes memory counts
  the bytes of its tensor operands plus those of its results.  An
  in-place op counts its other operands and the bytes it changes (an
  indexed write such as ``index_put_`` the values it writes).  A view
  (``view``, a ``reshape`` of a contiguous tensor, ``transpose``,
  ``expand``, ``slice``, ``as_strided``: a result on its operand's
  storage) counts nothing; a copy (``clone`` behind ``contiguous``,
  ``cat``, ``index_select``, ``_to_copy`` behind ``to``) counts a read
  and a write; a gather (``embedding``, ``index_select``, ``gather``,
  ``index``) reads its indices and only the rows it copies.  An operand
  counts its distinct elements (an expanded dim is read once).  Allocations (``empty*``) count nothing.  Ops that
  touch no tensor off the CPU (host scalars) count nothing.
* **Collectives**: every collective of the port passes through
  ``sharding/collectives.py`` ``_span``, which reports it here
  (:func:`record_collective`): its kind in the reference's names
  (``all-gather``, ``all-reduce``, ``collective-permute`` for a
  send/receive pair, and ``broadcast``), the bytes it moves (max of
  operand and result, the reference's rule: an all-gather moves its
  output), one execution, and whether its group's ranks span two nodes
  (:func:`crosses`, the port of ``_crosses_pod``): the bytes of such a
  collective also count under ``collective_dcn_bytes``.  The port's
  ``reduce_scatter`` is an all-reduce and a slice (gloo has none), and
  counts as the all-reduce it runs.
* **Memory**: argument bytes are the step's input tensors' storages;
  every storage an op creates on the step's device is live from then
  until Python drops its last tensor (autograd's saved tensors stay
  live until the backward, as on the card).  The peak is the largest
  sum of live storages, arguments included; temp is the peak less the
  arguments; output bytes are the result's storages, and alias bytes
  those of them that are argument storages (the state or cache a step
  updates in place).
"""

from __future__ import annotations

import dataclasses
import time
import weakref
from collections import defaultdict

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["OpCount", "count", "crosses", "record_kernel",
           "record_collective", "DTYPE_BYTES", "GPUS_PER_NODE", "DOT_OPS"]

# the H100 roofline's node: 8 GPUs behind one NVLink switch; a group of
# ranks spanning two nodes goes over the network
GPUS_PER_NODE = 8

# the bytes of an element by dtype: the reference's HLO dtype byte table
DTYPE_BYTES = {
    torch.float64: 8, torch.float32: 4, torch.float16: 2,
    torch.bfloat16: 2, torch.float8_e4m3fn: 1, torch.float8_e5m2: 1,
    torch.int64: 8, torch.uint64: 8, torch.int32: 4, torch.uint32: 4,
    torch.int16: 2, torch.uint16: 2, torch.int8: 1, torch.uint8: 1,
    torch.bool: 1, torch.complex64: 8, torch.complex128: 16,
}

# the product ops whose FLOPs are counted (the profiler's and
# flop_counter's names for them)
DOT_OPS = ("mm", "addmm", "bmm", "baddbmm")
# in-place ops whose change is the values they write, not all of self
_INDEXED_WRITES = {"index_put_", "_index_put_impl_", "index_copy_",
                   "index_add_", "scatter_", "scatter_add_",
                   "scatter_reduce_", "masked_scatter_"}
# gathers read only the rows they copy: their indices, and the result's
# bytes from the table (XLA's ``gather``, a result-only op, too)
_GATHERS = {"embedding", "index_select", "gather", "index"}
_KINDS = {"all_gather": "all-gather", "all_reduce": "all-reduce",
          "p2p": "collective-permute", "broadcast": "broadcast"}

_ACTIVE: list = []


def crosses(ranks, stride: int) -> bool:
    """Whether a group of global ``ranks`` spans two blocks of ``stride``
    consecutive ranks (two nodes of ``stride`` GPUs, or two pods): the
    port of the reference's ``_crosses_pod``."""
    return len({int(r) // stride for r in ranks}) > 1


def _distinct_bytes(t: torch.Tensor) -> int:
    """The bytes of ``t``'s distinct elements: a dim of stride 0 (an
    expanded one) is read once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if size == 0:
            return 0
        if stride != 0:
            n *= size
    return n * DTYPE_BYTES[t.dtype]


def _tensors(x, out: list) -> list:
    """The tensors of an op's arguments or results (nested in lists and
    tuples), in order."""
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for y in x:
            _tensors(y, out)
    elif isinstance(x, dict):
        for y in x.values():
            _tensors(y, out)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * DTYPE_BYTES[t.dtype]


def _prod(xs) -> int:
    n = 1
    for x in xs:
        n *= int(x)
    return n


def _dot_flops(name: str, args, out) -> float:
    """2·|result|·contracted of a product op (``torch.utils.
    flop_counter``'s formulas)."""
    if name in ("mm", "bmm"):
        a = args[0]
    elif name in ("addmm", "baddbmm"):
        a = args[1]
    else:
        return 0.0
    return 2.0 * out.numel() * a.shape[-1]


def _conv_flops(x_shape, w_shape, out_shape, transposed) -> float:
    """2·batch·|weight|·|output's spatial dims| (the input's when
    ``transposed``): 2·|result|·K_spatial·Cin/groups of a convolution,
    ``torch.utils.flop_counter``'s ``conv_flop_count``."""
    spatial = (x_shape if transposed else out_shape)[2:]
    return 2.0 * int(x_shape[0]) * _prod(w_shape) * _prod(spatial)


def _conv_backward_flops(args) -> float:
    """``convolution_backward``: the FLOPs of each gradient it computes,
    the input's (a convolution of the output's gradient) and the
    weight's (as many as the forward's)."""
    grad_out, x, w = args[0], args[1], args[2]
    transposed, mask = bool(args[7]), args[10]
    flops = 0.0
    if mask[0]:
        flops += _conv_flops(grad_out.shape, w.shape, x.shape,
                             not transposed)
    if mask[1]:
        flops += _conv_flops(x.shape, w.shape, grad_out.shape, transposed)
    return flops


@dataclasses.dataclass
class OpCount:
    """One rank's counted step.  ``flops``, ``bytes``,
    ``collective_bytes`` (by kind), ``collective_dcn_bytes`` (of the
    collectives whose group crosses a node) and ``n_collectives`` (by
    kind) are the reference's ``HloCost`` fields; ``kernels`` holds each
    hand-written kernel's launches by ``"dtype/dk/dv"`` geometry and its
    ``flops``, ``useful_flops`` and ``bytes``; ``ops`` each aten op's
    ``calls``, ``flops`` and ``bytes``; the memory record ``memory``
    (``argument_bytes``, ``output_bytes``, ``alias_bytes``,
    ``temp_bytes``, ``peak_bytes``); ``seconds`` the count's time."""
    flops: float = 0.0
    bytes: float = 0.0
    collective_bytes: dict = dataclasses.field(
        default_factory=lambda: defaultdict(float))
    collective_dcn_bytes: float = 0.0
    n_collectives: dict = dataclasses.field(
        default_factory=lambda: defaultdict(int))
    kernels: dict = dataclasses.field(default_factory=dict)
    ops: dict = dataclasses.field(default_factory=dict)
    memory: dict = dataclasses.field(default_factory=dict)
    seconds: float = 0.0

    def op_flops(self, names=DOT_OPS) -> float:
        """The FLOPs of the aten ops ``names`` (default the products)."""
        return sum(self.ops[n]["flops"] for n in names if n in self.ops)

    def to_json(self) -> dict:
        return {
            "flops": self.flops,
            "bytes": self.bytes,
            "collective_bytes": dict(self.collective_bytes),
            "collective_dcn_bytes": self.collective_dcn_bytes,
            "n_collectives": dict(self.n_collectives),
            "kernels": self.kernels,
            "ops": self.ops,
        }

    # -- accumulation ------------------------------------------------------

    def _op(self, name: str, flops: float, nbytes: float) -> None:
        rec = self.ops.setdefault(name, {"calls": 0, "flops": 0.0,
                                         "bytes": 0.0})
        rec["calls"] += 1
        rec["flops"] += flops
        rec["bytes"] += nbytes
        self.flops += flops
        self.bytes += nbytes

    def _kernel(self, name: str, geometry: str, flops: float,
                useful: float, nbytes: float) -> None:
        rec = self.kernels.setdefault(name, {"launches": {}, "flops": 0.0,
                                             "useful_flops": 0.0,
                                             "bytes": 0.0})
        rec["launches"][geometry] = rec["launches"].get(geometry, 0) + 1
        rec["flops"] += flops
        rec["useful_flops"] += useful
        rec["bytes"] += nbytes
        self.flops += flops
        self.bytes += nbytes

    def _collective(self, kind: str, moved: float, dcn: bool) -> None:
        self.collective_bytes[kind] += moved
        self.n_collectives[kind] += 1
        if dcn:
            self.collective_dcn_bytes += moved


class _Live:
    """Live storages on the step's device, by identity, and their peak."""

    def __init__(self):
        self.bytes = 0
        self.peak = 0
        self._ids: set = set()

    def add(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._ids:
            return
        n = st.nbytes()
        self._ids.add(key)
        self.bytes += n
        self.peak = max(self.peak, self.bytes)
        weakref.finalize(st, self._free, key, n)

    def _free(self, key: int, n: int) -> None:
        if key in self._ids:
            self._ids.discard(key)
            self.bytes -= n


class _Counter(TorchDispatchMode):
    """Counts every op dispatched under it into ``rec``."""

    def __init__(self, rec: OpCount, live: _Live):
        super().__init__()
        self.rec, self.live = rec, live

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ns = func.namespace
        if ns in ("c10d", "_c10d_functional", "_dtensor"):
            return out      # counted where the port calls it (_span)
        ins = _tensors(kwargs, _tensors(args, []))
        outs = _tensors(out, [])
        if not any(t.device.type != "cpu" for t in ins + outs):
            return out
        name = func.__name__.split(".")[0]
        flops = 0.0
        if name in DOT_OPS:
            flops = _dot_flops(name, args, outs[0])
        elif name == "convolution":
            flops = _conv_flops(args[0].shape, args[1].shape,
                                outs[0].shape, bool(args[6]))
        elif name == "convolution_backward":
            flops = _conv_backward_flops(args)
        self.rec._op(name, flops, self._bytes(func, name, ins, outs, args))
        for o in outs:
            if o.device.type != "cpu":
                self.live.add(o)
        return out

    @staticmethod
    def _bytes(func, name: str, ins: list, outs: list, args) -> float:
        if name.startswith("empty") or name in ("new_empty",
                                                "new_empty_strided"):
            return 0.0
        schema = func._schema
        written = [i for i, a in enumerate(schema.arguments)
                   if a.alias_info is not None and a.alias_info.is_write]
        if written:         # in place (or an out= variant)
            mutated = {id(args[i]) for i in written if i < len(args)
                       and isinstance(args[i], torch.Tensor)}
            read = sum(_distinct_bytes(t) for t in ins
                       if id(t) not in mutated)
            if name in _INDEXED_WRITES:
                # the elements written: as many as its values (or index)
                self_ = args[0]
                changed = max((t.numel() for t in ins
                               if id(t) not in mutated), default=0) \
                    * DTYPE_BYTES[self_.dtype]
            else:
                changed = sum(_distinct_bytes(args[i]) for i in written
                              if i < len(args)
                              and isinstance(args[i], torch.Tensor))
            return float(read + changed)
        if name in _GATHERS:
            table = args[0]
            return float(sum(_distinct_bytes(t) for t in ins
                             if t is not table)
                         + 2 * sum(_nbytes(o) for o in outs))
        in_storages = {id(t.untyped_storage()) for t in ins}
        if outs and all(id(o.untyped_storage()) in in_storages
                        for o in outs):
            return 0.0      # a view: a result on its operand's storage
        return float(sum(_distinct_bytes(t) for t in ins)
                     + sum(_nbytes(o) for o in outs))


def record_kernel(name: str, geometry: str, *, flops: float,
                  useful_flops: float, nbytes: float) -> None:
    """A hand-written kernel's launch, reported by its ``meta`` launcher
    with its cost rule, into every count in progress."""
    for rec, _ in _ACTIVE:
        rec._kernel(name, geometry, flops, useful_flops, nbytes)


def record_collective(op: str, t: torch.Tensor, group) -> None:
    """One collective of the port (``sharding/collectives.py``
    ``_span``) on ``t`` over ``group``, into every count in progress:
    its bytes moved (an all-gather's output, else ``t``'s) and whether
    its group crosses a node."""
    if not _ACTIVE:
        return
    ranks = dist.get_process_group_ranks(group or dist.group.WORLD)
    moved = float(_nbytes(t))
    if op == "all_gather":
        moved *= len(ranks)
    kind = _KINDS.get(op, op)
    for rec, stride in _ACTIVE:
        rec._collective(kind, moved, crosses(ranks, stride))


def count(fn, *args, stride: int = GPUS_PER_NODE, **kwargs) -> OpCount:
    """Run ``fn(*args, **kwargs)`` once under the counter and return its
    :class:`OpCount`; ``stride`` is the ranks a node (a collective whose
    group spans two such blocks counts under ``collective_dcn_bytes``).
    The result of ``fn`` is dropped once its bytes are counted."""
    rec = OpCount()
    live = _Live()
    flat_args = [a for a in _tensors(kwargs, _tensors(args, []))
                 if a.device.type != "cpu"]
    for a in flat_args:
        live.add(a)
    arg_storages = {id(a.untyped_storage()) for a in flat_args}
    argument_bytes = live.bytes
    t0 = time.perf_counter()
    _ACTIVE.append((rec, stride))
    try:
        with _Counter(rec, live):
            result = fn(*args, **kwargs)
    finally:
        _ACTIVE.pop()
    rec.seconds = time.perf_counter() - t0
    seen, output_bytes, alias_bytes = set(), 0, 0
    for o in _tensors(result, []):
        if o.device.type == "cpu":
            continue
        st = o.untyped_storage()
        if id(st) in seen:
            continue
        seen.add(id(st))
        output_bytes += st.nbytes()
        if id(st) in arg_storages:
            alias_bytes += st.nbytes()
    del result
    rec.memory = {"argument_bytes": argument_bytes,
                  "output_bytes": output_bytes, "alias_bytes": alias_bytes,
                  "temp_bytes": live.peak - argument_bytes,
                  "peak_bytes": live.peak}
    return rec
