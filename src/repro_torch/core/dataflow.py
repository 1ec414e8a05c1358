"""Unified dataflow dispatch for the GANAX (transposed-)convolution ops.

The port of ``repro.core.dataflow``.  It owns:

1. **The fused epilogue spec** — :class:`Epilogue` (bias add +
   activation), executed inside the kernel's accumulator flush.
2. **μop compilation** — :func:`compile_uops` / :func:`compile_conv_uops`
   turn a layer geometry into frozen numpy tap tables, cached by
   geometry (the paper's static "μop compilation" stage).
3. **Dispatch** — :func:`tconv` / :func:`conv` run one op through a
   registered backend.  The default, ``"ganax"``, is the kernel: on a
   CUDA tensor it launches the hand-written CUDA kernel of the input's
   rank (2-D or 3-D), on a CPU tensor it runs that kernel's plain
   PyTorch version, and on any other rank it raises.  ``"ganax-plain"``
   (the same dataflow through the plain version on any device),
   ``"polyphase"`` and ``"zero-insert"`` are oracles that run only when
   pinned by name.  ``route=`` names the CUDA kernel's route (a tuned
   one: :class:`repro_torch.kernels.ganax_conv.KernelRoute`), and
   ``backend="auto"`` takes backend and route from the tuner's plan.
4. **Resolution as data** — :class:`DataflowPolicy` and
   :func:`resolve_execution` turn a policy and a layer geometry into a
   :class:`Resolution` (backend, the kernel route, the reference's tile
   shapes, provenance, mesh layout): what
   :class:`repro_torch.program.ProgramSpec` freezes ahead of time.
   ``backend="auto"`` consults the autotuning planner
   (:mod:`repro_torch.tune`) with the layer's full geometry.
5. **The gradient** — on the kernel backends, a
   ``torch.autograd.Function`` (the port of the reference's custom
   VJPs): ``dx`` re-enters the same kernel by adjoint duality (a
   tconv's ``dx`` is a conv with swapped weights, a conv's ``dx`` an
   uncropped pad-0 tconv), ``dw`` is a per-tap f32 contraction and
   ``db`` an f32 reduction.  At bf16/f16 storage (mixed-precision
   training) the cotangent stays in the storage dtype: ``dx`` runs
   through the kernel's instance of that dtype (f32 sums, one cast),
   ``dw`` sums the storage-dtype products in f32 and casts once, ``db``
   sums in f32, as the reference's custom VJPs do.  First order only:
   differentiating the backward raises :class:`SecondOrderNotImplemented`.
   The oracles keep PyTorch's native autograd.

Geometry semantics are PyTorch ``ConvTranspose`` / correlation-conv
throughout (channels-last ``x``, ``(K..., Cin, Cout)`` weights).

**Backend names.**  The reference's policies and program files name
JAX backends; the port maps them once, here (:func:`port_backend`,
:meth:`DataflowPolicy.resolve`):

==========================================  ===============================
reference                                   port
==========================================  ===============================
``None`` (heuristic: ``pallas-tpu`` on a    ``ganax`` for 2-D/3-D, else
TPU for 2-D/3-D, else ``polyphase``)        ``polyphase``; source heuristic
``"pallas"``                                ``ganax`` (rank fallback
                                            ``polyphase``)
``"pallas-tpu"`` / ``interpret=False``      ``ganax``
``"pallas-interpret"`` / ``interpret=True`` ``ganax-plain``
``"polyphase"``, ``"zero-insert"``          the same name
``"auto"``                                  ``"auto"``: the planner's plan
                                            (backend and kernel route),
                                            else the heuristic
==========================================  ===============================

The heuristic follows the reference *on its accelerator*: the kernel
for the ranks it implements.  The reference's Pallas ``blocks`` ride
through resolutions and program files as data, checked by its
divisibility rule (:func:`blocks_valid`); the CUDA kernels never read
them.  What the tuner chooses on the card is the kernel's route
(``KernelRoute``: ``tc`` tile width and splits, or ``narrow`` splits),
which resolutions, plans and program files carry beside them.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import obs as _obs
from repro_torch.core.scheduler import PhaseSchedule, make_schedule
from repro_torch.core.tconv import tconv_ganax, tconv_zero_insert
from repro_torch.device import default_platform, platform_of
from repro_torch.device import require_f32_accumulation
from repro_torch.kernels.ganax_conv import KernelRoute, check_route
from repro_torch.quant.precision import canonical_dtype, storage_itemsize

__all__ = [
    "ACTIVATIONS",
    "Epilogue",
    "CompiledUops",
    "ConvUops",
    "compile_uops",
    "compile_conv_uops",
    "KERNEL_RANKS",
    "require_kernel_rank",
    "pallas_kernel_supported",
    "Backend",
    "BACKENDS",
    "register_backend",
    "backend_supports",
    "SecondOrderNotImplemented",
    "tconv",
    "conv",
    "uop_cache_info",
    "uop_cache_clear",
    "available_backends",
    "port_backend",
    "DataflowPolicy",
    "Resolution",
    "SHARDINGS",
    "COUT_SHARD_MIN_BYTES",
    "choose_layer_sharding",
    "resolve_blocks",
    "blocks_valid",
    "kernel_call_geometry",
    "valid_layer_route",
    "resolve_execution",
]


# ---------------------------------------------------------------------------
# Fused epilogue spec.
# ---------------------------------------------------------------------------

ACTIVATIONS = ("none", "relu", "leaky_relu", "tanh")


@dataclasses.dataclass(frozen=True)
class Epilogue:
    """Per-layer epilogue fused into the unified (t)conv op.

    ``bias`` adds a per-output-channel bias vector (the ``bias=``
    argument of :func:`tconv` / :func:`conv`); ``activation`` is applied
    after it.  The kernel backends run both inside the accumulator
    flush; the oracle backends apply :meth:`apply` after the op, so
    every backend computes the same function.  ``leaky_slope`` is
    canonicalized to the default for non-leaky activations so two specs
    that compute the same function compare (and hash) equal.
    """

    bias: bool = False
    activation: str = "none"
    leaky_slope: float = 0.2

    def __post_init__(self):
        if self.activation not in ACTIVATIONS:
            raise ValueError(f"unknown epilogue activation "
                             f"{self.activation!r}; one of {ACTIVATIONS}")
        slope = 0.2 if self.activation != "leaky_relu" \
            else float(self.leaky_slope)
        if not slope >= 0:
            # the reference's backward recovers the leaky derivative from
            # the output's sign, which requires a sign-preserving slope
            raise ValueError(f"leaky_slope must be >= 0, got {slope}")
        object.__setattr__(self, "leaky_slope", slope)

    @property
    def is_identity(self) -> bool:
        return not self.bias and self.activation == "none"

    def describe(self) -> str:
        parts = []
        if self.activation != "none":
            parts.append(self.activation
                         if self.activation != "leaky_relu"
                         else f"leaky_relu({self.leaky_slope:g})")
        if self.bias:
            parts.append("bias")
        return "+".join(parts) or "none"

    def key_fields(self) -> dict:
        """The epilogue's contribution to an autotuner plan key."""
        return {"bias": self.bias, "activation": self.activation,
                "leaky_slope": self.leaky_slope}

    def apply(self, y: torch.Tensor, bias: torch.Tensor | None = None
              ) -> torch.Tensor:
        """Reference application — the function the kernel fuses into
        its flush, computed in f32 and cast back to ``y.dtype``."""
        dt = y.dtype
        y = y.float()
        if self.bias:
            y = y + bias.float()
        if self.activation == "relu":
            y = torch.relu(y)
        elif self.activation == "leaky_relu":
            y = torch.where(y > 0, y, self.leaky_slope * y)
        elif self.activation == "tanh":
            y = torch.tanh(y)
        return y.to(dt)

    def grad_from_output(self, y: torch.Tensor) -> torch.Tensor:
        """The activation derivative recovered from the saved *output*
        ``y = act(z)``: relu and leaky by the sign of ``y`` (0 and the
        slope at ``y == 0``), tanh as ``1 - y²``; so the backward never
        needs the pre-activation tensor."""
        if self.activation == "relu":
            return (y > 0).to(y.dtype)
        if self.activation == "leaky_relu":
            return torch.where(y > 0, torch.ones_like(y),
                               torch.full_like(y, self.leaky_slope))
        if self.activation == "tanh":
            return 1.0 - torch.square(y)
        return torch.ones_like(y)


_IDENTITY_EPILOGUE = Epilogue()


def canonical_epilogue(epilogue: Epilogue | None,
                       bias: torch.Tensor | None, cout: int) -> Epilogue:
    """Validate the (epilogue, bias) pair of one dispatch; a bare
    ``bias=`` tensor with no epilogue means a plain fused bias add."""
    if epilogue is None:
        epilogue = Epilogue(bias=True) if bias is not None \
            else _IDENTITY_EPILOGUE
    if epilogue.bias and bias is None:
        raise ValueError("epilogue.bias=True but no bias= tensor passed")
    if not epilogue.bias and bias is not None:
        raise ValueError("bias= passed but epilogue.bias=False")
    if bias is not None and tuple(bias.shape) != (cout,):
        raise ValueError(f"bias must have shape (cout,)=({cout},), "
                         f"got {tuple(bias.shape)}")
    return epilogue


# ---------------------------------------------------------------------------
# μop compilation (frozen static artifacts, cached by geometry).
# ---------------------------------------------------------------------------

# Spatial ranks the tap tables describe (the planar and the volumetric
# kernel of the reference).
TABLE_RANKS = (2, 3)


def _frozen(a: np.ndarray) -> np.ndarray:
    a = np.ascontiguousarray(a)
    a.setflags(write=False)
    return a


@dataclasses.dataclass(frozen=True)
class CompiledUops:
    """Frozen static schedule artifacts for one tconv geometry.

    ``schedule`` serves every backend; the remaining fields are the
    kernel-ready "local μop buffer" contents for 2-D and 3-D geometries
    (``None`` for other ranks): flattened tap tables, per-phase
    weight-gather indices, and the uniform input padding plan.
    ``tap_dz`` is ``None`` for 2-D geometries.
    """

    schedule: PhaseSchedule
    n_taps: np.ndarray | None       # (P,)
    tap_dy: np.ndarray | None       # (P, T)
    tap_dx: np.ndarray | None       # (P, T)
    k_idx: np.ndarray | None        # (P, T) flattened kernel tap index
    valid: np.ndarray | None        # (P, T) tap-validity mask
    pad: tuple[tuple[int, int], ...] | None   # per-spatial-dim input padding
    q_sizes: tuple[int, ...] | None           # phase-plane grid (ceil(out/s))
    tap_dz: np.ndarray | None = None          # (P, T), 3-D only


@dataclasses.dataclass(frozen=True)
class ConvUops:
    """Frozen single-phase (SIMD-mode) tables for a plain strided conv.
    ``tap_dz`` is ``None`` for 2-D geometries."""

    out_sizes: tuple[int, ...]
    n_taps: np.ndarray              # (1,)
    tap_dy: np.ndarray              # (1, prod(kernel))
    tap_dx: np.ndarray              # (1, prod(kernel))
    pad: tuple[tuple[int, int], ...]
    tap_dz: np.ndarray | None = None    # (1, prod(kernel)), 3-D only


@functools.lru_cache(maxsize=512)
def compile_uops(in_spatial: tuple[int, ...], kernel: tuple[int, ...],
                 strides: tuple[int, ...], paddings: tuple[int, ...]
                 ) -> CompiledUops:
    """Run the static μop compilation once per layer geometry."""
    sched = make_schedule(in_spatial, kernel, strides, paddings)
    nd = sched.n_dims
    if nd not in TABLE_RANKS:
        return CompiledUops(schedule=sched, n_taps=None, tap_dy=None,
                            tap_dx=None, k_idx=None, valid=None, pad=None,
                            q_sizes=None)
    tables = sched.tap_tables()
    tap_off = tables["tap_dx"]          # (P, T, nd)
    tap_k = tables["tap_k"]             # (P, T, nd)
    n_taps = tables["n_taps"]           # (P,)
    t_max = tap_off.shape[1]

    # Row-major flattened kernel tap index over all spatial dims.
    k_idx = tap_k[..., 0]
    for d in range(1, nd):
        k_idx = k_idx * kernel[d] + tap_k[..., d]             # (P, T)
    valid = np.arange(t_max)[None, :] < n_taps[:, None]
    k_idx = np.where(valid, k_idx, 0)

    # Uniform padding, extended so every (offset + q) window slice stays
    # in bounds (the kernel walks phase planes with unit window stride).
    q_sizes = tuple(-(-o // s) for o, s in zip(sched.out_sizes, strides))
    upad = sched.uniform_padding()
    pad = []
    for d in range(nd):
        lo, hi = upad[d]
        need = int(tap_off[..., d].max()) + (q_sizes[d] - 1) + 1
        extent = in_spatial[d] + lo + hi
        pad.append((lo, hi + max(0, need - extent)))
    offs = {f"tap_d{ax}": _frozen(tap_off[..., d])
            for d, ax in enumerate("zyx"[-nd:])}
    return CompiledUops(
        schedule=sched,
        n_taps=_frozen(n_taps),
        k_idx=_frozen(k_idx.astype(np.int32)),
        valid=_frozen(valid),
        pad=tuple(pad),
        q_sizes=q_sizes,
        **offs,
    )


@functools.lru_cache(maxsize=512)
def compile_conv_uops(in_spatial: tuple[int, ...],
                      kernel: tuple[int, ...], strides: tuple[int, ...],
                      paddings: tuple[int, ...]) -> ConvUops:
    """Single-phase tap tables for a 2-D/3-D plain conv (the paper's SIMD
    mode: one microprogram whose taps are the full kernel)."""
    nd = len(in_spatial)
    if nd not in TABLE_RANKS:
        raise ValueError(f"conv μop tables exist only for 2-D/3-D "
                         f"geometries, got {nd}-D")
    out_sizes = tuple((i + 2 * p - k) // s + 1
                      for i, k, s, p in zip(in_spatial, kernel, strides,
                                            paddings))
    t_max = int(np.prod(kernel))
    taps = np.stack([np.asarray(u, np.int32)
                     for u in np.ndindex(*kernel)])       # (T, nd)
    pad = tuple(
        (p, max(0, (k - 1) + (q - 1) * s + 1 - (i + p)))
        for i, k, s, p, q in zip(in_spatial, kernel, strides, paddings,
                                 out_sizes))
    offs = {f"tap_d{ax}": _frozen(taps[None, :, d])
            for d, ax in enumerate("zyx"[-nd:])}
    return ConvUops(out_sizes=out_sizes,
                    n_taps=_frozen(np.asarray([t_max], np.int32)),
                    pad=pad, **offs)


def uop_cache_info() -> dict[str, int]:
    """Aggregate hit/miss counters over both μop caches."""
    a, b = compile_uops.cache_info(), compile_conv_uops.cache_info()
    return {"hits": a.hits + b.hits, "misses": a.misses + b.misses,
            "currsize": a.currsize + b.currsize}


def uop_cache_clear() -> None:
    compile_uops.cache_clear()
    compile_conv_uops.cache_clear()


# Observers (the train loop's end-of-run stats, ``obs.collect``) read
# the μop-cache efficiency through the obs registry.
_obs.register_collector("dataflow.uop_cache", uop_cache_info)


# ---------------------------------------------------------------------------
# Backend registry and dispatch.
# ---------------------------------------------------------------------------

# Spatial ranks the CUDA kernels implement: the planar and the
# volumetric kernel, as in the reference.
KERNEL_RANKS = (2, 3)


def require_kernel_rank(nd: int, what: str) -> None:
    """Raise unless the kernels implement ``nd`` spatial dims."""
    if nd not in KERNEL_RANKS:
        raise NotImplementedError(
            f"{what} is {nd}-D; the GANAX kernels of the PyTorch port "
            f"implement 2-D and 3-D layers only, as the reference's "
            f"Pallas kernels do; pin the 'polyphase' or 'zero-insert' "
            f"oracle for other ranks")


def pallas_kernel_supported(nd: int) -> bool:
    """Spatial ranks the GANAX kernel implements (:data:`KERNEL_RANKS`):
    planar (2-D) and volumetric (3-D) layers.  The reference's name,
    kept for parity; the port's kernel is CUDA C++
    (``kernels/csrc/ganax_conv{,3d}.cu``), not Pallas."""
    return nd in KERNEL_RANKS


def _any_rank(nd: int) -> bool:
    return True


@dataclasses.dataclass(frozen=True)
class Backend:
    """One executable dataflow: a tconv and a conv implementation, each
    ``fn(x, w, strides, paddings, epilogue, bias, route=None)``.
    ``supports`` gates dispatch on the spatial rank, as in the
    reference.  ``kernel`` marks the GANAX kernel's dataflow, which runs
    the kernel's ranks only and takes a kernel ``route``; the oracles
    run any rank and take none."""

    name: str
    tconv: Callable[..., torch.Tensor]
    conv: Callable[..., torch.Tensor]
    supports: Callable[[int], bool] = _any_rank
    kernel: bool = False


def _kernel(transposed: bool, plain: bool):
    def fn(x, w, strides, paddings, epilogue, bias, route=None):
        from repro_torch.kernels.ops import ganax_conv, ganax_conv_transpose
        op = ganax_conv_transpose if transposed else ganax_conv
        return op(x, w, strides, paddings, epilogue=epilogue, bias=bias,
                  plain=plain, route=route)
    return fn


def _oracle(op):
    def fn(x, w, strides, paddings, epilogue, bias, route=None):
        y = op(x, w, strides, paddings)
        return y if epilogue.is_identity else epilogue.apply(y, bias)
    return fn


def _tconv_polyphase(x, w, strides, paddings):
    nd = x.ndim - 2
    u = compile_uops(tuple(x.shape[1:1 + nd]), tuple(w.shape[:nd]),
                     tuple(strides), tuple(paddings))
    return tconv_ganax(x, w, strides, paddings, schedule=u.schedule)


def _conv_dense(x, w, strides, paddings):
    from repro_torch.kernels.ref import conv_ref
    return conv_ref(x, w, strides, paddings)


# the registry: name -> Backend, filled by register_backend
BACKENDS: dict[str, Backend] = {}


def register_backend(backend: Backend) -> None:
    """Add (or replace) a dataflow under ``backend.name``: dispatch,
    ``DataflowPolicy`` validation, :func:`available_backends` and the
    tuner's candidate enumerator see it from then on."""
    BACKENDS[backend.name] = backend


def available_backends() -> tuple[str, ...]:
    return tuple(sorted(BACKENDS))


def backend_supports(name: str, nd: int) -> bool:
    """True when registered backend ``name`` executes ``nd``-spatial ops
    (read by the tuner's candidate enumerator and plan validation)."""
    b = BACKENDS.get(name)
    return b is not None and b.supports(nd)


for _b in (
        Backend("ganax", _kernel(True, False), _kernel(False, False),
                pallas_kernel_supported, kernel=True),
        Backend("ganax-plain", _kernel(True, True), _kernel(False, True),
                pallas_kernel_supported, kernel=True),
        Backend("polyphase", _oracle(_tconv_polyphase),
                _oracle(_conv_dense)),
        Backend("zero-insert", _oracle(tconv_zero_insert),
                _oracle(_conv_dense))):
    register_backend(_b)
del _b


# ---------------------------------------------------------------------------
# Resolution: policy + geometry -> frozen execution record.
# ---------------------------------------------------------------------------

# The reference's kernel backends under the port's names (module
# docstring); every other registered name is the same in both.
REFERENCE_BACKENDS = {"pallas-tpu": "ganax", "pallas-interpret": "ganax-plain"}

def port_backend(name: str) -> str:
    """A concrete backend name of the reference (or the port) as the
    port's registered name; raises ``ValueError`` for unknown names."""
    mapped = REFERENCE_BACKENDS.get(name, name)
    if mapped not in BACKENDS:
        raise ValueError(f"unknown dataflow backend {name!r}; available: "
                         f"{available_backends()} (or the reference's "
                         f"{tuple(sorted(REFERENCE_BACKENDS))})")
    return mapped


@dataclasses.dataclass(frozen=True)
class DataflowPolicy:
    """How to pick an execution path for one layer: the reference's
    policy, with its backend names mapped to the port's (module
    docstring).

    ``backend``: ``None`` (the heuristic: the GANAX kernel for 2-D/3-D
    layers, ``polyphase`` otherwise), ``"pallas"`` (the kernel with a
    ``polyphase`` fallback for other ranks), a concrete name of either
    package (strict: a kernel backend on another rank raises), or
    ``"auto"`` (the autotuning planner's plan for the layer's full
    geometry, a miss falling back to the heuristic: see
    :func:`resolve_execution`; never measured at dispatch).
    ``interpret`` asks for the kernel's plain version (``True``, the
    ``ganax-plain`` oracle) or the CUDA kernel (``False``); with
    ``None`` / ``"pallas"`` it picks the variant, with a pinned name it
    must agree, and with ``"auto"`` it raises (the planner owns that
    choice).  The reference's
    ``differentiable`` field has no counterpart: every port backend is
    differentiable, and :class:`repro_torch.program.Program` takes the
    flag."""

    backend: str | None = None
    interpret: bool | None = None

    def __post_init__(self):
        if self.backend not in (None, "pallas", "auto"):
            port_backend(self.backend)

    def resolve(self, nd: int) -> str:
        """The concrete port backend for an ``nd``-spatial op.
        Geometry-free: ``"auto"`` reports the heuristic's choice here
        (the planner needs the full geometry, which
        :func:`resolve_execution` has)."""
        name = self.backend
        if name == "auto":
            if self.interpret is not None:
                raise ValueError(
                    "interpret cannot be combined with backend='auto': "
                    "the planner owns the kernel-variant choice")
            name = None
        if name is None or name == "pallas":
            # the heuristic and the kernel preference agree in the port:
            # the kernel for its ranks (the variant interpret asks for)
            name = "polyphase" if nd not in KERNEL_RANKS \
                else "ganax-plain" if self.interpret else "ganax"
        else:
            name = port_backend(name)
            if self.interpret is not None:
                expected = "ganax-plain" if self.interpret else "ganax"
                if name != expected:
                    raise ValueError(f"interpret={self.interpret} "
                                     f"contradicts backend={self.backend!r}")
        if BACKENDS[name].kernel:
            require_kernel_rank(nd, f"a layer pinned to {name!r}")
        elif not backend_supports(name, nd):
            raise ValueError(f"backend {name!r} does not support "
                             f"{nd}-D spatial inputs")
        return name


@dataclasses.dataclass(frozen=True)
class Resolution:
    """One layer's fully resolved execution: the concrete port backend,
    the reference's Pallas tile shapes (data only; a plan file of the
    reference carries them), the provenance (``"pinned"`` / ``"tuned"``
    / ``"heuristic"``), the tuned plan's time, the layer's layout on a
    device mesh (one of :data:`SHARDINGS`) and the CUDA kernel's
    ``route`` (a tuned :class:`KernelRoute` on ``ganax``; ``None``:
    ``kernel_route``'s pick per call).  The data form of dispatch — what
    :class:`repro_torch.program.ProgramSpec` freezes ahead of time."""

    backend: str
    blocks: tuple[int, ...] | None = None
    source: str = "heuristic"
    measured_us: float | None = None
    sharding: str = "data"
    route: KernelRoute | None = None


# Per-layer mesh layouts a resolution can freeze (see Resolution):
# "data" = batch split, weights replicated; "cout" = weights and bias
# also sharded on Cout over the "model" axis.
SHARDINGS = ("data", "cout")

# The footprint heuristic's default threshold: a layer whose weight
# tensor is at least this many bytes goes Cout-model-parallel on a
# mesh with model > 1.
COUT_SHARD_MIN_BYTES = 16 * 1024 * 1024


def choose_layer_sharding(kernel: Sequence[int], cin: int, cout: int,
                          mesh_model: int, *,
                          min_bytes: int | None = None,
                          itemsize: int = 4) -> str:
    """The footprint heuristic picking one of :data:`SHARDINGS`:
    ``"cout"`` only when the model axis is real (> 1), Cout divides it
    and the weights' ``prod(kernel)·cin·cout·itemsize`` bytes reach
    ``min_bytes`` (default :data:`COUT_SHARD_MIN_BYTES`); else
    ``"data"``.  ``itemsize`` is the storage dtype's (a bf16 program's
    weights are half the f32 footprint)."""
    if mesh_model <= 1 or cout % mesh_model != 0:
        return "data"
    threshold = COUT_SHARD_MIN_BYTES if min_bytes is None \
        else int(min_bytes)
    weight_bytes = int(np.prod(tuple(kernel))) * int(cin) * int(cout) \
        * int(itemsize)
    return "cout" if weight_bytes >= threshold else "data"


def resolve_blocks(blocks, q_lead, cin: int, cout: int
                   ) -> tuple[int, ...]:
    """Validate the reference's Pallas tile shapes — the
    (block_qy, block_cin, block_cout) triple for 2-D layers or the
    (block_qz, block_qy, block_cin, block_cout) quadruple for 3-D — by
    its rule: each must divide its extent.  ``q_lead`` is ``qy`` (2-D)
    or ``(qz, qy)`` (3-D).  The reference's program and plan files
    carry such blocks; the CUDA kernels read none of them (their tiles
    are a :class:`KernelRoute`'s)."""
    lead = (int(q_lead),) if isinstance(q_lead, int) \
        else tuple(int(v) for v in q_lead)
    names = ("block_qz", "block_qy")[-len(lead):] + \
        ("block_cin", "block_cout")
    arity = "triple" if len(names) == 3 else "quadruple"
    try:
        vals = tuple(int(v) for v in blocks)
        if len(vals) != len(names):
            raise ValueError
    except (TypeError, ValueError):
        raise ValueError(
            f"blocks must be a ({', '.join(names)}) {arity}, "
            f"got {blocks!r}") from None
    planes = {"block_qz": "depth qz", "block_qy": "height qy"}
    for name, v, extent in zip(names, vals, lead + (cin, cout)):
        if v <= 0 or extent % v != 0:
            what = (f"the phase-plane {planes[name]}={extent}"
                    if name in planes
                    else f"{name.split('_')[1]}={extent}")
            raise ValueError(f"{name}={v} must divide {what}")
    return vals


def blocks_valid(kind: str, in_spatial: Sequence[int],
                 kernel: Sequence[int], strides: Sequence[int],
                 paddings: Sequence[int], cin: int, cout: int,
                 blocks: Sequence[int]) -> bool:
    """True when the reference's tile shapes ``blocks`` divide this
    geometry's extents, by the reference's rule — a stale program entry
    must degrade, never raise.  ``kind`` is ``"tconv"`` or ``"conv"``."""
    in_spatial, kernel = tuple(in_spatial), tuple(kernel)
    strides, paddings = tuple(strides), tuple(paddings)
    if len(in_spatial) not in KERNEL_RANKS:
        return False
    if kind == "conv":
        q_lead = compile_conv_uops(in_spatial, kernel, strides,
                                   paddings).out_sizes[:-1]
    else:
        q_lead = compile_uops(in_spatial, kernel, strides,
                              paddings).q_sizes[:-1]
    try:
        resolve_blocks(tuple(blocks), q_lead, int(cin), int(cout))
    except ValueError:
        return False
    return True


def kernel_call_geometry(kind: str, in_spatial: Sequence[int],
                         kernel: Sequence[int], strides: Sequence[int],
                         paddings: Sequence[int]
                         ) -> tuple[int, int, tuple[int, ...]]:
    """``(P, T, Q)`` of the kernel call of one 2-D/3-D layer: its phases,
    taps a phase (the gathered weights' T) and phase grid; a call of B
    samples has B·∏Q rows a phase and T·Cin products a row."""
    in_spatial, kernel = tuple(in_spatial), tuple(kernel)
    strides, paddings = tuple(strides), tuple(paddings)
    if kind == "tconv":
        u = compile_uops(in_spatial, kernel, strides, paddings)
        p, t = u.k_idx.shape
        return int(p), int(t), u.q_sizes
    u = compile_conv_uops(in_spatial, kernel, strides, paddings)
    return 1, int(np.prod(kernel)), u.out_sizes


def valid_layer_route(route: KernelRoute, kind, in_spatial, kernel,
                      strides, paddings, cin, cout,
                      dtype) -> KernelRoute | None:
    """``route`` completed for this layer, or None where the kernels do
    not take it (a stale plan or program entry degrades, never
    raises)."""
    if len(tuple(in_spatial)) not in KERNEL_RANKS:
        return None
    _, t, _ = kernel_call_geometry(kind, in_spatial, kernel, strides,
                                   paddings)
    try:
        return check_route(route, int(cin), int(cout), t * int(cin),
                           storage_itemsize(dtype))
    except ValueError:
        return None


def resolve_execution(policy: DataflowPolicy, kind: str,
                      in_spatial: Sequence[int], kernel: Sequence[int],
                      strides: Sequence[int], paddings: Sequence[int],
                      cin: int, cout: int, *, batch: int = 1,
                      dtype="float32", epilogue: Epilogue | None = None,
                      planner=None, measure: bool = False,
                      mesh_model: int = 1,
                      cout_shard_min_bytes: int | None = None,
                      platform: str | None = None) -> Resolution:
    """Resolve one layer's execution path **as data** — the one
    resolution routine behind the per-call ``backend="auto"`` dispatch
    and the ahead-of-time :class:`repro_torch.program.ProgramSpec`.

    For a policy other than ``auto`` this is ``policy.resolve`` with its
    provenance (``"heuristic"`` for the default policy, ``"pinned"``
    otherwise).  ``backend="auto"`` consults the autotuning planner
    (``planner`` or :func:`repro_torch.tune.get_planner`'s) with the
    layer's full geometry, ``batch``, storage ``dtype``, fused
    ``epilogue`` and ``platform`` (default: the card's when there is
    one): a hit gives the plan's backend, its kernel route and time,
    ``source="tuned"``; a plan that no longer fits (an unknown backend
    or rank, a route the kernels do not take, blocks that do not divide)
    degrades to the heuristic or drops the stale part, never raises.
    ``measure=True`` tunes a miss first (ahead-of-time builders only:
    dispatch never measures).  For ``mesh_model > 1`` the layer's mesh
    layout is :func:`choose_layer_sharding`'s (``cout_shard_min_bytes``
    overrides its threshold), and a ``"cout"`` layer, whose kernel runs
    on ``cout / mesh_model`` channels a rank, drops tuned blocks or a
    tuned route that do not fit that local shard (reason
    ``shard_blocks``).  Counts ``dataflow.resolve``,
    ``dataflow.resolve.<source>`` and ``dataflow.resolve.<reason>``
    (for ``auto``: ``plan_hit``, ``plan_miss``, ``plan_measured``,
    ``stale_plan``, ``stale_blocks``, ``stale_route``; on a mesh:
    ``shard_blocks``)."""
    with _obs.trace("dataflow.resolve", kind=kind) as sp:
        res, reasons = _resolve_execution(
            policy, kind, in_spatial, kernel, strides, paddings, cin,
            cout, batch=batch, dtype=dtype, epilogue=epilogue,
            planner=planner, measure=measure, platform=platform)
        sharding = choose_layer_sharding(
            kernel, cin, cout, mesh_model, min_bytes=cout_shard_min_bytes,
            itemsize=storage_itemsize(dtype))
        res = dataclasses.replace(res, sharding=sharding)
        if sharding == "cout":
            local = cout // mesh_model
            blocks, route = res.blocks, res.route
            if blocks is not None and not blocks_valid(
                    kind, in_spatial, kernel, strides, paddings, cin,
                    local, blocks):
                blocks = None
            if route is not None:
                route = valid_layer_route(route, kind, in_spatial, kernel,
                                          strides, paddings, cin, local,
                                          dtype)
            if (blocks, route) != (res.blocks, res.route):
                res = dataclasses.replace(res, blocks=blocks, route=route)
                reasons.append("shard_blocks")
        sp.set(backend=res.backend, source=res.source)
    _obs.counter("dataflow.resolve").inc()
    _obs.counter(f"dataflow.resolve.{res.source}").inc()
    for reason in reasons:
        _obs.counter(f"dataflow.resolve.{reason}").inc()
    return res


def _resolve_execution(policy, kind, in_spatial, kernel, strides,
                       paddings, cin, cout, *, batch, dtype, epilogue,
                       planner, measure, platform
                       ) -> tuple[Resolution, list[str]]:
    """Uninstrumented :func:`resolve_execution`; the second value lists
    the plan-cache outcome and degradations behind the provenance."""
    nd = len(in_spatial)
    if policy.backend != "auto":
        source = "heuristic" if policy.backend is None \
            and policy.interpret is None else "pinned"
        return Resolution(policy.resolve(nd), None, source), []
    policy.resolve(nd)      # validates the interpret combination
    from repro_torch.tune import get_planner
    from repro_torch.tune.planner import PlanKey
    if planner is None:
        planner = get_planner()
    ep = epilogue or _IDENTITY_EPILOGUE
    key = PlanKey(kind=kind, batch=int(batch),
                  in_spatial=tuple(int(d) for d in in_spatial),
                  kernel=tuple(int(d) for d in kernel),
                  strides=tuple(int(v) for v in strides),
                  paddings=tuple(int(v) for v in paddings),
                  cin=int(cin), cout=int(cout),
                  dtype=canonical_dtype(dtype),
                  platform=platform or default_platform(),
                  **ep.key_fields())
    # the outcome is read from the counters, not from extra planner calls
    if measure:
        measured_before = planner.measurements
        plan = planner.plan(key, measure=True)
        reasons = ["plan_measured" if planner.measurements
                   > measured_before else "plan_hit"]
    else:
        plan = planner.lookup(key)
        reasons = ["plan_hit" if plan is not None else "plan_miss"]
    if plan is not None and backend_supports(plan.backend, nd):
        kernel_backend = BACKENDS[plan.backend].kernel
        blocks = plan.blocks if kernel_backend else None
        if blocks is not None and not blocks_valid(
                kind, key.in_spatial, key.kernel, key.strides,
                key.paddings, cin, cout, blocks):
            blocks = None
            reasons.append("stale_blocks")
        route = plan.route if plan.backend == "ganax" else None
        if route is not None:
            route = valid_layer_route(route, kind, key.in_spatial,
                                      key.kernel, key.strides, key.paddings,
                                      cin, cout, key.dtype)
            if route is None:
                reasons.append("stale_route")
        source = "tuned" if plan.source == "measured" else "heuristic"
        return Resolution(plan.backend, blocks, source, plan.measured_us,
                          route=route), reasons
    if plan is not None:
        reasons.append("stale_plan")    # unknown backend / bad rank
    heuristic = dataclasses.replace(policy, backend=None).resolve(nd)
    return Resolution(heuristic, None, "heuristic"), reasons


# ---------------------------------------------------------------------------
# The gradient of the kernel backends (the reference's custom VJPs).
# ---------------------------------------------------------------------------

class SecondOrderNotImplemented(NotImplementedError):
    """Raised when the backward of a kernel-backend op is differentiated."""


_SECOND_ORDER_MSG = (
    "second-order autodiff through the unified GANAX (t)conv op is not "
    "implemented on the kernel backends: their torch.autograd.Function "
    "defines a single backward pass, so grad-of-grad (hessian, etc.) "
    "would need derivatives of the CUDA kernel itself. Differentiate "
    "through a pure-PyTorch backend instead: backend='polyphase' or "
    "'zero-insert' keep PyTorch's native autograd, which supports "
    "arbitrary-order derivatives.")


class _FirstOrderOnly(torch.autograd.Function):
    """Identity on ``t`` whose own backward raises: it marks what a
    kernel backward returns under ``create_graph=True``.  The
    ``anchors`` (tensors that require grad) only make the result part
    of the graph."""

    @staticmethod
    def forward(ctx, t, *anchors):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, *grads):
        raise SecondOrderNotImplemented(_SECOND_ORDER_MSG)


def _once_differentiable(backward):
    """``torch.autograd.function.once_differentiable`` with the
    reference's error: the backward records no graph, and where one was
    asked for (``create_graph=True``) each of its results raises
    :class:`SecondOrderNotImplemented` when it is differentiated."""
    @functools.wraps(backward)
    def wrapper(ctx, *grads):
        with torch.no_grad():
            out = backward(ctx, *grads)
        if not torch.is_grad_enabled():
            return out
        anchors = [t for t in (*grads, *ctx.saved_tensors)
                   if t is not None and t.requires_grad]
        if not anchors:
            return out
        return tuple(t if t is None else _FirstOrderOnly.apply(t, *anchors)
                     for t in out)
    return wrapper


def _f_pad(pad) -> tuple[int, ...]:
    """The ``F.pad`` argument padding the spatial dims of a
    channels-last tensor by ``pad`` ((lo, hi) per dim)."""
    flat = [0, 0]                   # channels
    for lo, hi in reversed(tuple(pad)):
        flat += [lo, hi]
    return tuple(flat)


def _swap_io(w: torch.Tensor) -> torch.Tensor:
    """(K..., Cin, Cout) → (K..., Cout, Cin): the adjoint's kernel."""
    return w.transpose(-1, -2)


def _tap_products(fixed: torch.Tensor, padded: torch.Tensor, kernel,
                  strides, extent, fixed_left: bool) -> torch.Tensor:
    """``(K..., A, B)``: per kernel tap ``u``, one product of the (N·S,
    C) rows of ``padded``'s strided window at ``u`` with ``fixed``,
    ``fixed @ window`` or ``window.T @ fixed``, its sums in f32.  A
    bf16/f16 product is exact in f32: on the card cuBLAS sums the
    storage-dtype operands in f32 and rounds each tap's result once
    (:func:`~repro_torch.device.require_f32_accumulation` refuses the
    reduced-precision reductions), on the CPU the operands are widened
    to f32 first and the result stays f32 until the caller's one
    cast."""
    require_f32_accumulation(fixed)
    if not fixed.is_cuda:
        fixed, padded = fixed.float(), padded.float()
    nd = len(kernel)
    rows = []
    for u in np.ndindex(*kernel):
        window = padded[(slice(None),) + tuple(
            slice(u[d], u[d] + strides[d] * (extent[d] - 1) + 1, strides[d])
            for d in range(nd))]
        window = window.reshape(-1, window.shape[-1])
        rows.append(fixed @ window if fixed_left else window.T @ fixed)
    return torch.stack(rows).reshape(tuple(kernel) + rows[0].shape)


def _tconv_wgrad(x, g, kernel, strides, paddings):
    """dL/dw for ``y = tconv(x, w)``:  dw[u,ci,co] = Σ_{n,i} x[n,i,ci] ·
    g[n, s·i + u - p, co], one dense product per tap (no inserted
    zeros: every product is a consequential MAC)."""
    gp = F.pad(g, _f_pad((p, p) for p in paddings))
    xf = x.reshape(-1, x.shape[-1])
    return _tap_products(xf.T, gp, kernel, strides, x.shape[1:-1], True)


def _conv_wgrad(x, g, kernel, strides, paddings):
    """dL/dw for ``y = conv(x, w)``:  dw[t,ci,co] = Σ_{n,q}
    x[n, s·q + t - p, ci] · g[n,q,co]."""
    q_sp, in_sp = g.shape[1:-1], x.shape[1:-1]
    pad = [(p, max(0, s * (q - 1) + k - 1 - p - (i - 1)))
           for i, k, s, p, q in zip(in_sp, kernel, strides, paddings, q_sp)]
    xp = F.pad(x, _f_pad(pad))
    gf = g.reshape(-1, g.shape[-1])
    return _tap_products(gf, xp, kernel, strides, q_sp, False)


def _conv_dx(backend: Backend, strides, paddings, x, w, g):
    """Input cotangent of ``y = conv(x, w)``: a transposed conv through
    the same backend (the multi-phase MIMD path), but the *uncropped*
    one: conv with padding p reads input positions [-p, s·(Q-1)+K-1-p],
    so the adjoint is tconv with padding 0 shifted by p, cropped to
    [0, I) with zero cotangent past the stride tail."""
    nd = x.ndim - 2
    dx_full = backend.tconv(g, _swap_io(w), strides, (0,) * nd,
                            _IDENTITY_EPILOGUE, None)
    crop, pad = [slice(None)], []
    for d in range(nd):
        i_d = x.shape[1 + d]
        crop.append(slice(paddings[d], paddings[d] + i_d))
        pad.append((0, max(0, i_d - (dx_full.shape[1 + d] - paddings[d]))))
    return F.pad(dx_full[tuple(crop)], _f_pad(pad))


def _epilogue_cotangent(epilogue: Epilogue, y, g):
    return g if epilogue.activation == "none" \
        else g * epilogue.grad_from_output(y)


def _bias_grad(g_pre, bias):
    # f32 accumulation over every non-channel axis
    return g_pre.sum(dim=tuple(range(g_pre.ndim - 1)),
                     dtype=torch.float32).to(bias.dtype)


class _KernelOp(torch.autograd.Function):
    """``y = act(op(x, w) + b)`` on a kernel backend, differentiable to
    first order: the port of ``_tconv_ep_diff`` / ``_conv_ep_diff`` (and,
    with the identity epilogue, ``_tconv_diff`` / ``_conv_diff``).

    The forward runs the kernel (on ``route``, a tuned one, or
    ``kernel_route``'s) with its fused epilogue and saves ``(x, w, b,
    y)``.  The backward folds the activation derivative, recovered from
    ``y``, into the cotangent once, in its dtype (the storage dtype of
    ``y``); then ``dx`` re-enters the same backend by adjoint duality at
    that dtype on ``kernel_route``'s route (a tuned route describes the
    forward's geometry, not the adjoint's, as the reference's tuned
    blocks do), ``dw`` is the per-tap contraction with f32 sums cast
    once to ``w``'s dtype and ``db`` the f32 reduction, each only where
    ``needs_input_grad`` asks for it."""

    @staticmethod
    def forward(ctx, x, w, bias, backend, transposed, strides, paddings,
                epilogue, route):
        fn = backend.tconv if transposed else backend.conv
        with _obs.annotate("ganax.forward"):
            y = fn(x, w, strides, paddings, epilogue, bias, route)
        ctx.save_for_backward(x, w, bias, y)
        ctx.op = (backend, transposed, strides, paddings, epilogue)
        return y

    @staticmethod
    @_once_differentiable
    def backward(ctx, g):
        x, w, bias, y = ctx.saved_tensors
        backend, transposed, strides, paddings, epilogue = ctx.op
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        g_pre = _epilogue_cotangent(epilogue, y, g)
        dx = dw = db = None
        if need_x:
            with _obs.annotate("ganax.dx"):
                # tconv(·, w) is the adjoint of conv(·, swap(w))
                dx = (backend.conv(g_pre, _swap_io(w), strides, paddings,
                                   _IDENTITY_EPILOGUE, None)
                      if transposed else
                      _conv_dx(backend, strides, paddings, x, w, g_pre))
            dx = dx.to(x.dtype)
        if need_w:
            with _obs.annotate("ganax.dw"):
                wgrad = _tconv_wgrad if transposed else _conv_wgrad
                dw = wgrad(x, g_pre, tuple(w.shape[:-2]), strides,
                           paddings).to(w.dtype)
        if need_b and bias is not None:
            db = _bias_grad(g_pre, bias)
        return dx, dw, db, None, None, None, None, None, None


def _dispatch(transposed: bool, x, w, strides, paddings, backend, bias,
              epilogue, route) -> torch.Tensor:
    name = backend or "ganax"
    epilogue = canonical_epilogue(epilogue, bias, int(w.shape[-1]))
    strides, paddings = tuple(strides), tuple(paddings)
    if name == "auto":
        if route is not None:
            raise ValueError("route= pins the kernel's route: pin "
                             "backend='ganax' with it, not 'auto'")
        nd = x.ndim - 2
        res = resolve_execution(
            DataflowPolicy(backend="auto"),
            "tconv" if transposed else "conv", tuple(x.shape[1:1 + nd]),
            tuple(w.shape[:nd]), strides, paddings, int(w.shape[-2]),
            int(w.shape[-1]), batch=int(x.shape[0]), dtype=x.dtype,
            epilogue=epilogue, platform=platform_of(x.device))
        name, route = res.backend, res.route
    if name not in BACKENDS:
        raise ValueError(f"unknown dataflow backend {name!r}; "
                         f"available: {tuple(sorted(BACKENDS))} or 'auto'")
    b = BACKENDS[name]
    if b.kernel:
        require_kernel_rank(x.ndim - 2, "the input")
    elif not b.supports(x.ndim - 2):
        raise ValueError(f"backend {name!r} does not support "
                         f"{x.ndim - 2}-D spatial inputs")
    elif route is not None:
        raise ValueError(f"route= names a GANAX kernel route; backend "
                         f"{name!r} has none")
    if b.kernel and torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, w, bias)):
        return _KernelOp.apply(x, w, bias, b, transposed, strides,
                               paddings, epilogue, route)
    fn = b.tconv if transposed else b.conv
    return fn(x, w, strides, paddings, epilogue, bias, route)


def tconv(x: torch.Tensor, w: torch.Tensor, strides: Sequence[int],
          paddings: Sequence[int], *, backend: str | None = None,
          bias: torch.Tensor | None = None,
          epilogue: Epilogue | None = None,
          route: KernelRoute | None = None) -> torch.Tensor:
    """Transposed convolution through the unified GANAX dispatch.

    x: (N, *spatial, Cin) channels-last; w: (K..., Cin, Cout).
    ``backend`` pins a registered backend (default ``"ganax"``, the
    kernel) or is ``"auto"``: the planner's plan for this call's
    geometry, batch, dtype, epilogue and device (lookup only; a miss
    takes the heuristic).  ``route`` pins the CUDA kernel's route on a
    kernel backend (``ValueError`` where the kernels do not take it).
    ``epilogue`` fuses a bias add (``bias``: a (Cout,) vector,
    required iff ``epilogue.bias``) and an activation into the op; a bare
    ``bias=`` with no epilogue means a plain fused bias add.

    Differentiable to first order on every backend.  On a kernel
    backend, with grad mode on and an input that requires grad, the op
    runs through a ``torch.autograd.Function`` whose backward launches
    the same kernel for ``dx``; otherwise (serving) it calls the kernel
    directly and records nothing."""
    return _dispatch(True, x, w, strides, paddings, backend, bias,
                     epilogue, route)


def conv(x: torch.Tensor, w: torch.Tensor, strides: Sequence[int],
         paddings: Sequence[int], *, backend: str | None = None,
         bias: torch.Tensor | None = None,
         epilogue: Epilogue | None = None,
         route: KernelRoute | None = None) -> torch.Tensor:
    """Plain (strided) convolution through the same dispatch — the
    paper's SIMD mode, the single-phase case of the same kernel.
    Arguments as in :func:`tconv`."""
    return _dispatch(False, x, w, strides, paddings, backend, bias,
                     epilogue, route)
