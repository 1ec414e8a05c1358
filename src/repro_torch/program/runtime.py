"""The executable form of a :class:`~repro_torch.program.ProgramSpec`.

The port of ``repro.program.runtime``.  A :class:`Program` binds a
frozen spec to a device: ``program.apply(params, x)`` runs the network
of :mod:`repro_torch.models.gan` that replays the spec's records
(:class:`~repro_torch.models.gan.Generator` or
:class:`~repro_torch.models.gan.Discriminator`, built once per bound
parameter set) — no per-call config → policy → backend threading on
the hot path, and no second loop over the layers.

The reference's ``traces`` count, its ``program.traces`` /
``program.retraces`` counters and the ``traced`` attribute of its
``program.apply`` span have no counterpart: PyTorch runs eagerly, so
nothing is compiled per input shape.

A spec with a frozen ``mesh`` runs **sharded** when this process is a
rank of a ``torch.distributed`` process group of exactly ``data·model``
ranks: torch runs one process per rank where JAX drives every device
from one controller, so every rank builds the same programs and calls
them in the same order with the same **global** batch.  Each rank
computes on its ``data`` rows (rows ``[d·B/D, (d+1)·B/D)``), with the
parameters replicated and each ``"cout"`` layer on its Cout slice
``[m·C/M, (m+1)·C/M)`` followed by a tiled gather, and every rank
returns the global output (:mod:`repro_torch.sharding.collectives` has
the gradient rules, so ``forward`` differentiates like the unsharded
program).  Otherwise the program degrades to one device with the
reference's warning and the ``program.mesh_degraded`` counter.
"""

from __future__ import annotations

import logging
import warnings

import torch
import torch.distributed as dist
from torch import nn

from repro_torch import obs as _obs
from repro_torch.core.dataflow import DataflowPolicy
from repro_torch.device import platform_of, resolve_device
from repro_torch.launch.mesh import make_local_mesh, world_size
from repro_torch.models.gan import Discriminator, GanConfig, Generator
from repro_torch.program.spec import _UNSET as _SPEC_UNSET
from repro_torch.program.spec import ProgramSpec
from repro_torch.sharding.collectives import MeshAxes

__all__ = ["Program", "build_bucket_programs", "load_or_build"]

log = logging.getLogger(__name__)

class Program:
    """One GAN network as an ahead-of-time resolved executable on
    ``device`` (default: the card).

    ``apply(params, x)`` is serving's entry point: with
    ``differentiable=False`` it runs under ``torch.inference_mode()``,
    and with obs tracing on it records a ``program.apply`` span (the
    layers' ``program.layer`` spans nest inside).  ``forward(params,
    x)`` is the same computation without the span, to embed in a
    caller's autograd graph (a train step).  ``params`` is the
    reference's dict of tensors by name; the network bound to it shares
    the storage of tensors already on ``device`` (others are copied once
    per binding) and is rebuilt only when a different dict of tensors
    is passed.

    A spec with a ``mesh`` runs sharded under a process group of
    ``data·model`` ranks (``self.mesh``: the
    :class:`~torch.distributed.device_mesh.DeviceMesh`, on ``device``'s
    type; every rank must build the program, since the mesh's groups
    are made collectively) and counts ``program.sharded``; it degrades
    to one device with a warning and ``program.mesh_degraded``
    otherwise (a ``1x1`` mesh without a process group simply runs on
    the one device).  A sharded ``forward`` / ``apply`` refuses a batch
    that does not divide over ``data``.
    """

    def __init__(self, spec: ProgramSpec, *,
                 device: str | torch.device = "cuda",
                 differentiable: bool = True):
        self.spec = spec
        self.device = resolve_device(device)
        self.differentiable = bool(differentiable)
        self.mesh = None
        self._axes: MeshAxes | None = None
        if spec.mesh is not None:
            need = spec.mesh[0] * spec.mesh[1]
            have = world_size()
            if dist.is_available() and dist.is_initialized() \
                    and need == have:
                self.mesh = make_local_mesh(*spec.mesh,
                                            device_type=self.device.type)
                self._axes = MeshAxes.of(self.mesh)
                _obs.counter("program.sharded").inc()
            elif need > 1:
                warnings.warn(
                    f"program {spec.model}/{spec.role} wants a "
                    f"{spec.mesh[0]}x{spec.mesh[1]} mesh ({need} ranks) "
                    f"but the process group has {have}; degrading to "
                    f"single-device execution", RuntimeWarning,
                    stacklevel=2)
                _obs.counter("program.mesh_degraded").inc()
        self._bound: tuple[dict, nn.Module] | None = None
        self._dequantized: dict[str, torch.Tensor] | None = None

    @classmethod
    def build(cls, cfg: GanConfig, batch: int, role: str = "generator", *,
              policy: DataflowPolicy | None = None, planner=None,
              measure: bool = False, dtype: str | None = None,
              device: str | torch.device = "cuda",
              differentiable: bool = True, mesh=_SPEC_UNSET,
              cout_shard_min_bytes: int | None = None) -> "Program":
        """:meth:`ProgramSpec.build` + wrap — the one-call form; an
        ``auto`` policy's plans are those of ``device``'s platform
        (``measure=True`` tunes the misses there)."""
        device = resolve_device(device)
        spec = ProgramSpec.build(cfg, batch, role, policy=policy,
                                 planner=planner, measure=measure,
                                 dtype=dtype, mesh=mesh,
                                 cout_shard_min_bytes=cout_shard_min_bytes,
                                 platform=platform_of(device))
        return cls(spec, device=device, differentiable=differentiable)

    # -- embedded (quantized) parameters ------------------------------------
    @property
    def quantized(self) -> bool:
        """True when the spec carries an embedded int8 weight payload."""
        return self.spec.quantized_params is not None

    @property
    def params(self) -> dict[str, torch.Tensor] | None:
        """The spec's embedded int8 payload dequantized into the storage
        dtype on the program's device (weights → ``spec.dtype``, biases
        → f32), once per Program and bit-identical across loads — the
        dict callers hand straight to :meth:`apply` / ``GanServer``.
        ``None`` for ordinary programs, whose params live with the
        caller."""
        if self.spec.quantized_params is None:
            return None
        if self._dequantized is None:
            from repro_torch.quant.weights import dequantize_params
            self._dequantized = dequantize_params(
                self.spec.quantized_params, self.spec.dtype, self.device)
        return self._dequantized

    # -- device layout ------------------------------------------------------
    @property
    def device_count(self) -> int:
        """The ranks this program executes on (1 when unsharded or
        degraded)."""
        return 1 if self.mesh is None else self.spec.mesh[0] * \
            self.spec.mesh[1]

    @property
    def axes(self) -> MeshAxes | None:
        """This rank's place on the active mesh and its axes' groups
        (None when unsharded or degraded)."""
        return self._axes

    @property
    def mesh_str(self) -> str:
        """``"2x1"``-style label of the *active* mesh (``"1"`` when
        unsharded or degraded) — the span-attr form."""
        if self.mesh is None:
            return "1"
        return f"{self.spec.mesh[0]}x{self.spec.mesh[1]}"

    # -- execution ----------------------------------------------------------
    def network(self, params: dict[str, torch.Tensor]) -> nn.Module:
        """The network replaying this spec with ``params`` bound (built
        once per dict of tensors)."""
        bound = self._bound
        if bound is not None and bound[0].keys() == params.keys() and all(
                params[k] is v for k, v in bound[0].items()):
            return bound[1]
        spec = self.spec
        cfg = GanConfig(spec.model, channel_scale=spec.channel_scale,
                        **({} if spec.z_dim is None
                           else {"z_dim": spec.z_dim}))
        cls = Generator if spec.role == "generator" else Discriminator
        net = cls(cfg, params, self.device, spec=spec, mesh=self._axes)
        if not self.differentiable:
            net.requires_grad_(False)
        self._bound = (dict(params), net)
        return net

    def forward(self, params, x: torch.Tensor) -> torch.Tensor:
        """The computation, recorded by autograd as the caller's grad
        mode says."""
        return self.network(params)(x)

    def apply(self, params, x: torch.Tensor) -> torch.Tensor:
        """Serving's entry point: :meth:`forward`, under
        ``torch.inference_mode()`` for a non-differentiable program.
        The disabled-tracing path is one flag check away from the
        network call; with tracing on, each call gets a
        ``program.apply`` span."""
        net = self.network(params)
        if not _obs.is_enabled():
            return self._run(net, x)
        with _obs.trace("program.apply", model=self.spec.model,
                        role=self.spec.role, batch=int(x.shape[0]),
                        devices=self.device_count, mesh=self.mesh_str):
            return self._run(net, x)

    def _run(self, net: nn.Module, x: torch.Tensor) -> torch.Tensor:
        if self.differentiable:
            return net(x)
        with torch.inference_mode():
            return net(x)

    # -- passthroughs -------------------------------------------------------
    def describe(self) -> str:
        return self.spec.describe()

    def save(self, path) -> None:
        self.spec.save(path)

    def __repr__(self) -> str:
        quant = ", quant=int8" if self.quantized else ""
        return (f"Program({self.spec.model}/{self.spec.role}, "
                f"{len(self.spec.layers)} layers, "
                f"{self.spec.summary()}, dtype={self.spec.dtype}"
                f"{quant}, device={self.device})")


def build_bucket_programs(spec: ProgramSpec, buckets, *,
                          device: str | torch.device = "cuda",
                          differentiable: bool = False
                          ) -> dict[int, Program]:
    """The continuous-batching engine's bucket set from **one** frozen
    spec: each bucket maps to the same :class:`Program`, since nothing
    is compiled per batch size (the reference jits one executable per
    bucket).

    ``buckets`` is deduplicated and sorted ascending; every bucket must
    be a positive int."""
    sizes = sorted({int(b) for b in buckets})
    if not sizes or sizes[0] <= 0:
        raise ValueError(f"buckets must be positive ints, got "
                         f"{tuple(buckets)}")
    program = Program(spec, device=resolve_device(device),
                      differentiable=differentiable)
    return dict.fromkeys(sizes, program)


def load_or_build(path, cfg: GanConfig, batch: int, role: str = "generator",
                  *, policy: DataflowPolicy | None = None, planner=None,
                  measure: bool = False, dtype: str | None = None,
                  device: str | torch.device = "cuda",
                  differentiable: bool = True,
                  mesh=_SPEC_UNSET) -> tuple[Program, bool]:
    """Load an exported program file, falling back to fresh resolution.

    Returns ``(program, loaded)``.  ``loaded=False`` means the file was
    missing, corrupt, version-skewed, named unknown backends or stale
    blocks, or froze a different workload than ``cfg`` builds now
    (topology / channel-scale / epilogue / storage-precision drift) —
    in every such case the program is rebuilt from ``cfg`` exactly as
    :meth:`Program.build` would, so a bad file degrades the
    optimization, never the service.  The requested ``dtype`` defaults
    to ``cfg.dtype``, so a file at another storage precision rebuilds.
    The mesh is not part of the workload identity; ``mesh`` only shapes
    the fallback rebuild, and ``measure=True`` (tune an ``auto``
    policy's plan misses) only the fallback's."""
    device = resolve_device(device)
    build = dict(policy=policy, planner=planner, dtype=dtype, mesh=mesh,
                 platform=platform_of(device))
    fresh = ProgramSpec.build(cfg, batch, role, measure=False, **build)
    try:
        spec = ProgramSpec.load(path)
        if spec.geometry_signature() != fresh.geometry_signature():
            raise ValueError("program file froze a different workload "
                             "than this config builds")
    except Exception as e:   # corrupt/stale file → fresh resolution
        log.warning("ignoring program file %s (%s: %s); rebuilding from "
                    "config", path, type(e).__name__, e)
        if measure:
            fresh = ProgramSpec.build(cfg, batch, role, measure=True,
                                      **build)
        return Program(fresh, device=device,
                       differentiable=differentiable), False
    return Program(spec, device=device, differentiable=differentiable), True
