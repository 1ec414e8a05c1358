"""Declarative, ahead-of-time-resolved GAN execution specs.

The port of ``repro.program.spec``.  :meth:`ProgramSpec.build` walks a
:class:`~repro_torch.models.gan.GanConfig`'s layers **once** and
freezes a tuple of :class:`LayerExec` records — op kind, geometry,
fused epilogue, the resolved concrete backend (and the reference's
Pallas block shapes, carried as data), the resolution's provenance and
the layer's mesh layout.  Nothing is re-resolved per call: the
networks of :mod:`repro_torch.models.gan` replay the frozen records.

Specs round-trip through JSON in the reference's format (version 3),
and :meth:`ProgramSpec.from_json` reads the reference's version 1, 2
and 3 files, mapping their backends to the port's
(``pallas-tpu`` → ``ganax``, ``pallas-interpret`` → ``ganax-plain``;
:mod:`repro_torch.core.dataflow`).  ``from_json`` validates hard
(version, backends, ranks, block shapes, kernel routes, epilogues): a
stale or corrupt file raises so loaders can fall back to fresh
resolution (see :func:`repro_torch.program.load_or_build`).

With ``backend="auto"`` the build consults the autotuning planner
(:mod:`repro_torch.tune`) per layer, and a tuned layer freezes its GANAX
kernel route (``LayerExec.route``), which the replay passes to the
kernel; a file with no tuned route is in the reference's format.  A
spec freezes its storage ``dtype`` (float32, bfloat16 or float16) and,
in a version-3 file, may embed int8 weights (``quantized_params``,
:mod:`repro_torch.quant.weights`), validated at load.  A frozen
``mesh`` and each layer's ``sharding`` are kept as data; the runtime
executes them over a process group of ``data·model`` ranks
(:class:`repro_torch.program.Program`).
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os

from repro_torch import obs as _obs
from repro_torch.core.dataflow import (BACKENDS, SHARDINGS, DataflowPolicy,
                                       Epilogue, backend_supports,
                                       blocks_valid,
                                       port_backend, resolve_execution,
                                       valid_layer_route)
from repro_torch.device import default_platform
from repro_torch.kernels.ganax_conv import KernelRoute
from repro_torch.models.gan import (discriminator_epilogues,
                                    generator_epilogues)
from repro_torch.quant.precision import canonical_dtype
from repro_torch.quant.weights import validate_quantized

__all__ = ["LayerExec", "ProgramSpec", "PROGRAM_FORMAT_VERSION",
           "SUPPORTED_PROGRAM_VERSIONS", "ROLES"]

# The reference's format: version 2 added the mesh/sharding fields,
# version 3 the storage dtype and the optional embedded int8 payload
# (``quantized_params``).  Older documents load: v1 means single-device,
# v1/v2 float32 with no payload.
PROGRAM_FORMAT_VERSION = 3
SUPPORTED_PROGRAM_VERSIONS = (1, 2, 3)

ROLES = ("generator", "discriminator")

# ``build(mesh=...)``'s "not passed" sentinel: None is a meaningful
# value (force single-device even if cfg carries a mesh).
_UNSET = object()


@dataclasses.dataclass(frozen=True)
class LayerExec:
    """One frozen layer execution record of a GAN program.

    The geometry fields mirror :class:`~repro_torch.core.analytical
    .ConvLayer`; ``w_param`` / ``b_param`` name the entries of the
    params dict the network reads; ``backend`` is the concrete port
    backend the layer runs; ``blocks`` the reference's Pallas tile
    shapes, when a file of the reference carried them (valid for this
    geometry, kept as data: no CUDA kernel reads them); ``source``
    the resolution's provenance (``pinned`` / ``tuned`` /
    ``heuristic``) and ``measured_us`` the tuned plan's time.
    ``sharding`` is the layer's frozen mesh layout (one of
    :data:`~repro_torch.core.dataflow.SHARDINGS`); ``"data"`` unless the
    owning spec carries a mesh with a model axis.  ``route`` is the
    tuned GANAX kernel route of a ``ganax`` layer, passed to the kernel
    at every call (``None``: ``kernel_route``'s per call).
    """

    name: str
    kind: str                       # "tconv" | "conv"
    in_spatial: tuple[int, ...]
    kernel: tuple[int, ...]
    strides: tuple[int, ...]
    paddings: tuple[int, ...]
    cin: int
    cout: int
    w_param: str
    b_param: str | None
    bias: bool
    activation: str
    leaky_slope: float
    backend: str
    blocks: tuple[int, ...] | None
    source: str                     # "pinned" | "tuned" | "heuristic"
    measured_us: float | None = None
    sharding: str = "data"          # "data" | "cout"
    route: KernelRoute | None = None

    def __post_init__(self):
        if self.kind not in ("tconv", "conv"):
            raise ValueError(f"unknown layer kind {self.kind!r}")
        if self.source not in ("pinned", "tuned", "heuristic"):
            raise ValueError(f"unknown resolution source {self.source!r}")
        if self.sharding not in SHARDINGS:
            raise ValueError(f"unknown layer sharding "
                             f"{self.sharding!r}; one of {SHARDINGS}")
        # constructing the epilogue validates activation/leaky_slope —
        # a corrupt program file must fail here, not at the first call
        Epilogue(bias=self.bias, activation=self.activation,
                 leaky_slope=self.leaky_slope)
        if self.bias and self.b_param is None:
            raise ValueError(f"layer {self.name!r} has bias=True but "
                             f"no b_param")
        if self.route is not None and self.backend != "ganax":
            raise ValueError(f"layer {self.name!r} carries a kernel route "
                             f"on backend {self.backend!r}")

    @property
    def nd(self) -> int:
        return len(self.in_spatial)

    @functools.cached_property
    def epilogue(self) -> Epilogue:
        # cached: the replay reads it at every call of every layer
        return Epilogue(bias=self.bias, activation=self.activation,
                        leaky_slope=self.leaky_slope)

    def plan_key(self, batch: int, dtype: str, platform: str):
        """The autotuner :class:`~repro_torch.tune.PlanKey` of this
        layer: the one source the tuner's zoo entry points key plans
        on."""
        from repro_torch.tune.planner import PlanKey
        return PlanKey(kind=self.kind, batch=int(batch),
                       in_spatial=self.in_spatial, kernel=self.kernel,
                       strides=self.strides, paddings=self.paddings,
                       cin=self.cin, cout=self.cout, dtype=dtype,
                       platform=platform, **self.epilogue.key_fields())

    def geometry_signature(self) -> tuple:
        """The layer's workload identity (everything but the resolved
        execution) — what a program file must match to serve a config."""
        return (self.name, self.kind, self.in_spatial, self.kernel,
                self.strides, self.paddings, self.cin, self.cout,
                self.bias, self.activation, self.leaky_slope)

    def describe(self) -> str:
        sp = "x".join(map(str, self.in_spatial))
        k = "x".join(map(str, self.kernel))
        s = "x".join(map(str, self.strides))
        exec_ = self.backend
        if self.route is not None:
            exec_ += f"[{self.route.describe()}]"
        if self.blocks:
            exec_ += f"[{'x'.join(map(str, self.blocks))}]"
        us = "" if self.measured_us is None \
            else f"  {self.measured_us:.0f}us"
        shard = "" if self.sharding == "data" else f"  @{self.sharding}"
        return (f"{self.name}: {self.kind} {sp} k{k} s{s} "
                f"{self.cin}->{self.cout}  ep[{self.epilogue.describe()}]"
                f"  -> {exec_}{shard}  ({self.source}{us})")

    def to_json(self) -> dict:
        d = {f.name: getattr(self, f.name)
             for f in dataclasses.fields(self)}
        d["blocks"] = list(self.blocks) if self.blocks else None
        for f in ("in_spatial", "kernel", "strides", "paddings"):
            d[f] = list(d[f])
        if self.route is None:
            del d["route"]          # the reference's format
        else:
            d["route"] = self.route.to_json()
        return d

    @classmethod
    def from_json(cls, d: dict) -> "LayerExec":
        names = {f.name for f in dataclasses.fields(cls)}
        # measured_us and sharding are optional on input: version-1
        # documents predate sharding and default to "data"; only the
        # port writes a route
        if not (names - {"measured_us", "sharding", "route"} <= set(d)
                <= names):
            raise ValueError(f"bad layer fields: {sorted(d)}")
        d = dict(d)
        for f in ("in_spatial", "kernel", "strides", "paddings"):
            d[f] = tuple(int(v) for v in d[f])
        for f in ("cin", "cout"):
            d[f] = int(d[f])
        if d.get("blocks") is not None:
            d["blocks"] = tuple(int(v) for v in d["blocks"])
        if d.get("route") is not None:
            d["route"] = KernelRoute.from_json(d["route"])
        # the reference's backend names map to the port's; an unknown
        # name raises ValueError here
        d["backend"] = port_backend(str(d["backend"]))
        le = cls(**d)
        # the epilogue/kind/source checks ran in __post_init__; now the
        # executable part: the backend must run this rank and (for the
        # kernel backends) the recorded tile shapes must fit
        kernel = BACKENDS[le.backend].kernel
        if not backend_supports(le.backend, le.nd):
            raise ValueError(f"backend {le.backend!r} does not support "
                             f"{le.nd}-D layer {le.name!r}")
        if le.blocks is not None:
            if not kernel:
                raise ValueError(f"layer {le.name!r} carries blocks on "
                                 f"non-kernel backend {le.backend!r}")
            if not blocks_valid(le.kind, le.in_spatial, le.kernel,
                                le.strides, le.paddings, le.cin, le.cout,
                                le.blocks):
                raise ValueError(f"stale blocks {le.blocks} for layer "
                                 f"{le.name!r}")
        return le


@dataclasses.dataclass(frozen=True)
class ProgramSpec:
    """A frozen, fully resolved execution plan for one GAN network.

    ``batch`` is the *planning* batch (the reference keys tuned plans on
    it); the runtime accepts any batch.  ``platform`` records where the
    spec was resolved (provenance).  ``requested_backend`` keeps the
    policy form the spec was built from (``None`` = heuristic), for
    display.  ``mesh`` is the frozen ``(data, model)`` device layout or
    ``None``; it is not part of :meth:`geometry_signature`.  ``dtype``
    is the storage precision and *is* part of it.  ``quantized_params``
    is an exported program's embedded int8 payload
    (:func:`repro_torch.quant.quantize_program`), which
    :attr:`repro_torch.program.Program.params` dequantizes.
    """

    model: str
    role: str                       # "generator" | "discriminator"
    batch: int
    z_dim: int | None               # generator programs only
    channel_scale: float
    dtype: str
    platform: str
    requested_backend: str | None
    layers: tuple[LayerExec, ...]
    mesh: tuple[int, int] | None = None
    quantized_params: dict | None = None

    def __post_init__(self):
        if self.role not in ROLES:
            raise ValueError(f"unknown program role {self.role!r}; "
                             f"one of {ROLES}")
        object.__setattr__(self, "dtype", canonical_dtype(self.dtype))
        if not self.layers:
            raise ValueError("a program needs at least one layer")
        if self.mesh is not None:
            if (len(self.mesh) != 2
                    or any(not isinstance(v, int) or v < 1
                           for v in self.mesh)):
                raise ValueError(f"mesh must be two positive ints "
                                 f"(data, model), got {self.mesh!r}")
        if self.quantized_params is not None and \
                not isinstance(self.quantized_params, dict):
            raise ValueError("quantized_params must be a JSON object")
        model_dim = self.mesh[1] if self.mesh else 1
        for le in self.layers:
            local = le.cout
            if le.sharding == "cout":
                if model_dim <= 1:
                    raise ValueError(
                        f"layer {le.name!r} is Cout-sharded but the "
                        f"program mesh {self.mesh!r} has no model axis")
                if le.cout % model_dim:
                    raise ValueError(
                        f"layer {le.name!r} cout={le.cout} does not "
                        f"divide over model axis of {model_dim}")
                local = le.cout // model_dim
            if le.route is not None:
                # a route is the kernel's at the spec's storage dtype, on
                # the Cout a rank computes (a "cout" layer's local shard)
                route = valid_layer_route(
                    le.route, le.kind, le.in_spatial, le.kernel,
                    le.strides, le.paddings, le.cin, local, self.dtype)
                if route is None:
                    raise ValueError(
                        f"layer {le.name!r}: no GANAX kernel takes route "
                        f"{le.route.describe()} at {self.dtype} on Cout "
                        f"{local}")

    # -- construction -------------------------------------------------------
    @classmethod
    def build(cls, cfg, batch: int, role: str = "generator", *,
              policy: DataflowPolicy | None = None, planner=None,
              measure: bool = False, dtype: str | None = None,
              mesh=_UNSET, cout_shard_min_bytes: int | None = None,
              platform: str | None = None) -> "ProgramSpec":
        """Walk ``cfg``'s layers once and freeze every resolution.

        ``policy`` defaults to ``cfg.policy``; ``dtype`` to ``cfg.dtype``;
        ``mesh`` to ``cfg.mesh`` (pass ``None`` to force
        single-device), each layer's sharding chosen by
        :func:`~repro_torch.core.dataflow.choose_layer_sharding`.  With
        ``backend="auto"`` each layer consults the autotuning planner
        (``planner`` or the process-wide one) under its plan key on
        ``platform`` (default: the card's when there is one), and a
        tuned layer freezes the plan's backend, kernel route and time;
        ``measure=True`` tunes plan misses first, the one place
        measurement belongs.  ``cout_shard_min_bytes`` overrides the
        sharding heuristic's threshold (tests pass ``0`` to shard small
        configurations on Cout)."""
        if role not in ROLES:
            raise ValueError(f"unknown program role {role!r}; "
                             f"one of {ROLES}")
        policy = policy or cfg.policy
        dtype = canonical_dtype(cfg.dtype if dtype is None else dtype)
        if mesh is _UNSET:
            mesh = cfg.mesh
        if mesh is not None:
            mesh = (int(mesh[0]), int(mesh[1]))
        platform = platform or default_platform()
        g_layers, d_layers = cfg.layers
        if role == "generator":
            layers, prefix = g_layers, "t"
            epilogues = generator_epilogues(g_layers)
        else:
            layers, prefix = d_layers, "c"
            epilogues = discriminator_epilogues(d_layers)
        records = []
        with _obs.trace("program.build", model=cfg.name, role=role,
                        batch=int(batch), measure=bool(measure),
                        layers=len(layers)):
            for i, (l, ep) in enumerate(zip(layers, epilogues)):
                kind = "tconv" if l.transposed else "conv"
                res = resolve_execution(
                    policy, kind, l.in_spatial, l.kernel, l.strides,
                    l.paddings, l.cin, l.cout, batch=batch, dtype=dtype,
                    epilogue=ep, planner=planner, measure=measure,
                    mesh_model=mesh[1] if mesh else 1,
                    cout_shard_min_bytes=cout_shard_min_bytes,
                    platform=platform)
                records.append(LayerExec(
                    name=l.name, kind=kind,
                    in_spatial=tuple(l.in_spatial),
                    kernel=tuple(l.kernel),
                    strides=tuple(l.strides), paddings=tuple(l.paddings),
                    cin=int(l.cin), cout=int(l.cout),
                    w_param=f"{prefix}{i}_w",
                    b_param=f"{prefix}{i}_b" if ep.bias else None,
                    bias=ep.bias, activation=ep.activation,
                    leaky_slope=ep.leaky_slope,
                    backend=res.backend, blocks=res.blocks,
                    source=res.source, measured_us=res.measured_us,
                    sharding=res.sharding, route=res.route))
        _obs.counter("program.builds").inc()
        return cls(model=cfg.name, role=role, batch=int(batch),
                   z_dim=int(cfg.z_dim) if role == "generator" else None,
                   channel_scale=float(cfg.channel_scale), dtype=dtype,
                   platform=platform,
                   requested_backend=policy.backend,
                   layers=tuple(records), mesh=mesh)

    # -- queries ------------------------------------------------------------
    def plan_keys(self) -> list[tuple[str, object]]:
        """(layer name, :class:`~repro_torch.tune.PlanKey`) per layer, at
        the spec's planning batch, dtype and platform: what the tuner's
        zoo entry points iterate."""
        return [(le.name, le.plan_key(self.batch, self.dtype,
                                      self.platform))
                for le in self.layers]

    def geometry_signature(self) -> tuple:
        """The whole network's workload identity: a loaded spec whose
        signature differs from a freshly built one is stale (topology,
        scaling, epilogue or storage-precision drift) and must not
        serve.  The mesh and the quantized payload are not part of it."""
        return (self.model, self.role, self.z_dim, self.dtype, tuple(
            le.geometry_signature() for le in self.layers))

    def summary(self) -> str:
        """One-line resolution summary (the repr-sized :meth:`describe`)."""
        if self.requested_backend == "auto":
            return "auto(" + ", ".join(
                f"{le.name}->{le.backend}"
                + (f"[{le.route.describe()}]" if le.route else "")
                for le in self.layers) + ")"
        backends = sorted({le.backend for le in self.layers})
        return backends[0] if len(backends) == 1 \
            else f"mixed({', '.join(backends)})"

    def describe(self) -> str:
        """The human-readable program listing: header plus one line per
        frozen layer record (and a note when tile shapes ride along)."""
        mesh = "" if self.mesh is None else \
            f"mesh={self.mesh[0]}x{self.mesh[1]}  "
        quant = "" if self.quantized_params is None else "quant=int8  "
        head = (f"program {self.model}/{self.role}  "
                f"batch={self.batch}  dtype={self.dtype}  {quant}"
                f"platform={self.platform}  {mesh}"
                f"policy={self.requested_backend or 'heuristic'}  "
                f"({len(self.layers)} layers)")
        lines = [head] + [f"  {le.describe()}" for le in self.layers]
        if any(le.blocks for le in self.layers):
            lines.append("  [AxBxC]: the reference's Pallas tile shapes, "
                         "kept as data; the CUDA kernels run a kernel "
                         "route ([tc/width/splits], [narrow/splits]) "
                         "instead")
        return "\n".join(lines)

    # -- persistence --------------------------------------------------------
    def to_json(self) -> dict:
        doc = {
            "version": PROGRAM_FORMAT_VERSION,
            "model": self.model, "role": self.role, "batch": self.batch,
            "z_dim": self.z_dim, "channel_scale": self.channel_scale,
            "dtype": self.dtype, "platform": self.platform,
            "requested_backend": self.requested_backend,
            "layers": [le.to_json() for le in self.layers],
            "mesh": list(self.mesh) if self.mesh else None,
        }
        if self.quantized_params is not None:
            doc["quantized_params"] = self.quantized_params
        return doc

    @classmethod
    def from_json(cls, doc: dict) -> "ProgramSpec":
        if not isinstance(doc, dict):
            raise ValueError(f"program doc must be a dict, got "
                             f"{type(doc).__name__}")
        version = doc.get("version")
        if version not in SUPPORTED_PROGRAM_VERSIONS:
            raise ValueError(f"unsupported program version "
                             f"{version!r} "
                             f"(want one of {SUPPORTED_PROGRAM_VERSIONS})")
        layers = doc.get("layers")
        if not isinstance(layers, list) or not layers:
            raise ValueError("program doc has no 'layers' list")
        # version-gated defaults: v1 documents predate the mesh fields
        # and mean a single-device program; v1/v2 predate the storage-
        # precision and quantization fields and mean plain float32
        mesh = doc.get("mesh") if version >= 2 else None
        if mesh is not None:
            if not isinstance(mesh, (list, tuple)) or len(mesh) != 2:
                raise ValueError(f"program mesh must be [data, model], "
                                 f"got {mesh!r}")
            mesh = (int(mesh[0]), int(mesh[1]))
        dtype = str(doc.get("dtype", "float32")) if version >= 3 \
            else "float32"
        quantized = doc.get("quantized_params") if version >= 3 else None
        if quantized is not None:
            # a corrupt payload raises here, where loaders degrade
            validate_quantized(quantized)
        z_dim = doc.get("z_dim")
        return cls(model=str(doc["model"]), role=str(doc["role"]),
                   batch=int(doc["batch"]),
                   z_dim=None if z_dim is None else int(z_dim),
                   channel_scale=float(doc.get("channel_scale", 1.0)),
                   dtype=dtype,
                   platform=str(doc.get("platform", "cpu")),
                   requested_backend=doc.get("requested_backend"),
                   layers=tuple(LayerExec.from_json(d) for d in layers),
                   mesh=mesh, quantized_params=quantized)

    def save(self, path) -> None:
        """Atomically write the spec's JSON document to ``path``."""
        path = os.fspath(path)
        tmp = f"{path}.tmp.{os.getpid()}"
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        with open(tmp, "w") as f:
            json.dump(self.to_json(), f, indent=2, sort_keys=True)
            f.write("\n")
        os.replace(tmp, path)

    @classmethod
    def load(cls, path) -> "ProgramSpec":
        """Read + validate a spec JSON file (raises on corrupt/stale —
        use :func:`repro_torch.program.load_or_build` for the degrading
        form)."""
        with open(path) as f:
            return cls.from_json(json.load(f))
