"""Executable GAN models (the paper's Table I workloads) on GANAX ops.

The port of ``repro.models.gan``: the config, the parameter specs of
both networks, their fused epilogues, the initializer, the two networks
and the losses.  Both networks replay the frozen
:class:`~repro_torch.program.LayerExec` records of a
:class:`~repro_torch.program.ProgramSpec` (built from the config's
policy when none is given): this is the port's one layer replay, the
counterpart of the reference's ``Program._replay``, and
:class:`repro_torch.program.Program` runs through it.
:class:`Generator` replays the generator branch: the z-projection (an
f32 matmul, + bias, ReLU), then one ``tconv`` / ``conv`` per record on
the record's backend, with its bias and activation fused into the
kernel's flush (on the record's tuned kernel route, if it froze one).
:class:`Discriminator` replays the discriminator
branch: one ``conv`` (or ``tconv``) per record with bias + LeakyReLU
fused, then the mean of the logits in f32.  Both hold trainable
parameters; the kernel backends differentiate through
``core.dataflow``'s autograd Function.  With obs tracing on, each
layer gets a ``program.layer`` span.

The storage precision (``GanConfig.dtype`` → ``ProgramSpec.dtype``:
float32, bfloat16 or float16) is applied in the replay, as the
reference's ``Program._replay`` applies it: the latents and each weight
are cast to it at use, the projection's products are summed in f32,
biases stay f32 into the fused epilogues, and every layer's output is
stored in it; the discriminator's logits are reduced in f32 and stay
f32.  Parameters stay f32 in the caller's dict, and training
differentiates through the casts: each weight's gradient comes back
from the storage dtype as f32 (mixed-precision training).

Given a rank's :class:`~repro_torch.sharding.collectives.MeshAxes`
(``mesh=``), the replay is the reference's ``shard_map`` body: the
network takes the global batch and computes on the rank's ``data``
rows; a ``"cout"`` record runs on the rank's Cout slice of its weight
and bias (sliced at use from the full tensors, so the epilogue is fused
on the shard) and gathers the full Cout after the layer; the output is
gathered on the batch axis, the discriminator's after its f32 mean.  The
gradient sums that keep a backward equal to the unsharded one are
:mod:`repro_torch.sharding.collectives`'s.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from typing import Sequence

import torch
from torch import nn

from repro_torch import obs as _obs
from repro_torch.configs.gans import GAN_MODELS
from repro_torch.core.analytical import ConvLayer
from repro_torch.core.dataflow import DataflowPolicy, Epilogue, conv, tconv
from repro_torch.device import require_ieee_f32, resolve_device
from repro_torch.models.common import PSpec, init_params
from repro_torch.quant.precision import canonical_dtype, storage_dtype
from repro_torch.sharding.collectives import (gather_batch, gather_channels,
                                              rows, shard_batch, sum_grad)

__all__ = ["GanConfig", "generator_specs", "discriminator_specs",
           "generator_epilogues", "discriminator_epilogues", "init_gan",
           "check_params", "Generator", "Discriminator", "generator_apply",
           "discriminator_apply", "bce_with_logits", "gan_losses",
           "LEAKY_SLOPE"]

# The discriminator's LeakyReLU slope (DCGAN convention, used by every
# Table-I discriminator).
LEAKY_SLOPE = 0.2

# the replay's span when tracing is off (reusable)
_NO_SPAN = contextlib.nullcontext()


@dataclasses.dataclass(frozen=True)
class GanConfig:
    """One Table-I model.  ``channel_scale`` shrinks the channels for
    CPU-sized runs; ``backend`` is the dataflow policy's backend (a port
    or reference name, ``"pallas"``, ``"auto"``: the tuner's plans, or
    ``None``: the heuristic, the kernel); ``mesh`` the ``(data, model)``
    layout programs built from the config freeze (sharded over a process
    group of ``data·model`` ranks, else on one device);
    ``dtype`` is the storage precision (float32, bfloat16 or float16,
    aliases accepted; accumulation is always f32)."""

    name: str
    z_dim: int = 100
    channel_scale: float = 1.0
    backend: str | None = None
    mesh: tuple[int, int] | None = None
    dtype: str = "float32"

    def __post_init__(self):
        if self.name not in GAN_MODELS:
            raise ValueError(f"unknown GAN {self.name!r}; one of "
                             f"{tuple(sorted(GAN_MODELS))}")
        DataflowPolicy(backend=self.backend)   # validates the name
        object.__setattr__(self, "dtype", canonical_dtype(self.dtype))

    @property
    def policy(self) -> DataflowPolicy:
        return DataflowPolicy(backend=self.backend)

    @property
    def layers(self) -> tuple[list[ConvLayer], list[ConvLayer]]:
        g, d = GAN_MODELS[self.name]
        if self.channel_scale != 1.0:
            def shrink(l: ConvLayer) -> ConvLayer:
                c_in = max(1, int(l.cin * self.channel_scale)) \
                    if l.cin > 3 else l.cin
                c_out = max(1, int(l.cout * self.channel_scale)) \
                    if l.cout > 3 else l.cout
                return dataclasses.replace(l, cin=c_in, cout=c_out)
            g = [shrink(l) for l in g]
            d = [shrink(l) for l in d]
        return g, d


def _conv_specs(layers: Sequence[ConvLayer], prefix: str) -> dict:
    specs = {}
    for i, l in enumerate(layers):
        fan_in = math.prod(l.kernel) * l.cin
        specs[f"{prefix}{i}_w"] = PSpec(
            tuple(l.kernel) + (l.cin, l.cout),
            (None,) * len(l.kernel) + ("conv_in", "conv_out"),
            scale=fan_in ** -0.5)   # no batch-norm → fan-in init
        specs[f"{prefix}{i}_b"] = PSpec((l.cout,), ("conv_out",),
                                        init="zeros")
    return specs


def generator_specs(cfg: GanConfig) -> dict[str, PSpec]:
    g_layers, _ = cfg.layers
    first = g_layers[0]
    proj_dim = math.prod(first.in_spatial) * first.cin
    specs = {"proj_w": PSpec((cfg.z_dim, proj_dim), (None, "mlp"),
                             scale=0.02),
             "proj_b": PSpec((proj_dim,), ("mlp",), init="zeros")}
    specs.update(_conv_specs(g_layers, "t"))
    return specs


def discriminator_specs(cfg: GanConfig) -> dict[str, PSpec]:
    _, d_layers = cfg.layers
    return _conv_specs(d_layers, "c")


def generator_epilogues(g_layers: Sequence[ConvLayer]) -> list[Epilogue]:
    """Per-layer fused epilogues of a Table-I generator: bias + ReLU on
    every hidden layer, bias + tanh on the image-producing last one."""
    last = len(g_layers) - 1
    return [Epilogue(bias=True,
                     activation="tanh" if i == last else "relu")
            for i in range(len(g_layers))]


def discriminator_epilogues(d_layers: Sequence[ConvLayer]
                            ) -> list[Epilogue]:
    """Per-layer fused epilogues of a Table-I discriminator: bias +
    LeakyReLU on every hidden layer, bias only on the logits layer."""
    last = len(d_layers) - 1
    return [Epilogue(bias=True,
                     activation="none" if i == last else "leaky_relu",
                     leaky_slope=LEAKY_SLOPE)
            for i in range(len(d_layers))]


def init_gan(cfg: GanConfig, gen: torch.Generator,
             device: str | torch.device = "cuda"
             ) -> tuple[dict[str, torch.Tensor], dict[str, torch.Tensor]]:
    """(generator, discriminator) parameters drawn from the CPU
    generator ``gen`` and placed on ``device``."""
    dev = resolve_device(device)
    return (init_params(gen, generator_specs(cfg), dev),
            init_params(gen, discriminator_specs(cfg), dev))


def check_params(params: dict, specs: dict[str, PSpec]) -> None:
    """Raise unless ``params`` has exactly the names of ``specs``, each
    with its shape."""
    missing = sorted(set(specs) - set(params))
    extra = sorted(set(params) - set(specs))
    if missing or extra:
        raise ValueError(f"parameter names do not match the specs: "
                         f"missing {missing}, unexpected {extra}")
    for name, spec in specs.items():
        shape = tuple(params[name].shape)
        if shape != spec.shape:
            raise ValueError(f"parameter {name!r} has shape {shape}, the "
                             f"spec says {spec.shape}")


class _Network(nn.Module):
    """The layer replay both networks share: parameters named as
    ``specs`` says, held as trainable ``nn.Parameter``s on ``device`` (a
    float32 tensor already there shares its storage), and one dataflow
    op per frozen :class:`~repro_torch.program.LayerExec` record of
    ``spec`` (built from ``cfg.policy`` when None).  ``mesh``: the
    rank's :class:`~repro_torch.sharding.collectives.MeshAxes` on the
    spec's mesh, for a sharded replay (None: one device)."""

    def __init__(self, cfg: GanConfig, params: dict[str, torch.Tensor],
                 device, specs: dict[str, PSpec], role: str, spec=None,
                 mesh=None):
        from repro_torch.program.spec import ProgramSpec
        super().__init__()
        dev = resolve_device(device)
        if spec is None:
            spec = ProgramSpec.build(cfg, 1, role)
        elif spec.role != role:
            raise ValueError(f"a {role} replays a {role} program, got "
                             f"role={spec.role!r}")
        check_params(params, specs)
        self.cfg = cfg
        self.spec = spec
        self.records = spec.layers
        self.storage = storage_dtype(spec.dtype)
        self.weights = nn.ParameterDict({
            name: nn.Parameter(
                torch.as_tensor(t, dtype=torch.float32).to(dev))
            for name, t in sorted(params.items())})
        self.mesh = mesh
        # each "cout" record's [lo, hi) of its weight's last axis, bound
        # once; the replay slices the full tensors at use
        self._cout = {} if mesh is None else {
            le.name: rows(le.cout, mesh.shape[1], mesh.model)
            for le in spec.layers if le.sharding == "cout"}

    @property
    def params(self) -> dict[str, nn.Parameter]:
        """The parameters by their reference names (``proj_w``,
        ``t0_w``, ``c0_b``, ...): the tensors themselves, not copies."""
        return dict(self.weights.items())

    def _replicated(self, t: torch.Tensor | None) -> torch.Tensor | None:
        """A replicated parameter at use: its gradient summed over
        ``data`` on a mesh."""
        if t is None or self.mesh is None:
            return t
        return sum_grad(t, self.mesh.data_group, "data")

    def _layer_operands(self, le, x):
        """``(x, w, b)`` of one record on this rank: on a ``"cout"``
        record the rank's Cout slice of the weight and bias, whose
        gradients are summed over every rank, and an input whose
        gradient is summed over ``model``."""
        p = self.weights
        w = p[le.w_param]
        b = p[le.b_param] if le.bias else None
        if le.name not in self._cout:
            return x, self._replicated(w), self._replicated(b)
        lo, hi = self._cout[le.name]
        world = self.mesh.world_group
        w = sum_grad(w, world, "world")[..., lo:hi]
        if b is not None:
            b = sum_grad(b, world, "world")[lo:hi]
        return sum_grad(x, self.mesh.model_group, "model"), w, b

    def _layers(self, x: torch.Tensor) -> torch.Tensor:
        sd = self.storage
        tracing = _obs.is_enabled()
        for le in self.records:
            op = tconv if le.kind == "tconv" else conv
            span = _obs.trace("program.layer", layer=le.name,
                              kind=le.kind, backend=le.backend,
                              source=le.source,
                              measured_us=le.measured_us) \
                if tracing else _NO_SPAN
            with span:
                x, w, b = self._layer_operands(le, x)
                x = op(x, w.to(sd), le.strides, le.paddings,
                       backend=le.backend, route=le.route, bias=b,
                       epilogue=le.epilogue)
                if le.name in self._cout:
                    # the full Cout back on the channels axis (the storage
                    # dtype travels); no halo, Cout is an output dimension
                    x = gather_channels(x, self.mesh.model_group)
        return x

    def _shard(self, x: torch.Tensor) -> torch.Tensor:
        """The rank's ``data`` rows of the global batch ``x``."""
        if self.mesh is None:
            return x
        d = self.mesh.shape[0]
        if x.shape[0] % d:
            raise ValueError(
                f"batch {x.shape[0]} does not divide over the data axis "
                f"of {d} (program {self.spec.model}/{self.spec.role} mesh "
                f"{d}x{self.mesh.shape[1]})")
        return shard_batch(x, self.mesh.data_group)

    def _gather(self, x: torch.Tensor) -> torch.Tensor:
        """The global output from the ranks' ``data`` rows."""
        return x if self.mesh is None else \
            gather_batch(x, self.mesh.data_group)


class Generator(_Network):
    """A Table-I generator: ``z (B, z_dim)`` → image ``(B, H, W, C)``,
    or volume ``(B, D, H, W, C)`` for 3D-GAN, whose layers run through
    the 3-D kernel.

    ``params`` are named as :func:`generator_specs` says and are moved
    to ``device`` (default: the card) as trainable parameters; a server
    freezes them (``requires_grad_(False)``).  ``spec``: the generator
    program to replay (default: built from ``cfg.policy``)."""

    def __init__(self, cfg: GanConfig, params: dict[str, torch.Tensor],
                 device: str | torch.device = "cuda", spec=None,
                 mesh=None):
        super().__init__(cfg, params, device, generator_specs(cfg),
                         "generator", spec, mesh)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        p = self.weights
        sd = self.storage
        first = self.records[0]
        require_ieee_f32(z)
        z = self._shard(z)
        # z and proj_w rounded to storage, their products summed in f32
        # (an f32 matmul: a bf16/f16 product is exact in f32), the bias
        # added in f32, then ReLU and one cast to storage
        x = torch.matmul(z.to(sd).float(),
                         self._replicated(p["proj_w"]).to(sd).float()) \
            + self._replicated(p["proj_b"]).float()
        x = torch.relu(x.reshape((x.shape[0],) + tuple(first.in_spatial)
                                 + (first.cin,))).to(sd)
        return self._gather(self._layers(x))


class Discriminator(_Network):
    """A Table-I discriminator: image ``(B, H, W, C)`` (3D-GAN: volume
    ``(B, D, H, W, C)``) → logits ``(B,)``, the mean over each sample's
    last-layer map, reduced in f32.

    ``params`` are named as :func:`discriminator_specs` says and are
    moved to ``device`` (default: the card) as trainable parameters.
    ``spec``: the discriminator program to replay (default: built from
    ``cfg.policy``)."""

    def __init__(self, cfg: GanConfig, params: dict[str, torch.Tensor],
                 device: str | torch.device = "cuda", spec=None,
                 mesh=None):
        super().__init__(cfg, params, device, discriminator_specs(cfg),
                         "discriminator", spec, mesh)

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        x = self._layers(self._shard(img).to(self.storage))
        # the mean on the rank's rows, then the batch gathered
        return self._gather(
            x.reshape(x.shape[0], -1).mean(dim=-1, dtype=torch.float32))


@functools.lru_cache(maxsize=64)
def _cached_program(cfg: GanConfig, policy: DataflowPolicy, role: str,
                    batch: int, device: torch.device):
    from repro_torch.program import Program
    return Program.build(cfg, batch, role, policy=policy, device=device)


def _program_for(cfg: GanConfig, policy: DataflowPolicy | None, role: str,
                 x: torch.Tensor):
    """The differentiable :class:`~repro_torch.program.Program` of
    ``(cfg, policy, role)`` at ``x``'s batch, on ``x``'s device: built
    once and cached, except under ``backend="auto"``, whose resolution
    is a snapshot of the planner's plans and is rebuilt per call
    (lookups only, never measured), as the reference does."""
    policy = policy or cfg.policy
    batch = int(x.shape[0])
    if policy.backend == "auto":
        from repro_torch.program import Program
        return Program.build(cfg, batch, role, policy=policy,
                             device=x.device)
    return _cached_program(cfg, policy, role, batch, x.device)


def generator_apply(params, z: torch.Tensor, cfg: GanConfig,
                    policy: DataflowPolicy | None = None) -> torch.Tensor:
    """z (B, z_dim) → image (B, *spatial, C) on z's device, through a
    cached ahead-of-time differentiable program (the reference's
    functional form of :class:`Generator`): the config → policy walk
    runs once, not per call, and every conv layer's bias and activation
    run fused.  Autograd records the call against the program's network
    for ``params`` (``Program.network(params).params``, which share the
    storage of float32 tensors already on the device)."""
    return _program_for(cfg, policy, "generator", z).forward(params, z)


def discriminator_apply(params, img: torch.Tensor, cfg: GanConfig,
                        policy: DataflowPolicy | None = None
                        ) -> torch.Tensor:
    """img (B, *spatial, C) → logits (B,), the same program-backed form
    as :func:`generator_apply`."""
    return _program_for(cfg, policy, "discriminator", img).forward(params,
                                                                   img)


def bce_with_logits(logits: torch.Tensor, target: float) -> torch.Tensor:
    """Numerically stable binary cross-entropy on logits (mean)."""
    return torch.mean(
        torch.maximum(logits, torch.zeros_like(logits)) - logits * target
        + torch.log1p(torch.exp(-logits.abs())))


def gan_losses(generator: Generator, discriminator: Discriminator,
               z: torch.Tensor, real: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Non-saturating GAN losses ``(g_loss, d_loss, fake)``."""
    fake = generator(z)
    d_fake = discriminator(fake)
    d_real = discriminator(real)
    d_loss = bce_with_logits(d_real, 1.0) + bce_with_logits(d_fake, 0.0)
    g_loss = bce_with_logits(d_fake, 1.0)
    return g_loss, d_loss, fake
