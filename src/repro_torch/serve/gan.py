"""Batched GAN image generation on ahead-of-time resolved programs.

The port of ``repro.serve.gan``.  On construction the server builds (or
is handed) one generator :class:`~repro_torch.program.Program`: the
config → policy walk happens exactly once, and the hot path replays the
program's frozen records.  The per-layer resolutions are exposed via
``server.describe()`` and the one-line summary in ``repr``.  A program
exported from another box (``ProgramSpec.save``) can be served directly
by passing ``program=``.

``generate(n)`` rounds work up to full batches but **discards nothing**:
tail samples beyond ``n`` are carried in a remainder buffer and served
first on the next call.  ``samples_served`` / ``samples_buffered`` /
``samples_discarded`` account for every sample the generator produced
(``served + buffered + discarded == batches x batch_size``).  The
counts live on the ``repro_torch.obs`` registry under the reference's
``serve.*`` names (one label set per server), beside the
``serve.request_us`` and ``serve.batch_occupancy`` histograms; each
``generate`` records a ``serve.generate`` span when tracing is on.  On
the card ``generate`` returns device tensors without waiting for the
device, so that span and ``serve.request_us`` time the host's part of
the call (``engine.request_us`` waits for each batch's copy).

Two ways to drive it:

* **Synchronous** — ``generate(n)`` from one thread returns the images
  on the server's device.
* **Asynchronous** — ``submit(n)`` (from any number of threads): the
  first ``submit`` hands the server's program, latent generator and
  remainder buffer to an internal single-bucket
  :class:`~repro_torch.serve.gan_engine.GanEngine` and returns a
  :class:`~repro_torch.serve.gan_engine.GanFuture` (CPU samples).  From
  then on ``generate`` delegates to the engine too and moves its
  samples to the server's device, so its return type does not change
  and the stream stays single-sourced and bit-identical to the
  synchronous one.  Call ``close()`` (or use the server as a context
  manager) to shut the engine down.

On a program sharded over a ``(data, model)`` mesh of ranks
(``mesh=``, or a sharded ``program=``), every rank builds the server
with the same arguments and calls ``generate`` in the same order: each
rank draws the same global latents from its own generator, seeded
alike (the server checks that once, by gathering a checksum of the
first batch's latents from every rank), and every rank returns the
same images.  ``batch_size`` must divide over the ``data`` axis.
``submit`` is collective there too: every rank calls it with the same
``n``, in the same order, and the first call builds the internal engine
on the mesh on every rank (rank 0 leads, the other ranks follow its
broadcasts, :class:`~repro_torch.serve.gan_engine.GanEngine`).  Rank 0's
futures carry the images, the stream the unsharded server gives; a
follower rank's future is finished at once and carries none (its
``result()`` is ``None``), and after the handoff a follower's
``generate`` returns ``None`` too, while its engine runs the batches rank
0 announces.  Every rank calls ``close``; a follower's returns once rank
0's engine has stopped.
"""

from __future__ import annotations

import dataclasses
import itertools
import time

import torch

from repro_torch import obs as _obs
from repro_torch.core.dataflow import DataflowPolicy
from repro_torch.device import resolve_device
from repro_torch.models.gan import GanConfig
from repro_torch.program import Program, ProgramSpec
from repro_torch.program.spec import _UNSET as _MESH_UNSET
from repro_torch.serve.gan_engine import GanEngine, GanFuture
from repro_torch.sharding import collectives

__all__ = ["GanServer"]

# Distinguishes the metrics of multiple servers in one process (same
# model, different seeds/batch sizes) — the label, not the metric name,
# carries the instance identity.
_SERVER_SEQ = itertools.count()

# Batch occupancy is a fraction of batch_size in (0, 1]; latency buckets
# make no sense for it.
_OCCUPANCY_BOUNDS = tuple(i / 10 for i in range(1, 11))


class GanServer:
    """Serves images of ``cfg``'s generator from a latent stream seeded
    by ``seed``, on ``device`` (default: the card).  With an ``auto``
    policy, ``warm_plans`` tunes every layer's plan here, at
    construction (none per request; zero measurements when the plan
    file is warm), and the program freezes the tuned backends and
    kernel routes; other policies ignore it.

    ``dtype`` overrides ``cfg.dtype``, the storage precision (float32,
    bfloat16 or float16; accumulation stays f32): the images come out in
    it.  Serving an exported ``program=`` without an override adopts
    the program's precision, and with ``g_params=None`` a quantized
    (int8-exported) program serves its embedded weights, dequantized on
    the server's device."""

    def __init__(self, cfg: GanConfig, g_params, batch_size: int = 8,
                 policy: DataflowPolicy | None = None, seed: int = 0,
                 warm_plans: bool = True,
                 program: Program | None = None, mesh=_MESH_UNSET,
                 dtype: str | None = None,
                 device: str | torch.device = "cuda"):
        if int(batch_size) <= 0:
            raise ValueError(f"batch_size must be positive, "
                             f"got {batch_size}")
        self.device = resolve_device(device)
        if dtype is not None:
            cfg = dataclasses.replace(cfg, dtype=dtype)
        if g_params is None and (program is None or not program.quantized):
            raise ValueError("g_params=None needs a quantized "
                             "program= (int8 export) to serve")
        self.cfg = cfg
        self.batch_size = int(batch_size)
        self.policy = policy or cfg.policy
        self._rng = torch.Generator(device=self.device)
        self._rng.manual_seed(int(seed))
        self.server_id = f"{cfg.name}#{next(_SERVER_SEQ)}"
        labels = {"server": self.server_id}
        self._m_batches = _obs.counter("serve.batches", **labels)
        self._m_served = _obs.counter("serve.samples_served", **labels)
        self._m_discarded = _obs.counter("serve.samples_discarded",
                                         **labels)
        self._m_buffered = _obs.gauge("serve.samples_buffered", **labels)
        self._m_request_us = _obs.histogram("serve.request_us", **labels)
        self._m_occupancy = _obs.histogram(
            "serve.batch_occupancy", bounds=_OCCUPANCY_BOUNDS, **labels)
        self._spare: torch.Tensor | None = None    # carried tail samples
        self._engine = None     # async façade (created on first submit)
        if program is not None:
            if program.spec.role != "generator":
                raise ValueError(f"GanServer needs a generator program, "
                                 f"got role={program.spec.role!r}")
            if dtype is None and program.spec.dtype != cfg.dtype:
                # adopt the exported program's storage precision unless
                # the caller pinned one explicitly
                cfg = dataclasses.replace(cfg, dtype=program.spec.dtype)
                self.cfg = cfg
            # a mismatched program file must fail here with a clear
            # error, not as a shape mismatch at the first call
            expected = ProgramSpec.build(cfg, self.batch_size,
                                         "generator",
                                         policy=DataflowPolicy())
            if program.spec.geometry_signature() != \
                    expected.geometry_signature():
                raise ValueError(
                    f"program {program.spec.model!r} froze a different "
                    f"workload than config {cfg.name!r} builds "
                    f"(topology / z_dim / channel-scale / epilogue / "
                    f"precision drift)")
            if program.device != self.device or program.differentiable:
                program = Program(program.spec, device=self.device,
                                  differentiable=False)
            self.program = program
        else:
            # measure=warm_plans: an auto policy tunes every layer plan
            # ahead of the first request (a no-op for other policies)
            self.program = Program.build(
                cfg, self.batch_size, "generator", policy=self.policy,
                measure=warm_plans, device=self.device,
                differentiable=False, mesh=mesh)
        if self.program.mesh is not None and \
                self.batch_size % self.program.spec.mesh[0]:
            raise ValueError(
                f"batch_size {self.batch_size} does not divide over "
                f"the program's data axis of "
                f"{self.program.spec.mesh[0]} (mesh "
                f"{self.program.mesh_str})")
        # on a mesh: whether the ranks' latent draws were checked equal
        self._draws_checked = self.program.mesh is None
        # int8-deploy flow: a quantized program carries its own
        # parameters, dequantized at load on the server's device
        self.params = self.program.params if g_params is None \
            else g_params
        # the network replaying the program with the server's
        # parameters (frozen: the program is not differentiable)
        self.generator = self.program.network(self.params)

    # -- accounting (registry-backed) ---------------------------------------
    # Once the async façade is live, the engine continues the stream:
    # totals are the pre-handoff counts plus the engine's, so the
    # ``served + buffered + discarded == batches × batch_size``
    # invariant spans the handoff.
    @property
    def batches_served(self) -> int:
        eng = self._engine
        return self._m_batches.value + (eng.batches_served if eng else 0)

    @property
    def samples_served(self) -> int:
        eng = self._engine
        return self._m_served.value + (eng.samples_served if eng else 0)

    @property
    def samples_discarded(self) -> int:
        eng = self._engine
        return self._m_discarded.value + \
            (eng.samples_discarded if eng else 0)

    @property
    def samples_buffered(self) -> int:
        if self._engine is not None:
            return self._engine.samples_buffered
        return 0 if self._spare is None else len(self._spare)

    def _set_spare(self, spare: torch.Tensor | None) -> None:
        self._spare = spare if spare is not None and len(spare) else None
        self._m_buffered.set(self.samples_buffered)

    def _next_latents(self) -> torch.Tensor:
        """The next batch's latents (advances the stream)."""
        z = torch.randn((self.batch_size, self.cfg.z_dim),
                        generator=self._rng, device=self.device)
        if not self._draws_checked:
            self._check_draws(z)
        return z

    def _check_draws(self, z: torch.Tensor) -> None:
        """Raise unless every rank of the mesh drew the same ``z`` (a
        debug check, once per server): the sum and the sum of squares of
        the draw, in float64, gathered from every rank."""
        sums = torch.stack([z.double().sum(), z.double().square().sum()])
        got = collectives.all_gather(sums[None], 0,
                                     self.program.axes.world_group)
        if not bool((got == got[0]).all()):
            raise RuntimeError(
                f"the ranks drew different latents (checksums "
                f"{got.tolist()}): build every rank's server with the "
                f"same seed and call generate in the same order")
        self._draws_checked = True

    # -- async façade -------------------------------------------------------
    def submit(self, n: int):
        """Asynchronous :meth:`generate`: enqueue a request and return
        a :class:`~repro_torch.serve.gan_engine.GanFuture` whose result
        is a CPU tensor (thread-safe).

        The first call hands the server's program, latent generator and
        remainder buffer to an internal single-bucket
        :class:`~repro_torch.serve.gan_engine.GanEngine`; the stream
        picks up exactly where the synchronous calls left off, so mixing
        ``generate`` and ``submit`` never forks or reorders it.  On a
        sharded program every rank calls it with the same ``n`` in the
        same order: the engine is built on the server's mesh, rank 0's
        future carries the images, and a follower rank's is finished
        with none (module docstring)."""
        if int(n) <= 0:
            raise ValueError(f"n must be positive, got {n}")
        engine = self._ensure_engine()
        return engine.submit(n) if engine.leader else GanFuture.settled(n)

    def close(self, drain: bool = True,
              timeout: float | None = None) -> None:
        """Shut the async engine down (no-op if :meth:`submit` was
        never called).  ``drain=True`` answers queued requests first;
        ``drain=False`` fails unscheduled ones with ``ServerClosed``;
        ``timeout`` bounds the wait for the scheduler thread.  On a mesh
        every rank calls it; a follower's returns once rank 0's engine
        has stopped."""
        if self._engine is not None:
            self._engine.close(drain=drain, timeout=timeout)

    def __enter__(self) -> "GanServer":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close(drain=exc_type is None)

    def _ensure_engine(self):
        if self._engine is None:
            # on a mesh the engine's program is the server's sharded one:
            # rank 0's engine leads, every other rank's follows it
            self._engine = GanEngine(
                self.cfg, self.params, buckets=(self.batch_size,),
                policy=self.policy, program=self.program, key=self._rng,
                spare=self._spare, warmup=False, device=self.device)
            self._set_spare(None)   # the engine owns the buffer now
        return self._engine

    def generate(self, n: int) -> torch.Tensor:
        """``n`` images ``(n, *spatial, C)`` on the server's device
        (3D-GAN: volumes ``(n, 64, 64, 64, 1)``).  Remainder samples of
        the last batch are buffered for the next call, never discarded.
        After the first :meth:`submit`, delegates to the async engine
        (same stream, same accounting); on a mesh a follower rank then
        returns ``None`` (rank 0 answers)."""
        if int(n) <= 0:
            raise ValueError(f"n must be positive, got {n}")
        if self._engine is not None:
            if not self._engine.leader:
                return None
            return self._engine.generate(n).to(self.device)
        t0 = time.perf_counter()
        with _obs.trace("serve.generate", server=self.server_id,
                        n=int(n)) as sp:
            outs = []
            remaining = int(n)
            batches = 0
            if self._spare is not None:
                take = min(len(self._spare), remaining)
                outs.append(self._spare[:take])
                self._set_spare(self._spare[take:])
                self._m_served.inc(take)
                remaining -= take
            while remaining > 0:
                img = self.program.apply(self.params, self._next_latents())
                self._m_batches.inc()
                batches += 1
                take = min(self.batch_size, remaining)
                self._m_served.inc(take)
                self._m_occupancy.observe(take / self.batch_size)
                remaining -= take
                outs.append(img[:take])
                if take < self.batch_size:
                    self._set_spare(img[take:])
            out = torch.cat(outs)
            sp.set(batches=batches, buffered=self.samples_buffered)
        self._m_request_us.observe((time.perf_counter() - t0) * 1e6)
        return out

    def describe(self) -> str:
        """The server's frozen execution: the program's per-layer
        records (op, geometry, epilogue, resolved backend, provenance)."""
        return self.program.describe()

    def __repr__(self) -> str:
        return (f"GanServer(model={self.cfg.name!r}, "
                f"batch_size={self.batch_size}, "
                f"policy={self.program.spec.summary()}, "
                f"device={self.device}, "
                f"served={self.samples_served}, "
                f"buffered={self.samples_buffered}, "
                f"discarded={self.samples_discarded})")
