"""The adversarial train step and the fault-tolerant training loop.

The port of ``repro.train.loop``:

* :func:`make_gan_train_step`: the non-saturating adversarial SGD step,
  a D step and then a G step against the *updated* D, with every conv
  and tconv, and every ``dx`` of the backward, through the GANAX kernel;
  at f32, bf16 or f16 storage (mixed precision: parameters, gradients
  and checkpoints stay f32), on the heuristic's or the tuner's plans;
  on a ``(data, model)`` mesh of ranks, data- and Cout-parallel, equal
  to the single-device step.
* :class:`TrainLoop`:
  - **Checkpoint and restart**: periodic async checkpoints; on a step
    failure the loop restores the latest checkpoint and replays from
    there (``batch_fn`` is a pure function of the step, so the replay is
    exact).
  - **Preemption**: SIGTERM checkpoints synchronously, then returns.
  - **Straggler watchdog**: a step slower than ``straggler_factor`` × the
    EWMA of the step times is counted and logged.
  - **Failure injection**: ``failure_injector(step) -> bool`` kills
    chosen steps deterministically (tests).
  - **Ranks**: under a process group of more than one rank, rank 0
    writes every checkpoint (synchronously) and a barrier follows;
    every rank restores, in the reference's layout, so a checkpoint
    saved sharded restores unsharded and the other way round.  A state
    held as blocks (the LLM's mesh step, whose ``state_specs`` give
    their layout) is gathered before rank 0 writes it, and each rank
    restores its blocks.
  - **Observability**, under the reference's names: the
    ``train.steps`` / ``.checkpoints`` / ``.stragglers`` / ``.failures``
    counters, the ``train.step_us`` histogram, a ``train.<metric>``
    gauge per logged scalar, ``train.checkpoint`` / ``.restore`` /
    ``.straggler`` / ``.failure`` / ``.preempt`` events, a
    ``train.step`` span per step, and the end-of-run μop-cache and
    tune-planner lines.

The state is a tree of tensors, a ``(g_params, d_params)`` pair of
dicts for the GANs (the LLM's is ``train.train_state``'s), which the
step updates in place (no second copy of the parameters per step); the
loop restores a checkpoint, or its host copy of the step-0 state, by
copying into it.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import tempfile
import time
from typing import Any, Callable

import torch
import torch.distributed as dist

from repro_torch import obs as _obs
from repro_torch.core.dataflow import DataflowPolicy
from repro_torch.models.gan import (Discriminator, GanConfig, Generator,
                                    bce_with_logits)
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import world_size
from repro_torch.program import Program
from repro_torch.program.spec import _UNSET as _MESH_UNSET
from repro_torch.train import checkpoint as ckpt

__all__ = ["LoopConfig", "TrainLoop", "InjectedFailure",
           "make_gan_train_step", "discriminator_grads", "generator_grads",
           "sgd_update"]


def discriminator_grads(generator: Generator, discriminator: Discriminator,
                        z: torch.Tensor, real: torch.Tensor
                        ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """The D step's loss and its gradient by parameter name.  G runs
    under ``torch.no_grad()``: only D's parameters are differentiated,
    and no ``dx`` reaches the fakes' first layer."""
    with torch.no_grad():
        fake = generator(z)
    params = discriminator.params
    d_loss = bce_with_logits(discriminator(real), 1.0) + \
        bce_with_logits(discriminator(fake), 0.0)
    grads = torch.autograd.grad(d_loss, list(params.values()))
    return d_loss.detach(), dict(zip(params, grads))


def generator_grads(generator: Generator, discriminator: Discriminator,
                    z: torch.Tensor
                    ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """The G step's loss and its gradient by parameter name.  D's
    parameters are frozen for the step, so the backward computes no D
    weight gradient, and ``D(real)``, which the loss does not read, is
    not run."""
    frozen = [p for p in discriminator.parameters() if p.requires_grad]
    for p in frozen:
        p.requires_grad_(False)
    try:
        params = generator.params
        g_loss = bce_with_logits(discriminator(generator(z)), 1.0)
        grads = torch.autograd.grad(g_loss, list(params.values()))
    finally:
        for p in frozen:
            p.requires_grad_(True)
    return g_loss.detach(), dict(zip(params, grads))


def sgd_update(params: dict[str, torch.Tensor],
               grads: dict[str, torch.Tensor], lr: float) -> None:
    """``p -= lr * grad`` for each named parameter, in place."""
    with torch.no_grad():
        for name, p in params.items():
            p.sub_(lr * grads[name])


def make_gan_train_step(cfg: GanConfig, batch: int,
                        g_params: dict[str, torch.Tensor],
                        d_params: dict[str, torch.Tensor], *,
                        g_lr: float = 2e-4, d_lr: float | None = None,
                        policy: DataflowPolicy | None = None,
                        planner=None, measure: bool = False,
                        device: str | torch.device = "cuda",
                        mesh=_MESH_UNSET):
    """The adversarial SGD step of ``cfg``'s networks.

    Builds the :class:`Generator` and :class:`Discriminator` once from
    ``g_params`` / ``d_params`` on ``device`` (default: the card) and
    returns ``(train_step, (generator, discriminator))``, where
    ``train_step(state, batch) -> (state, metrics)`` takes
    ``state = (generator.params, discriminator.params)`` and a batch
    ``{"z": (batch, z_dim), "real": (batch, *spatial, C)}``, and updates
    the parameters in place: ``p -= lr * grad``, D first, then G against
    the updated D.  ``metrics`` holds the ``g_loss``, ``d_loss`` and
    ``loss`` tensors (on the device; reading them waits for it).

    ``policy`` defaults to ``cfg.policy``; with ``backend="auto"`` the
    programs take the planner's plans (``planner`` or the process-wide
    one), and ``measure=True`` tunes the misses here, at build, never
    in the loop.

    **Mixed precision** (``cfg.dtype`` ``"bfloat16"`` / ``"float16"``):
    the networks cast activations and weights to the storage dtype at
    use and sum in f32; the kernels' ``dx`` runs at that dtype, ``dw``
    and ``db`` sum in f32, and the casts hand each gradient back as
    f32, so parameters, the SGD update and checkpoints stay f32.

    ``mesh`` (default: ``cfg.mesh``) builds **sharded** programs: every
    rank of a process group of ``data·model`` ranks calls the step with
    the same global batch and state; the networks compute on the rank's
    rows (and Cout slices of the ``"cout"`` layers), the losses come
    from the gathered global logits, identically on every rank, and the
    gradient sums of :mod:`repro_torch.sharding.collectives` make each
    rank's update the single-device one.  ``train_step.mesh`` is the
    programs' ``DeviceMesh`` (None unsharded or degraded) and
    ``train_step.state_shardings`` the layout of the state, a ``(g, d)``
    pair of ``{name: placements}`` dicts (every parameter replicated on
    both mesh axes; None unsharded), as the reference exposes its
    replicated shardings."""
    d_lr = g_lr if d_lr is None else d_lr
    # one ahead-of-time resolution for the whole run: both networks
    # replay programs frozen here, at the step's batch
    device = resolve_device(device)
    build = dict(policy=policy, planner=planner, measure=measure,
                 device=device, mesh=mesh)
    g_prog = Program.build(cfg, batch, "generator", **build)
    d_prog = Program.build(cfg, batch, "discriminator", **build)
    generator = g_prog.network(g_params)
    discriminator = d_prog.network(d_params)

    def train_step(state, batch_arrays):
        g_state, d_state = state
        for net, part in ((generator, g_state), (discriminator, d_state)):
            if part.keys() != net.weights.keys() or any(
                    part[k] is not p for k, p in net.weights.items()):
                raise ValueError("train_step updates its networks' own "
                                 "parameters: pass state = "
                                 "(generator.params, discriminator.params)")
        z, real = batch_arrays["z"], batch_arrays["real"]
        if z.shape[0] != batch or real.shape[0] != batch:
            raise ValueError(f"the step was built for batch {batch}, got "
                             f"z {tuple(z.shape)} and real "
                             f"{tuple(real.shape)}")
        dl, d_grads = discriminator_grads(generator, discriminator, z, real)
        sgd_update(d_state, d_grads, d_lr)
        gl, g_grads = generator_grads(generator, discriminator, z)
        sgd_update(g_state, g_grads, g_lr)
        return state, {"g_loss": gl, "d_loss": dl, "loss": gl + dl}

    train_step.mesh = g_prog.mesh
    train_step.state_shardings = None
    if g_prog.mesh is not None:
        from torch.distributed.tensor import Replicate
        placements = (Replicate(), Replicate())
        train_step.state_shardings = tuple(
            dict.fromkeys(net.weights, placements)
            for net in (generator, discriminator))
    return train_step, (generator, discriminator)


class InjectedFailure(RuntimeError):
    pass


def _host_copy(t: torch.Tensor) -> torch.Tensor:
    """A copy of ``t`` in host memory, pinned if ``t`` is on the card."""
    host = torch.empty(t.shape, dtype=t.dtype, device="cpu",
                       pin_memory=t.is_cuda)
    host.copy_(t.detach())
    return host


def _default_ckpt_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 100
    ckpt_dir: str = dataclasses.field(default_factory=_default_ckpt_dir)
    ckpt_every: int = 50
    async_ckpt: bool = True
    max_restarts: int = 10
    straggler_factor: float = 3.0
    ewma_alpha: float = 0.2
    log_every: int = 10


class TrainLoop:
    """Runs ``train_step`` from ``start_step`` to ``cfg.total_steps`` on
    ``state``, a tree of tensors the step updates in place or replaces.
    Plain integer counters of this loop (``steps``, ``checkpoints``,
    ``restarts``) and ``straggler_events`` / ``metrics_history`` record
    the run; the process-wide ``train.*`` metrics of ``repro_torch.obs``
    count it too."""

    def __init__(self, cfg: LoopConfig, train_step: Callable,
                 batch_fn: Callable[[int], dict], state: Any,
                 failure_injector: Callable[[int], bool] | None = None,
                 log_fn: Callable[[str], None] = print):
        self.cfg = cfg
        self.train_step = train_step
        self.batch_fn = batch_fn
        self.state = state
        self.failure_injector = failure_injector
        self.log = log_fn
        self.steps = 0
        self.checkpoints = 0
        self.restarts = 0
        self._last_saved_step: int | None = None
        self.straggler_events: list[int] = []
        self._ewma: float | None = None
        self._preempted = False
        self.metrics_history: list[dict] = []

    # -- signals ------------------------------------------------------------
    def _install_sigterm(self):
        def handler(signum, frame):
            self._preempted = True
        try:
            signal.signal(signal.SIGTERM, handler)
        except ValueError:
            pass  # not on the main thread (tests)

    # -- state ---------------------------------------------------------------
    def _assign(self, values) -> None:
        """Copy the tree ``values`` (on any device) into the state's
        tensors."""
        with torch.no_grad():
            for dst, src in zip(ckpt.tree_leaves(self.state),
                                ckpt.tree_leaves(values)):
                dst.copy_(src)

    def _sync(self) -> None:
        """Wait for the device the state lives on."""
        leaves = ckpt.tree_leaves(self.state)
        if leaves and leaves[0].is_cuda:
            torch.cuda.synchronize(leaves[0].device)

    # -- checkpointing -------------------------------------------------------
    def _save(self, step: int, sync: bool = False):
        mesh = getattr(getattr(self.train_step, "mesh", None), "shape",
                       None)
        mesh = None if mesh is None else tuple(int(v) for v in mesh)
        specs = getattr(self.train_step, "state_specs", None)
        if world_size() > 1:
            # rank 0 writes the whole state, synchronously, and the others
            # wait until the files are whole; a state of blocks is
            # gathered first
            sync = True
            if specs is not None:
                ckpt.save(self.state, self.cfg.ckpt_dir, step,
                          mesh=self.train_step.mesh, shardings=specs)
            else:
                if dist.get_rank() == 0:
                    ckpt.save(self.state, self.cfg.ckpt_dir, step,
                              mesh=mesh)
                dist.barrier()
        elif sync or not self.cfg.async_ckpt:
            # an async save of the same step may still be writing
            ckpt.wait_pending()
            ckpt.save(self.state, self.cfg.ckpt_dir, step, mesh=mesh)
        else:
            ckpt.save_async(self.state, self.cfg.ckpt_dir, step, mesh=mesh)
        self._last_saved_step = step
        self.checkpoints += 1
        _obs.counter("train.checkpoints").inc()
        _obs.event("train.checkpoint", step=step,
                   sync=bool(sync or not self.cfg.async_ckpt))

    def _restore_latest(self) -> int:
        ckpt.wait_pending()
        step = ckpt.latest_step(self.cfg.ckpt_dir)
        if step is None:
            # replay is only exact from the step-0 parameters, not from
            # whatever partially-trained state the failure left behind
            self._assign(self._initial_state)
            self.log("[loop] no checkpoint found; restarting from step 0")
            return 0
        specs = getattr(self.train_step, "state_specs", None)
        self._assign(ckpt.restore(
            self.state, self.cfg.ckpt_dir, step, shardings=specs,
            mesh=None if specs is None else self.train_step.mesh))
        self.log(f"[loop] restored checkpoint at step {step}")
        _obs.event("train.restore", step=step)
        return step

    # -- watchdog -----------------------------------------------------------
    def _watch(self, step: int, dt: float):
        if self._ewma is None:
            self._ewma = dt
            return
        if dt > self.cfg.straggler_factor * self._ewma:
            self.straggler_events.append(step)
            _obs.counter("train.stragglers").inc()
            _obs.event("train.straggler", step=step, dt_s=dt,
                       ewma_s=self._ewma)
            self.log(f"[loop] STRAGGLER step {step}: {dt:.3f}s vs "
                     f"EWMA {self._ewma:.3f}s")
        self._ewma = (1 - self.cfg.ewma_alpha) * self._ewma + \
            self.cfg.ewma_alpha * dt

    # -- main ---------------------------------------------------------------
    def run(self, start_step: int = 0) -> Any:
        self._install_sigterm()
        self._stats0 = _obs.collect()
        # the step updates the state in place: keep a copy to replay
        # from, on the host (pinned where the state is on the card), so
        # the device holds no second copy of the state
        self._initial_state = ckpt.tree_map(_host_copy, self.state)
        step_us = _obs.histogram("train.step_us")
        step = start_step
        while step < self.cfg.total_steps:
            if self._preempted:
                self.log(f"[loop] SIGTERM: checkpointing at {step}, exiting")
                _obs.event("train.preempt", step=step)
                self._save(step, sync=True)
                self._log_uop_cache()
                return self.state
            try:
                if self.failure_injector and self.failure_injector(step):
                    raise InjectedFailure(f"injected failure at step {step}")
                t0 = time.perf_counter()
                with _obs.trace("train.step", step=step):
                    batch = self.batch_fn(step)
                    self.state, metrics = self.train_step(self.state, batch)
                    self._sync()
                dt = time.perf_counter() - t0
                step_us.observe(dt * 1e6)
                _obs.counter("train.steps").inc()
                self.steps += 1
                self._watch(step, dt)
                if step % self.cfg.log_every == 0:
                    m = {k: float(v) for k, v in metrics.items()
                         if getattr(v, "ndim", 0) == 0}
                    for k, v in m.items():
                        _obs.gauge(f"train.{k}").set(v)
                    self.metrics_history.append({"step": step, **m})
                    self.log(f"[loop] step {step} "
                             f"loss={m.get('loss', -1):.4f} dt={dt:.3f}s")
                step += 1
                if step % self.cfg.ckpt_every == 0:
                    self._save(step)
            except InjectedFailure as e:
                self.restarts += 1
                _obs.counter("train.failures").inc()
                _obs.event("train.failure", step=step,
                           restart=self.restarts)
                self.log(f"[loop] FAILURE: {e}; restart "
                         f"{self.restarts}/{self.cfg.max_restarts}")
                if self.restarts > self.cfg.max_restarts:
                    raise
                step = self._restore_latest()
        # drain in-flight async saves; *this run* already checkpointed the
        # final step when total_steps is a multiple of ckpt_every (a stale
        # file from an earlier run in the same dir doesn't count)
        ckpt.wait_pending()
        if self._last_saved_step != self.cfg.total_steps:
            self._save(self.cfg.total_steps, sync=True)
        self._log_uop_cache()
        return self.state

    def _log_uop_cache(self):
        """Surface the dataflow μop-cache efficiency and the tune
        planner's lookups over this run: replayed steps should hit the
        cache, not re-run the scheduler, and a loop never measures
        (read through ``obs.collect()``, consistent copies)."""
        stats = _obs.collect()
        info = stats.get("dataflow.uop_cache")
        if info is not None:
            base = self._stats0.get("dataflow.uop_cache",
                                    {"hits": 0, "misses": 0})
            hits = info["hits"] - base["hits"]
            misses = info["misses"] - base["misses"]
            if hits or misses:
                self.log(f"[loop] dataflow μop cache: {hits} hits / "
                         f"{misses} misses this run "
                         f"({info['currsize']} geometries cached)")
        tune = stats.get("tune.planner")
        if tune is not None:
            base = self._stats0.get("tune.planner") or \
                {"lookups": 0, "hits": 0, "measurements": 0}
            lookups = tune["lookups"] - base["lookups"]
            if lookups:
                self.log(f"[loop] tune planner: {lookups} lookups / "
                         f"{tune['hits'] - base['hits']} plan hits / "
                         f"{tune['measurements'] - base['measurements']} "
                         f"measurements this run "
                         f"({tune['plans']} plans cached)")
