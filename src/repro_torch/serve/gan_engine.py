"""Continuous-batching async GAN serving engine.

The port of ``repro.serve.gan_engine``.  :class:`GanEngine` is a
thread-safe front end that turns many concurrent sample requests into
a small number of well-packed device batches.

* **Request queue + scheduler thread.**  ``submit(n)`` is callable from
  any number of producer threads; it enqueues a :class:`GanFuture` and
  returns immediately.  A single scheduler thread owns the device work:
  it drains the queue, coalesces pending demand, advances the latent
  stream, launches compute, and distributes results.
* **Ahead-of-time bucket set.**  At construction the engine builds one
  :class:`~repro_torch.program.ProgramSpec` (the config → policy walk
  runs once) and one :class:`~repro_torch.program.Program` from it,
  which serves every batch-size bucket: nothing is compiled per shape
  (the reference jits one executable per bucket), so a bucket is only
  the batch size of a latent draw.  Each coalesced batch runs the
  smallest bucket that covers pending demand (the largest bucket under
  overload).
* **Copy/compute overlap on the card.**  The scheduler draws the
  batch's latents from the engine's own ``torch.Generator`` on the
  device and launches the bucket's program on the engine's compute
  stream; it records an event there, and a separate copy stream waits
  on that event and copies the output into a pinned host buffer with
  ``non_blocking=True``.  Resolving a batch waits on that copy's event
  only, and the scheduler resolves batch *k* only once batch *k+1* is
  launched (``pipeline_depth`` batches stay in flight), so batch *k*'s
  device-to-host copy can run under batch *k+1*'s kernels — what the
  reference gets from JAX's asynchronous dispatch (it does where the
  card, not the host, sets the pace).  The answers are copied out of
  the pinned buffer, which goes back to PyTorch's pinned-memory cache.
  On the CPU the program runs synchronously and the output is the host
  tensor.
* **Nothing is discarded.**  Tail samples of a bucket beyond what the
  coalesced requests asked for land in a remainder buffer and serve the
  next requests first.  The invariant is ``served + buffered +
  discarded == generated + initial spare``; ``samples_discarded`` stays
  0 except when ``close(drain=False)`` cancels requests whose samples
  were already in flight.
* **Clean shutdown.**  ``close()`` (or leaving the context manager)
  drains: queued requests are answered, then the scheduler exits.
  ``close(drain=False)`` answers what is already in flight and fails
  the rest with :class:`ServerClosed`.  A scheduler-side exception
  fails every outstanding request with that exception.  In every case
  a ``GanFuture.result()`` returns or raises — it never hangs.

Futures deliver CPU tensors (the reference delivers numpy arrays).

**On a mesh of ranks** (a program sharded over ``(data, model)``; every
bucket must divide over ``data``), every rank builds the engine with
the same arguments.  Rank 0 owns the queue and the scheduler thread:
for each batch it broadcasts ``(bucket, z)`` to the other ranks before
it runs the program, and a final stop message when it ends.  The other
ranks run a follower thread that calls ``Program.apply`` on what it
receives, in the same order, so the program's collectives pair up; the
answers come from rank 0's gathered output.  Only rank 0 takes
requests; every rank's ``close`` returns once rank 0's engine has
stopped.  If rank 0's scheduler raises, it broadcasts the stop first,
then fails its futures, so no rank is left waiting.

**Determinism.**  The sample stream is defined by ``(seed, the sequence
of batch sizes drawn)``: one latent draw per batch from one generator,
exactly like the synchronous :class:`~repro_torch.serve.gan.GanServer`.
With a single bucket equal to a ``GanServer``'s ``batch_size`` the
engine's stream is bit-identical to ``GanServer.generate`` at equal
seeds, whatever the request interleaving — requests are filled FIFO in
stream order, and each future's ``offset`` records its slice's stream
position so concurrent consumers can reassemble the sequential stream.

Metrics (labels ``engine=<id>``), as the reference names them:
``engine.requests`` / ``engine.batches`` / ``engine.samples_generated``
/ ``engine.samples_served`` / ``engine.samples_discarded`` counters,
``engine.queue_depth`` / ``engine.samples_buffered`` gauges,
``engine.batch_occupancy`` / ``engine.request_us`` histograms, plus an
``engine.request`` span per completed request (via
:func:`repro_torch.obs.emit_span` — submit and completion happen on
different threads).
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import threading
import time
from collections import deque

import torch
import torch.distributed as dist

from repro_torch import obs as _obs
from repro_torch.core.dataflow import DataflowPolicy
from repro_torch.device import platform_of, resolve_device
from repro_torch.models.gan import GanConfig
from repro_torch.program import Program, ProgramSpec
from repro_torch.program.spec import _UNSET as _MESH_UNSET
from repro_torch.sharding import collectives

__all__ = ["GanEngine", "GanFuture", "ServerClosed", "DEFAULT_BUCKETS"]

DEFAULT_BUCKETS = (1, 2, 4, 8)

# Occupancy is assigned/bucket in (0, 1] — latency buckets make no
# sense for it (same bounds the synchronous server uses).
_OCCUPANCY_BOUNDS = tuple(i / 10 for i in range(1, 11))

_ENGINE_SEQ = itertools.count()

# The leader's message to its followers: a header (_RUN, bucket) followed
# by the bucket's latents, or (_STOP, 0).
_RUN, _STOP = 1, 0


class ServerClosed(RuntimeError):
    """The engine was closed before (or while) this request could be
    served; also raised by ``submit`` after ``close``."""


class GanFuture:
    """Handle for one submitted request: blocks in :meth:`result` until
    the engine answers (samples or an error) — never hangs past
    engine shutdown."""

    __slots__ = ("n", "offset", "_chunks", "_filled", "_result",
                 "_error", "_event", "_t0", "_t1", "_t0_us")

    def __init__(self, n: int):
        self.n = int(n)
        #: stream position of this request's first sample (set when the
        #: scheduler allocates it; allocation is FIFO, so sorting
        #: completed futures by offset reassembles the sequential
        #: stream).  None until allocated.
        self.offset: int | None = None
        self._chunks: list[torch.Tensor] = []
        self._filled = 0
        self._result: torch.Tensor | None = None
        self._error: BaseException | None = None
        self._event = threading.Event()
        self._t0 = time.perf_counter()
        self._t0_us = _obs.now_us()
        self._t1: float | None = None

    @classmethod
    def settled(cls, n: int) -> "GanFuture":
        """A future already finished with no samples (``result()`` is
        ``None``): a follower rank's share of a sharded ``GanServer``
        request, which rank 0 answers."""
        fut = cls(n)
        fut._finish()
        return fut

    # -- engine side (scheduler thread, engine lock held) -------------------
    def _deliver(self, chunk: torch.Tensor) -> None:
        self._chunks.append(chunk)
        self._filled += len(chunk)
        if self._filled >= self.n:
            self._result = self._chunks[0] if len(self._chunks) == 1 \
                else torch.cat(self._chunks)
            self._chunks = []
            self._finish()

    def _fail(self, err: BaseException) -> None:
        if not self._event.is_set():
            self._error = err
            self._finish()

    def _finish(self) -> None:
        self._t1 = time.perf_counter()
        self._event.set()

    # -- caller side --------------------------------------------------------
    def done(self) -> bool:
        return self._event.is_set()

    def exception(self, timeout: float | None = None
                  ) -> BaseException | None:
        if not self._event.wait(timeout):
            raise TimeoutError(f"request for {self.n} samples not "
                               f"answered within {timeout}s")
        return self._error

    def result(self, timeout: float | None = None) -> torch.Tensor | None:
        """The ``(n, *spatial, C)`` samples as a CPU tensor (``None``
        for a :meth:`settled` future)."""
        err = self.exception(timeout)
        if err is not None:
            raise err
        return self._result

    @property
    def latency_us(self) -> float | None:
        """Submit→answer wall-clock (None while pending)."""
        if self._t1 is None:
            return None
        return (self._t1 - self._t0) * 1e6


class _Batch:
    """One dispatched bucket: its host output (the pinned buffer the
    copy stream fills on the card), the copy's completion event (None on
    the CPU), and the FIFO share list saying which request gets which
    rows at resolution."""

    __slots__ = ("size", "shares", "assigned", "host", "ready")

    def __init__(self, size: int):
        self.size = size
        self.shares: list[tuple[GanFuture, int]] = []
        self.assigned = 0
        self.host: torch.Tensor | None = None
        self.ready = None


class GanEngine:
    """Continuous-batching asynchronous server for one GAN generator on
    ``device`` (default: the card).

    Parameters mirror :class:`~repro_torch.serve.gan.GanServer` where
    they overlap; the serving-specific ones:

    ``buckets``
        The ahead-of-time batch sizes.  Each scheduled batch uses the
        smallest bucket covering coalesced pending demand (the largest
        bucket when demand exceeds it).
    ``program``
        An exported generator :class:`~repro_torch.program.Program` to
        serve; its frozen spec is served at every bucket.  Built from
        ``cfg`` when omitted; with an ``auto`` policy, ``warm_plans``
        tunes every layer's plan at construction (at the largest
        bucket), never per request.
    ``pipeline_depth``
        How many dispatched batches may be unresolved at once (≥1).
        Depth 1 already overlaps batch *k*'s device-to-host copy with
        batch *k+1*'s compute.
    ``max_pending``
        Backpressure: ``submit`` blocks while this many requests are
        queued unallocated (None = unbounded).
    ``warmup``
        Run the program once at every bucket at construction (which
        also builds the kernels) and pin the host buffers its batches will be copied
        into, so no request pays that time.
    ``key`` / ``spare``
        Advanced (used by the ``GanServer`` façade): continue the latent
        stream of an existing ``torch.Generator`` on ``device`` instead
        of seeding one with ``seed``, and seed the remainder buffer with
        already-generated samples.
    ``dtype``
        Storage-precision override ("float32"/"bfloat16"/"float16",
        aliases accepted): replaces ``cfg.dtype`` before the program
        build, and the buckets' outputs and pinned staging buffers come
        in it.  When serving an exported ``program=`` without an
        explicit override, the engine adopts the program's precision.
        Pass ``g_params=None`` with a quantized (int8-exported) program
        to serve its embedded weights.
    """

    def __init__(self, cfg: GanConfig, g_params,
                 buckets=DEFAULT_BUCKETS, *,
                 policy: DataflowPolicy | None = None, seed: int = 0,
                 warm_plans: bool = True, program: Program | None = None,
                 pipeline_depth: int = 1, max_pending: int | None = None,
                 warmup: bool = True, key: torch.Generator | None = None,
                 spare: torch.Tensor | None = None, mesh=_MESH_UNSET,
                 dtype: str | None = None,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        if dtype is not None:
            cfg = dataclasses.replace(cfg, dtype=dtype)
        if g_params is None and (program is None or not program.quantized):
            raise ValueError("g_params=None needs a quantized "
                             "program= (int8 export) to serve")
        self.cfg = cfg
        self.buckets = tuple(sorted({int(b) for b in buckets}))
        if not self.buckets or self.buckets[0] <= 0:
            raise ValueError(f"buckets must be positive ints, got "
                             f"{tuple(buckets)}")
        if int(pipeline_depth) < 1:
            raise ValueError(f"pipeline_depth must be >= 1, got "
                             f"{pipeline_depth}")
        if max_pending is not None and int(max_pending) < 1:
            raise ValueError(f"max_pending must be >= 1 or None, got "
                             f"{max_pending}")
        self.policy = policy or cfg.policy
        self.pipeline_depth = int(pipeline_depth)
        self.max_pending = None if max_pending is None \
            else int(max_pending)
        if key is None:
            key = torch.Generator(device=self.device)
            key.manual_seed(int(seed))
        self.key = key

        if program is not None:
            if program.spec.role != "generator":
                raise ValueError(f"GanEngine needs a generator program, "
                                 f"got role={program.spec.role!r}")
            if dtype is None and program.spec.dtype != cfg.dtype:
                # adopt the exported program's storage precision unless
                # the caller pinned one explicitly
                cfg = dataclasses.replace(cfg, dtype=program.spec.dtype)
                self.cfg = cfg
            expected = ProgramSpec.build(cfg, self.buckets[-1],
                                         "generator",
                                         policy=DataflowPolicy())
            if program.spec.geometry_signature() != \
                    expected.geometry_signature():
                raise ValueError(
                    f"program {program.spec.model!r} froze a different "
                    f"workload than config {cfg.name!r} builds "
                    f"(topology / z_dim / channel-scale / epilogue / "
                    f"precision drift)")
            spec = program.spec
        else:
            spec = ProgramSpec.build(cfg, self.buckets[-1], "generator",
                                     policy=self.policy,
                                     measure=warm_plans, mesh=mesh,
                                     platform=platform_of(self.device))
        self.spec = spec
        self.program = Program(spec, device=self.device,
                               differentiable=False)
        # int8-deploy flow: a quantized program carries its own
        # parameters, dequantized at load on the engine's device
        if g_params is None:
            g_params = self.program.params
        self.params = g_params
        self._devices = self.program.device_count
        self._mesh_str = self.program.mesh_str
        axes = self.program.axes
        if axes is not None:
            bad = [b for b in self.buckets if b % spec.mesh[0]]
            if bad:
                raise ValueError(
                    f"buckets {bad} do not divide over the program's "
                    f"data axis of {spec.mesh[0]} (mesh "
                    f"{self._mesh_str})")
        # on a mesh, the group rank 0 leads (None: one device)
        self._world = None if axes is None else axes.world_group
        self.leader = axes is None or dist.get_rank(self._world) == 0
        self._follow_error: BaseException | None = None

        self.engine_id = f"{cfg.name}#{next(_ENGINE_SEQ)}"
        labels = {"engine": self.engine_id}
        self._m_requests = _obs.counter("engine.requests", **labels)
        self._m_batches = _obs.counter("engine.batches", **labels)
        self._m_generated = _obs.counter("engine.samples_generated",
                                         **labels)
        self._m_served = _obs.counter("engine.samples_served", **labels)
        self._m_discarded = _obs.counter("engine.samples_discarded",
                                         **labels)
        self._m_queue = _obs.gauge("engine.queue_depth", **labels)
        self._m_buffered = _obs.gauge("engine.samples_buffered", **labels)
        self._m_request_us = _obs.histogram("engine.request_us", **labels)
        self._m_occupancy = _obs.histogram(
            "engine.batch_occupancy", bounds=_OCCUPANCY_BOUNDS, **labels)

        # the card's two streams: the programs run on `_compute` (after
        # whatever the caller's stream has queued, e.g. the parameters'
        # initialisation); `_copy` moves each output to the host
        self._compute = self._copy = None
        if self.device.type == "cuda":
            self._compute = torch.cuda.Stream(self.device)
            self._copy = torch.cuda.Stream(self.device)
            self._compute.wait_stream(torch.cuda.current_stream(self.device))

        # Shared state (producers ↔ scheduler): the queue, closed flag,
        # and futures' delivery all mutate under this lock.  The latent
        # generator, dispatch deque, and spare buffer are
        # scheduler-thread only.
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._queue: deque[GanFuture] = deque()
        self._closed = False
        self._drain = True
        self._alloc_pos = 0
        self._dispatched: deque[_Batch] = deque()
        self._spare: torch.Tensor | None = None
        self.initial_spare = 0
        if spare is not None and len(spare):
            self._spare = spare.cpu()
            self.initial_spare = len(self._spare)
            self._m_buffered.set(self.initial_spare)

        if warmup:
            staging = []
            with self._on_compute():
                for b in self.buckets:
                    out = self.program.apply(g_params, torch.zeros(
                        (b, cfg.z_dim), device=self.device))
                    if self._compute is not None:
                        # pin the staging buffers of the batches in
                        # flight now: cudaHostAlloc stalls the card, and
                        # PyTorch's pinned cache keeps them once freed
                        staging += [torch.empty(out.shape, dtype=out.dtype,
                                                pin_memory=True)
                                    for _ in range(self.pipeline_depth + 1)]
            if self._compute is not None:
                self._compute.synchronize()
            del staging

        self._thread = threading.Thread(
            target=self._run if self.leader else self._follow,
            name=f"gan-engine-{self.engine_id}", daemon=True)
        self._thread.start()

    # -- producer API -------------------------------------------------------
    def submit(self, n: int, timeout: float | None = None) -> GanFuture:
        """Enqueue a request for ``n`` samples (thread-safe, returns
        immediately once admitted).  Blocks while ``max_pending``
        requests are already waiting; raises :class:`ServerClosed` once
        the engine is closed."""
        if int(n) <= 0:
            raise ValueError(f"n must be positive, got {n}")
        if not self.leader:
            raise ValueError(
                f"engine {self.engine_id} follows rank 0's engine on its "
                f"mesh: submit on rank 0")
        fut = GanFuture(n)
        with self._cv:
            while (not self._closed and self.max_pending is not None
                   and len(self._queue) >= self.max_pending):
                if not self._cv.wait(timeout):
                    raise TimeoutError(
                        f"queue full ({self.max_pending} pending) for "
                        f"{timeout}s")
            if self._closed:
                raise ServerClosed(f"engine {self.engine_id} is closed")
            self._queue.append(fut)
            self._m_requests.inc()
            self._m_queue.set(len(self._queue))
            self._cv.notify_all()
        return fut

    def generate(self, n: int, timeout: float | None = None
                 ) -> torch.Tensor:
        """Synchronous convenience: ``submit(n).result()``."""
        return self.submit(n).result(timeout)

    def close(self, drain: bool = True,
              timeout: float | None = None) -> None:
        """Stop the engine.  ``drain=True`` (default) answers every
        queued request first; ``drain=False`` answers only requests
        whose samples are already dispatched and fails the rest with
        :class:`ServerClosed`.  Idempotent; safe from any thread.  A
        follower rank's ``close`` waits for rank 0's stop message and
        raises what its follower thread raised."""
        with self._cv:
            if not self._closed:
                self._closed = True
                self._drain = bool(drain)
            self._cv.notify_all()
        if self._thread is not threading.current_thread():
            self._thread.join(timeout)
        if self._follow_error is not None:
            raise self._follow_error

    def __enter__(self) -> "GanEngine":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        # an exception escaping the block must not hang on a full drain
        self.close(drain=exc_type is None)

    # -- accounting ---------------------------------------------------------
    @property
    def batches_served(self) -> int:
        return self._m_batches.value

    @property
    def samples_generated(self) -> int:
        return self._m_generated.value

    @property
    def samples_served(self) -> int:
        return self._m_served.value

    @property
    def samples_discarded(self) -> int:
        return self._m_discarded.value

    @property
    def samples_buffered(self) -> int:
        return 0 if self._spare is None else len(self._spare)

    @property
    def queue_depth(self) -> int:
        with self._lock:
            return len(self._queue)

    def describe(self) -> str:
        return self.spec.describe()

    def __repr__(self) -> str:
        return (f"GanEngine(model={self.cfg.name!r}, "
                f"buckets={self.buckets}, "
                f"policy={self.spec.summary()}, device={self.device}, "
                f"served={self.samples_served}, "
                f"buffered={self.samples_buffered}, "
                f"discarded={self.samples_discarded}, "
                f"closed={self._closed})")

    # -- scheduler (single thread) ------------------------------------------
    def _run(self) -> None:
        try:
            self._loop()
        except BaseException as e:   # noqa: BLE001 — must answer futures
            try:
                # the followers first: none may be left waiting on rank 0
                self._stop_followers()
            finally:
                self._fail_outstanding(e)
        else:
            self._stop_followers()
        finally:
            with self._cv:
                self._closed = True
                self._cv.notify_all()

    # -- the mesh's leader and followers -------------------------------------
    def _header(self, op: int = _RUN, size: int = 0) -> torch.Tensor:
        return torch.tensor([op, size], dtype=torch.int64,
                            device=self.device)

    def _announce(self, z: torch.Tensor) -> None:
        """Rank 0: send the next batch's bucket and latents."""
        if self._world is not None:
            collectives.broadcast(self._header(_RUN, len(z)), 0,
                                  self._world)
            collectives.broadcast(z, 0, self._world)

    def _stop_followers(self) -> None:
        if self._world is not None:
            collectives.broadcast(self._header(_STOP), 0, self._world)

    def _follow(self) -> None:
        """A follower rank: run each batch rank 0 announces until its
        stop message (an error is kept for ``close`` to raise)."""
        try:
            with self._on_compute(), torch.inference_mode():
                while True:
                    head = collectives.broadcast(self._header(), 0,
                                                 self._world)
                    op, size = (int(v) for v in head.tolist())
                    if op == _STOP:
                        return
                    z = collectives.broadcast(
                        torch.empty((size, self.cfg.z_dim),
                                    device=self.device), 0, self._world)
                    self.program.apply(self.params, z)
        except BaseException as e:   # noqa: BLE001 — close() raises it
            self._follow_error = e

    def _loop(self) -> None:
        while True:
            action = self._next_action()
            if action == "stop":
                break
            if isinstance(action, _Batch):
                self._dispatch(action)
                # overlap: wait for the oldest copy only once a newer
                # batch's compute is already in flight
                while len(self._dispatched) > self.pipeline_depth:
                    self._resolve(self._dispatched.popleft())
            else:   # "flush": no new demand — settle what's in flight
                while self._dispatched:
                    self._resolve(self._dispatched.popleft())
        # shutdown (non-drain close): requests that would need further
        # compute fail now — so their shares in still-unresolved
        # batches count as discarded — then in-flight batches settle,
        # answering every fully-dispatched request.
        with self._cv:
            for fut in list(self._queue):
                if fut.n - fut._filled - self._promised(fut) > 0:
                    fut._fail(ServerClosed(
                        f"engine {self.engine_id} closed before this "
                        f"request was scheduled"))
                    self._queue.remove(fut)
            self._m_queue.set(len(self._queue))
        while self._dispatched:
            self._resolve(self._dispatched.popleft())

    def _next_action(self):
        """Wait for work; serve the spare buffer; return the next batch
        to dispatch, ``"flush"`` to settle in-flight copies, or
        ``"stop"``."""
        with self._cv:
            while True:
                self._serve_spare_locked()
                demand = self._fill_inflight_locked()
                if demand > 0:
                    if self._closed and not self._drain:
                        return "stop"
                    return self._make_batch_locked(demand)
                if self._dispatched:
                    return "flush"
                if self._closed:
                    return "stop"
                self._cv.wait()

    def _demand_locked(self) -> int:
        return sum(f.n - f._filled - self._promised(f)
                   for f in self._queue)

    def _promised(self, fut: GanFuture) -> int:
        # samples already assigned to `fut` in unresolved batches
        return sum(c for b in self._dispatched
                   for f, c in b.shares if f is fut)

    def _serve_spare_locked(self) -> None:
        """Drain the remainder buffer into the head of the queue (no
        compute; completes small requests instantly)."""
        while self._spare is not None and len(self._spare) and \
                self._queue:
            fut = self._queue[0]
            need = fut.n - fut._filled - self._promised(fut)
            if need <= 0:
                break
            take = min(need, len(self._spare))
            self._allocate_locked(fut, take)
            self._deliver_locked(fut, self._spare[:take])
            self._spare = self._spare[take:]
            if not len(self._spare):
                self._spare = None
        self._m_buffered.set(self.samples_buffered)

    def _fill_inflight_locked(self) -> int:
        """Assign unclaimed tail capacity of dispatched batches to
        queued demand; returns the demand still uncovered."""
        for b in self._dispatched:
            for fut in list(self._queue):
                free = b.size - b.assigned
                if free <= 0:
                    break
                need = fut.n - fut._filled - self._promised(fut)
                if need <= 0:
                    continue
                take = min(free, need)
                self._allocate_locked(fut, take)
                b.shares.append((fut, take))
                b.assigned += take
        return self._demand_locked()

    def _make_batch_locked(self, demand: int) -> _Batch:
        """Coalesce queued demand into the smallest covering bucket
        (largest under overload) and pre-assign its rows FIFO."""
        size = next((b for b in self.buckets if b >= demand),
                    self.buckets[-1])
        batch = _Batch(size)
        for fut in list(self._queue):
            free = size - batch.assigned
            if free <= 0:
                break
            need = fut.n - fut._filled - self._promised(fut)
            if need <= 0:
                continue
            take = min(free, need)
            self._allocate_locked(fut, take)
            batch.shares.append((fut, take))
            batch.assigned += take
        return batch

    def _allocate_locked(self, fut: GanFuture, take: int) -> None:
        if fut.offset is None:
            fut.offset = self._alloc_pos
        self._alloc_pos += take

    def _deliver_locked(self, fut: GanFuture, chunk: torch.Tensor) -> None:
        fut._deliver(chunk)
        self._m_served.inc(len(chunk))
        if fut.done():
            if self._queue and self._queue[0] is fut:
                self._queue.popleft()
            else:                       # filled out of head position
                self._queue.remove(fut)
            self._m_queue.set(len(self._queue))
            if fut.latency_us is not None:
                self._m_request_us.observe(fut.latency_us)
            _obs.emit_span("engine.request", fut._t0_us,
                           engine=self.engine_id, n=fut.n,
                           offset=fut.offset, devices=self._devices,
                           mesh=self._mesh_str)
            self._cv.notify_all()       # backpressure: queue slot freed

    def _on_compute(self):
        return contextlib.nullcontext() if self._compute is None \
            else torch.cuda.stream(self._compute)

    def _dispatch(self, batch: _Batch) -> None:
        """Draw the batch's latents and launch its program; on the card,
        queue the output's copy to pinned host memory on the copy
        stream behind an event of the compute stream."""
        # inference mode: the program's output is an inference tensor,
        # and recording its use on the copy stream counts as updating it
        with self._on_compute(), torch.inference_mode():
            z = torch.randn((batch.size, self.cfg.z_dim),
                            generator=self.key, device=self.device)
            self._announce(z)
            out = self.program.apply(self.params, z)
            if self._compute is None:
                batch.host = out
            else:
                computed = torch.cuda.Event()
                computed.record(self._compute)
                batch.host = torch.empty(out.shape, dtype=out.dtype,
                                         pin_memory=True)
                with torch.cuda.stream(self._copy):
                    self._copy.wait_event(computed)
                    batch.host.copy_(out, non_blocking=True)
                    # the allocator must not reuse `out` before the copy
                    out.record_stream(self._copy)
                    batch.ready = torch.cuda.Event()
                    batch.ready.record(self._copy)
        self._m_generated.inc(batch.size)
        self._dispatched.append(batch)

    def _resolve(self, batch: _Batch) -> None:
        """Wait for the batch's device-to-host copy, then distribute
        rows to its shares in FIFO stream order; the unclaimed tail
        joins the remainder buffer."""
        out, batch.host = batch.host, None
        if batch.ready is not None:
            batch.ready.synchronize()
            # the answers get memory of their own, and the pinned buffer
            # goes back to PyTorch's pinned-memory cache for a later batch
            # (answers that kept it would pin new memory every batch, and
            # cudaHostAlloc stalls the card)
            out = torch.empty(out.shape, dtype=out.dtype).copy_(out)
        self._m_batches.inc()
        self._m_occupancy.observe(batch.assigned / batch.size)
        with self._cv:
            pos = 0
            for fut, count in batch.shares:
                chunk = out[pos:pos + count]
                pos += count
                if fut._event.is_set():   # cancelled mid-flight
                    self._m_discarded.inc(count)
                    continue
                self._deliver_locked(fut, chunk)
            if pos < batch.size:
                tail = out[pos:]
                self._spare = tail if self._spare is None \
                    else torch.cat([self._spare, tail])
                self._m_buffered.set(len(self._spare))

    def _fail_outstanding(self, err: BaseException) -> None:
        with self._cv:
            self._closed = True
            # nothing from an unresolved batch was delivered, so the
            # whole batch (shares and tail alike) is lost compute
            self._m_discarded.inc(sum(b.size for b in self._dispatched))
            self._dispatched.clear()
            for fut in self._queue:
                fut._fail(err)
            self._queue.clear()
            self._m_queue.set(0)
            self._cv.notify_all()
