"""Autotuning planner: persistent, measured per-layer execution plans.

The port of ``repro.tune.planner``.  The :class:`Planner` owns the
mapping ``PlanKey → Plan``:

* **PlanKey** — the full layer geometry (op kind, batch, spatial sizes,
  kernel, strides, paddings, channels), the storage dtype, the platform
  (``"cpu"``, or a card's compute capability such as ``"sm_90"``:
  :func:`repro_torch.device.platform_of`) and the fused epilogue.  Two
  dispatches with the same key are the same workload.
* **Plan** — the winning port backend, its GANAX kernel route (a
  :class:`~repro_torch.kernels.ganax_conv.KernelRoute` on ``ganax``;
  ``None`` elsewhere), the measured median time (on a card the kernel
  launch's device time: :mod:`repro_torch.tune.measure`), and a
  provenance tag
  (``"measured"`` / ``"heuristic"``).  The reference's Pallas
  ``blocks`` load as data.
* **Persistence** — the reference's JSON plan file, written atomically
  after every new plan.  A corrupt file (unparseable, wrong format
  version) degrades to an empty cache and the heuristic; a stale entry
  (a key of another platform such as the reference's ``"tpu"``, an
  unknown backend, a route the kernels do not take) is dropped alone.
  The reference's backend names load mapped (``pallas-tpu`` →
  ``ganax``, ``pallas-interpret`` → ``ganax-plain``;
  :data:`~repro_torch.core.dataflow.REFERENCE_BACKENDS`), so its plan
  files load here.
* **Counters** — ``lookups`` / ``hits`` / ``measurements`` (and the
  port's ``failures``: candidates that did not run) make the contract
  testable: a second process starting from a warm plan file answers
  every ``plan()`` call with **zero** measurements.

``Planner.lookup`` is what ``backend="auto"`` calls at dispatch; it
never measures.  Measurement happens in ``Planner.plan`` / ``tune`` /
``warm``, driven by ``python -m repro_torch.tune``, an ``auto`` program
build with ``measure=True`` (``GanServer`` construction), or user code.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import math
import os
import threading
from typing import Iterable, Sequence

from repro_torch.core.dataflow import (DataflowPolicy, Epilogue,
                                       backend_supports,
                                       port_backend, valid_layer_route)
from repro_torch.device import platform_of
from repro_torch.kernels.ganax_conv import KernelRoute
from repro_torch.quant.precision import canonical_dtype

__all__ = ["PlanKey", "Plan", "Planner", "plan_key_for_op",
           "PLAN_FORMAT_VERSION"]

log = logging.getLogger(__name__)

PLAN_FORMAT_VERSION = 1

# PlanKey fields a pre-epilogue plan file of the reference omits; they
# default to the identity epilogue.
_EPILOGUE_FIELDS = ("bias", "activation", "leaky_slope")


@dataclasses.dataclass(frozen=True)
class PlanKey:
    """One tunable workload: (layer geometry, epilogue, dtype, platform),
    field for field the reference's key."""

    kind: str                       # "tconv" | "conv"
    batch: int
    in_spatial: tuple[int, ...]
    kernel: tuple[int, ...]
    strides: tuple[int, ...]
    paddings: tuple[int, ...]
    cin: int
    cout: int
    dtype: str = "float32"
    platform: str = "cpu"
    bias: bool = False
    activation: str = "none"
    leaky_slope: float = 0.2

    @property
    def nd(self) -> int:
        return len(self.in_spatial)

    @property
    def epilogue(self) -> Epilogue:
        return Epilogue(bias=self.bias, activation=self.activation,
                        leaky_slope=self.leaky_slope)

    @property
    def device(self) -> str:
        """Where this key's workload runs: ``"cpu"`` or ``"cuda"``."""
        return "cpu" if self.platform == "cpu" else "cuda"

    def describe(self) -> str:
        sp = "x".join(map(str, self.in_spatial))
        k = "x".join(map(str, self.kernel))
        s = "x".join(map(str, self.strides))
        ep = self.epilogue
        suffix = "" if ep.is_identity else f" ep[{ep.describe()}]"
        return (f"{self.kind} b{self.batch} {sp} k{k} s{s} "
                f"{self.cin}->{self.cout}{suffix} "
                f"{self.dtype}@{self.platform}")

    def to_json(self) -> dict:
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)}

    @classmethod
    def from_json(cls, d: dict) -> "PlanKey":
        names = {f.name for f in dataclasses.fields(cls)}
        required = names - set(_EPILOGUE_FIELDS)
        if not (required <= set(d) <= names):
            raise ValueError(f"bad plan key fields: {sorted(d)}")
        d = dict(d)
        for f in ("in_spatial", "kernel", "strides", "paddings"):
            d[f] = tuple(int(v) for v in d[f])
        for f in ("batch", "cin", "cout"):
            d[f] = int(d[f])
        if "bias" in d:
            d["bias"] = bool(d["bias"])
        if "leaky_slope" in d:
            d["leaky_slope"] = float(d["leaky_slope"])
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class Plan:
    """The chosen execution path for one :class:`PlanKey`: a port
    backend, its kernel ``route`` (``ganax`` only), the reference's
    Pallas ``blocks`` where a reference file carried them (data), the
    winning median time and the provenance."""

    backend: str
    blocks: tuple[int, ...] | None = None
    measured_us: float | None = None
    source: str = "measured"                    # "measured" | "heuristic"
    route: KernelRoute | None = None

    def to_json(self) -> dict:
        d = {"backend": self.backend,
             "blocks": list(self.blocks) if self.blocks else None,
             "measured_us": self.measured_us,
             "source": self.source}
        if self.route is not None:      # else the reference's format
            d["route"] = self.route.to_json()
        return d

    @classmethod
    def from_json(cls, d: dict) -> "Plan":
        """A plan of either package: the reference's backend names map
        to the port's (``ValueError`` for an unknown one)."""
        backend = d["backend"]
        if not isinstance(backend, str):
            raise ValueError(f"bad plan backend: {backend!r}")
        blocks = d.get("blocks")
        if blocks is not None:
            blocks = tuple(int(v) for v in blocks)
            if len(blocks) not in (3, 4):   # 2-D triple / 3-D quadruple
                raise ValueError(f"bad plan blocks: {blocks!r}")
        us = d.get("measured_us")
        route = d.get("route")
        return cls(backend=port_backend(backend), blocks=blocks,
                   measured_us=None if us is None else float(us),
                   source=str(d.get("source", "measured")),
                   route=None if route is None
                   else KernelRoute.from_json(route))

    def describe(self) -> str:
        route = f"[{self.route.describe()}]" if self.route else ""
        return self.backend + route


def plan_key_for_op(kind: str, x, w, strides: Sequence[int],
                    paddings: Sequence[int],
                    epilogue: Epilogue | None = None) -> PlanKey:
    """The plan key of one dispatch (only shapes, dtype and device are
    read); ``epilogue`` folds the fused bias/activation in (None =
    identity)."""
    nd = x.ndim - 2
    ep = epilogue if epilogue is not None else Epilogue()
    return PlanKey(
        kind=kind,
        batch=int(x.shape[0]),
        in_spatial=tuple(int(d) for d in x.shape[1:1 + nd]),
        kernel=tuple(int(d) for d in w.shape[:nd]),
        strides=tuple(int(s) for s in strides),
        paddings=tuple(int(p) for p in paddings),
        cin=int(w.shape[-2]),
        cout=int(w.shape[-1]),
        dtype=canonical_dtype(x.dtype),
        platform=platform_of(x.device),
        **ep.key_fields(),
    )


def _check_plan(key: PlanKey, plan: Plan) -> None:
    """Raise ``ValueError`` where ``plan`` cannot run ``key`` here: a
    platform other than the CPU's or a card's (``sm_<capability>``; the
    reference's ``"tpu"`` and ``"gpu"`` keys are stale), a rank or route
    the backend does not take."""
    if key.platform != "cpu" and not (key.platform.startswith("sm_")
                                      and key.platform[3:].isdigit()):
        raise ValueError(f"a plan of platform {key.platform!r}")
    if not backend_supports(plan.backend, key.nd):
        raise ValueError(f"backend {plan.backend!r} does not support "
                         f"{key.nd}-D")
    if plan.route is not None and (
            plan.backend != "ganax" or valid_layer_route(
                plan.route, key.kind, key.in_spatial, key.kernel,
                key.strides, key.paddings, key.cin, key.cout,
                key.dtype) is None):
        raise ValueError(f"route {plan.route.describe()} on "
                         f"{plan.backend!r} for {key.describe()}")


class Planner:
    """In-memory + JSON-persisted plan cache with measured tuning.

    ``path=None`` keeps plans in memory only.  ``backends`` restricts the
    candidate pool (default: the platform's, see
    :mod:`repro_torch.tune.candidates`); ``warmup``/``repeats`` configure
    the measurement harness; a candidate must beat the heuristic by
    ``margin`` to win.
    """

    def __init__(self, path: str | os.PathLike | None = None, *,
                 backends: Sequence[str] | None = None,
                 warmup: int = 1, repeats: int = 5,
                 margin: float = 0.1):
        self.path = os.fspath(path) if path is not None else None
        self.backends = tuple(backends) if backends is not None else None
        self.warmup = int(warmup)
        self.repeats = int(repeats)
        # measured deltas inside the margin are noise: flipping off the
        # heuristic on noise makes "tuned" randomly slower than default
        self.margin = float(margin)
        self.measurements = 0       # candidate configs actually timed
        self.failures = 0           # candidates that did not run
        self.lookups = 0
        self.hits = 0
        self.load_error: str | None = None
        self.stale_dropped = 0
        self._plans: dict[PlanKey, Plan] = {}
        self._lock = threading.RLock()
        if self.path is not None:
            self._load()

    # -- persistence --------------------------------------------------------
    def _load(self) -> None:
        if not os.path.exists(self.path):
            return
        try:
            with open(self.path) as f:
                doc = json.load(f)
            if not isinstance(doc, dict) or \
                    doc.get("version") != PLAN_FORMAT_VERSION:
                raise ValueError(
                    f"unsupported plan file version "
                    f"{doc.get('version') if isinstance(doc, dict) else doc!r}"
                    f" (want {PLAN_FORMAT_VERSION})")
            entries = doc.get("plans")
            if not isinstance(entries, list):
                raise ValueError("plan file has no 'plans' list")
        except (OSError, ValueError) as e:   # corrupt file → heuristics
            self.load_error = f"{type(e).__name__}: {e}"
            log.warning("ignoring corrupt plan file %s (%s); falling back "
                        "to heuristics", self.path, self.load_error)
            return
        for entry in entries:
            try:
                key = PlanKey.from_json(entry["key"])
                plan = Plan.from_json(entry["plan"])
                _check_plan(key, plan)
            except (KeyError, TypeError, ValueError) as e:
                self.stale_dropped += 1     # stale entry → drop this one
                log.warning("dropping stale plan entry (%s): %r", e, entry)
                continue
            self._plans[key] = plan

    def save(self) -> None:
        """Atomically write the plan file (no-op without a path)."""
        if self.path is None:
            return
        with self._lock:
            doc = {"version": PLAN_FORMAT_VERSION,
                   "plans": [{"key": k.to_json(), "plan": p.to_json()}
                             for k, p in self._plans.items()]}
        tmp = f"{self.path}.tmp.{os.getpid()}"
        os.makedirs(os.path.dirname(os.path.abspath(self.path)),
                    exist_ok=True)
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=2, sort_keys=True)
            f.write("\n")
        os.replace(tmp, self.path)

    # -- queries ------------------------------------------------------------
    def __len__(self) -> int:
        return len(self._plans)

    def lookup(self, key: PlanKey) -> Plan | None:
        """Dispatch-time consult: cached plan or None.  Never measures."""
        with self._lock:
            self.lookups += 1
            plan = self._plans.get(key)
            if plan is not None:
                self.hits += 1
            return plan

    def put(self, key: PlanKey, plan: Plan) -> None:
        """Install a plan directly (hand-written or measured elsewhere)
        and persist it."""
        with self._lock:
            self._plans[key] = plan
        self.save()

    def heuristic_plan(self, key: PlanKey) -> Plan:
        """What the static heuristic runs (not cached: a later
        ``plan()`` call can still measure)."""
        return Plan(backend=DataflowPolicy().resolve(key.nd),
                    source="heuristic")

    def plan(self, key: PlanKey, *, measure: bool = True) -> Plan:
        """The plan for ``key``: cached if known, freshly tuned when
        ``measure`` (the default), else the heuristic."""
        with self._lock:
            cached = self._plans.get(key)
            if cached is not None:
                return cached
        if not measure:
            return self.heuristic_plan(key)
        return self.tune(key)

    # -- tuning -------------------------------------------------------------
    def measure_candidates(self, key: PlanKey,
                           backends: Sequence[str] | None = None, *,
                           op_times: dict | None = None) -> dict:
        """Time every valid candidate for ``key``; ``{Candidate:
        median_seconds}``, a candidate that did not run at ``inf`` (and
        counted in ``failures``).  The timed runs are interleaved across
        candidates, so they share noise windows; ``op_times`` gets the
        whole op's time per call beside them (a report).  On a card a
        GANAX kernel candidate that does not run raises
        ``RuntimeError``: a kernel fault is never a reason to run the
        layer elsewhere."""
        from repro_torch.tune.candidates import enumerate_candidates
        from repro_torch.tune.measure import measure_candidates_interleaved
        cands = enumerate_candidates(
            key, backends=backends if backends is not None
            else self.backends)
        errors: dict = {}
        timings = measure_candidates_interleaved(
            key, cands, warmup=self.warmup, repeats=self.repeats,
            errors=errors, op_times=op_times)
        failed = [c for c, t in timings.items() if not math.isfinite(t)]
        with self._lock:
            self.measurements += len(timings) - len(failed)
            self.failures += len(failed)
        for cand in failed:
            log.warning("candidate %s failed on %s: %s", cand.describe(),
                        key.describe(), errors.get(cand))
        kernel_faults = [c for c in failed if c.backend == "ganax"]
        if key.platform != "cpu" and kernel_faults:
            raise RuntimeError(
                f"{len(kernel_faults)} GANAX kernel candidates failed on "
                f"{key.describe()}: " + "; ".join(
                    f"{c.describe()}: {errors.get(c)}"
                    for c in kernel_faults))
        return timings

    def tune(self, key: PlanKey,
             backends: Sequence[str] | None = None) -> Plan:
        """Measure the candidates and cache and persist the winner.  The
        heuristic's candidate (the first of the heuristic backend: on
        ``ganax``, ``kernel_route``'s route) loses only to one faster by
        more than ``margin``; with nothing measurable, the heuristic."""
        timings = self.measure_candidates(key, backends=backends)
        best = min(timings, key=timings.get, default=None)
        if best is None or not math.isfinite(timings[best]):
            plan = self.heuristic_plan(key)   # nothing measurable
        else:
            heur_backend = self.heuristic_plan(key).backend
            heur_cand = next((c for c in timings
                              if c.backend == heur_backend), None)
            if heur_cand is not None and \
                    math.isfinite(timings[heur_cand]) and \
                    timings[best] >= (1 - self.margin) * \
                    timings[heur_cand]:
                best = heur_cand
            plan = Plan(backend=best.backend, route=best.route,
                        measured_us=timings[best] * 1e6, source="measured")
        with self._lock:
            self._plans[key] = plan
        self.save()
        return plan

    def warm(self, keys: Iterable[PlanKey], *,
             measure: bool = True) -> dict[PlanKey, Plan]:
        """Resolve plans for many keys up front (every layer of a model
        before its first call)."""
        return {k: self.plan(k, measure=measure) for k in keys}

    def stats(self) -> dict[str, int]:
        with self._lock:
            return {"plans": len(self._plans), "lookups": self.lookups,
                    "hits": self.hits, "measurements": self.measurements,
                    "failures": self.failures,
                    "stale_dropped": self.stale_dropped}

    def __repr__(self) -> str:
        src = f"path={self.path!r}" if self.path else "in-memory"
        return (f"Planner({src}, plans={len(self._plans)}, "
                f"measurements={self.measurements})")
