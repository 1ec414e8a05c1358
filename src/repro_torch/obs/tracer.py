"""Span tracer: thread-local span stacks, monotonic timing, sinks.

The tracer is **off by default** and near-free when disabled:
``is_enabled()`` is one module-global read, and every instrumentation
site in the port checks it (or calls :func:`trace`, whose ``__enter__``
is a single flag check) before formatting any attribute.  Spans are
host-side only: a span around CUDA work measures the host's time to
enqueue it unless the region waits for the device
(:func:`repro_torch.obs.profile` records the device's own timeline).

Enable with :func:`enable` (``sink=None`` → in-memory,
``sink="path.jsonl"`` → JSONL file, or any object with
``write_record``/``flush``), or via the environment:
``REPRO_OBS=1`` enables with an in-memory sink, any other non-empty
value is treated as a JSONL output path (handled in
``repro_torch.obs.__init__``).  On process exit (or :func:`disable(flush=
True)`) the metrics registry is flushed into the sink as ``metric``
records, so a trace file carries both the spans and the
counters/histograms that accumulated alongside them.

Record schema (plain dicts, one JSON object per JSONL line):

* span   — ``{"type": "span", "name", "ts_us", "dur_us", "tid",
  "depth", "attrs"}``
* event  — ``{"type": "event", "name", "ts_us", "tid", "attrs"}``
  (instant, zero duration)
* metric — ``{"type": "metric", "kind", "name", "labels", ...values}``

``ts_us`` is microseconds on the process-wide monotonic clock, origin
at module import (``epoch_wall_s`` in the stream header maps it to
wall time).
"""

from __future__ import annotations

import atexit
import functools
import json
import os
import threading
import time
from typing import Callable

from repro_torch.obs.metrics import Registry

__all__ = ["trace", "event", "enable", "disable", "is_enabled",
           "get_sink", "MemorySink", "JsonlSink", "Span", "registry",
           "flush_metrics", "now_us", "emit_span"]

_EPOCH_NS = time.perf_counter_ns()
_EPOCH_WALL_S = time.time()

registry = Registry()

_enabled = False
_sink = None
_state = threading.local()          # per-thread span stack
_lock = threading.Lock()


def _now_us() -> float:
    return (time.perf_counter_ns() - _EPOCH_NS) / 1e3


def is_enabled() -> bool:
    """The module-level enabled flag — check this before formatting
    span attributes on a hot path."""
    return _enabled


def _stack() -> list:
    s = getattr(_state, "stack", None)
    if s is None:
        s = _state.stack = []
    return s


# ---------------------------------------------------------------------------
# Sinks.
# ---------------------------------------------------------------------------

class MemorySink:
    """Record-list sink (tests, programmatic inspection)."""

    def __init__(self):
        self.records: list[dict] = []
        self._lock = threading.Lock()

    def write_record(self, record: dict) -> None:
        with self._lock:
            self.records.append(record)

    def flush(self) -> None:
        pass

    def spans(self, name: str | None = None) -> list[dict]:
        with self._lock:
            return [r for r in self.records if r["type"] == "span"
                    and (name is None or r["name"] == name)]

    def events(self, name: str | None = None) -> list[dict]:
        with self._lock:
            return [r for r in self.records if r["type"] == "event"
                    and (name is None or r["name"] == name)]

    def __len__(self) -> int:
        return len(self.records)


class JsonlSink:
    """One JSON object per line, appended as spans close.  The first
    line is a stream header carrying the monotonic→wall mapping."""

    def __init__(self, path):
        self.path = os.fspath(path)
        self._lock = threading.Lock()
        parent = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(parent, exist_ok=True)
        self._f = open(self.path, "w")
        self.write_record({"type": "header", "pid": os.getpid(),
                           "epoch_wall_s": _EPOCH_WALL_S})

    def write_record(self, record: dict) -> None:
        line = json.dumps(record, default=str)
        with self._lock:
            self._f.write(line + "\n")

    def flush(self) -> None:
        with self._lock:
            self._f.flush()

    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.flush()
                self._f.close()


def _emit(record: dict) -> None:
    sink = _sink
    if sink is not None:
        sink.write_record(record)


# ---------------------------------------------------------------------------
# Spans.
# ---------------------------------------------------------------------------

class Span:
    """One ``with obs.trace(...)`` region — usable as a context manager
    or a decorator.  When tracing is disabled at ``__enter__`` time the
    span is inert: no clock read, no stack push, no sink write."""

    __slots__ = ("name", "attrs", "_t0_us", "_depth", "_active")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs
        self._active = False

    def set(self, **attrs) -> "Span":
        """Attach attributes discovered mid-span (no-op when inert)."""
        if self._active:
            self.attrs.update(attrs)
        return self

    def __enter__(self) -> "Span":
        if not _enabled:
            return self
        self._active = True
        stack = _stack()
        self._depth = len(stack)
        stack.append(self)
        self._t0_us = _now_us()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if not self._active:
            return
        t1 = _now_us()
        self._active = False
        stack = _stack()
        # tolerate exits out of order (generator-based callers): pop
        # through to this span
        while stack and stack[-1] is not self:
            stack.pop()
        if stack:
            stack.pop()
        if exc_type is not None:
            self.attrs["error"] = exc_type.__name__
        if _enabled:
            _emit({"type": "span", "name": self.name,
                   "ts_us": self._t0_us, "dur_us": t1 - self._t0_us,
                   "tid": threading.get_ident(), "depth": self._depth,
                   "attrs": self.attrs})

    def __call__(self, fn: Callable) -> Callable:
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not _enabled:
                return fn(*args, **kwargs)
            with Span(self.name, dict(self.attrs)):
                return fn(*args, **kwargs)
        return wrapper


def trace(name: str, **attrs) -> Span:
    """Open a span: ``with obs.trace("serve.generate", n=n): ...`` or
    ``@obs.trace("tune.measure")``.  Near-free when disabled — prefer
    guarding attribute *formatting* (f-strings, ``describe()`` calls)
    behind :func:`is_enabled` at hot call sites."""
    return Span(name, attrs)


def now_us() -> float:
    """Microseconds on the tracer's process-wide monotonic clock — the
    timebase of every span/event ``ts_us``.  Use with :func:`emit_span`
    to stamp region boundaries that close on a different thread."""
    return _now_us()


def emit_span(name: str, start_us: float, end_us: float | None = None,
              **attrs) -> None:
    """Emit an already-completed span record directly.

    The context-manager form (:func:`trace`) keeps a *thread-local*
    span stack, so it cannot express a region whose start and end
    happen on different threads — e.g. a serving request's
    submit→response lifetime, opened on a producer thread and closed by
    the scheduler.  ``emit_span`` takes explicit boundaries instead
    (``start_us`` from :func:`now_us`; ``end_us`` defaults to now) and
    writes the span at depth 0 on the emitting thread.  No-op when
    disabled."""
    if not _enabled:
        return
    if end_us is None:
        end_us = _now_us()
    _emit({"type": "span", "name": name, "ts_us": float(start_us),
           "dur_us": float(end_us) - float(start_us),
           "tid": threading.get_ident(), "depth": 0, "attrs": attrs})


def event(name: str, **attrs) -> None:
    """Emit an instant (zero-duration) record — checkpoint saved,
    straggler detected, candidate measured.  No-op when disabled."""
    if not _enabled:
        return
    _emit({"type": "event", "name": name, "ts_us": _now_us(),
           "tid": threading.get_ident(), "attrs": attrs})


def current_depth() -> int:
    """Depth of the calling thread's open-span stack (testing aid)."""
    return len(_stack())


# ---------------------------------------------------------------------------
# Enable / disable.
# ---------------------------------------------------------------------------

def enable(sink=None):
    """Turn tracing on.  ``sink``: None → fresh :class:`MemorySink`, a
    str/PathLike → :class:`JsonlSink` at that path, else any object
    with ``write_record(dict)`` / ``flush()``.  Returns the sink."""
    global _enabled, _sink
    with _lock:
        if sink is None:
            sink = MemorySink()
        elif isinstance(sink, (str, os.PathLike)):
            sink = JsonlSink(sink)
        _sink = sink
        _enabled = True
    return sink


def disable(flush: bool = False):
    """Turn tracing off.  ``flush=True`` writes the metrics registry
    into the sink first (the end-of-run dump); the default leaves the
    sink untouched so a disabled process provably writes nothing."""
    global _enabled, _sink
    with _lock:
        sink, _enabled = _sink, False
        if flush and sink is not None:
            _flush_metrics_into(sink)
            sink.flush()
        _sink = None
    return sink


def get_sink():
    return _sink


def _flush_metrics_into(sink) -> None:
    for m in registry.metrics():
        sink.write_record({"type": "metric", "kind": m.kind,
                           "name": m.name, "labels": m.labels,
                           **m.to_json()})


def flush_metrics() -> None:
    """Write the current metrics registry into the active sink as
    ``metric`` records (no-op when disabled)."""
    if _enabled and _sink is not None:
        _flush_metrics_into(_sink)
        _sink.flush()


def _atexit_flush() -> None:
    if _enabled and _sink is not None:
        flush_metrics()
        close = getattr(_sink, "close", None)
        if close is not None:
            close()


atexit.register(_atexit_flush)
