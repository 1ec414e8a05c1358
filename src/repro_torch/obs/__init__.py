"""``repro_torch.obs`` — tracing and metrics for the PyTorch port.

The port's own copy of ``repro.obs`` (the port imports nothing of the
JAX package); ``tests/test_torch_obs.py`` holds it equal to the
original.  Two halves:

* **Span tracer** (:mod:`repro_torch.obs.tracer`) — ``obs.trace(name,
  **attrs)`` context manager/decorator with thread-local span stacks
  and monotonic-clock timing.  **Off by default** and near-free when
  disabled; spans are host-side only: they time what the host does
  (for CUDA work, the time to enqueue it, unless the region waits for
  the device).
* **Metrics registry** (:mod:`repro_torch.obs.metrics`) — counters,
  gauges, fixed-bucket histograms (p50/p90/p99), keyed on (name,
  labels).  Metrics are always live (cheap lock + add): ``GanServer``'s
  and ``GanEngine``'s accounting, resolution provenance and the train
  loop's step times live here; ``register_collector``/:func:`collect`
  snapshot external stat sources (copies, never aliases).

Enabling::

    REPRO_OBS=1             # in-memory sink (programmatic inspection)
    REPRO_OBS=run.jsonl     # live JSONL trace file
    obs.enable(sink=...)    # explicit: None=memory, path=JSONL, object

Reading a trace::

    python -m repro_torch.obs run.jsonl              # text summary
    python -m repro_torch.obs run.jsonl --perfetto out.trace.json
    # open out.trace.json in https://ui.perfetto.dev

``obs.profile(outdir)`` additionally captures the device-side timeline
with ``torch.profiler`` (CPU and CUDA activities) into a Chrome trace
in ``outdir``, and ``obs.annotate(name)`` names a region on it
(:mod:`repro_torch.obs.torchbridge`, the counterpart of the
reference's ``jaxbridge``).
"""

from __future__ import annotations

import os

from repro_torch.obs.export import (from_trace_events, read_records,
                              summarize, to_trace_events, write_jsonl,
                              write_trace_events)
from repro_torch.obs.torchbridge import annotate, profile
from repro_torch.obs.metrics import (DEFAULT_LATENCY_BOUNDS_US, Counter,
                               Gauge, Histogram, Registry)
from repro_torch.obs.tracer import (JsonlSink, MemorySink, Span, disable,
                              emit_span, enable, event, flush_metrics,
                              get_sink, is_enabled, now_us, registry,
                              trace)

__all__ = [
    "trace", "event", "enable", "disable", "is_enabled", "get_sink",
    "flush_metrics", "Span", "MemorySink", "JsonlSink",
    "now_us", "emit_span",
    "counter", "gauge", "histogram", "snapshot", "collect",
    "register_collector", "registry", "Registry", "Counter", "Gauge",
    "Histogram", "DEFAULT_LATENCY_BOUNDS_US",
    "to_trace_events", "from_trace_events", "read_records",
    "write_jsonl", "write_trace_events", "summarize",
    "profile", "annotate",
]


# -- module-level conveniences over the process-wide registry ---------------

def counter(name: str, **labels) -> Counter:
    return registry.counter(name, **labels)


def gauge(name: str, **labels) -> Gauge:
    return registry.gauge(name, **labels)


def histogram(name: str, bounds=None, **labels) -> Histogram:
    return registry.histogram(name, bounds=bounds, **labels)


def snapshot() -> dict:
    """Deep-copied plain-data view of every metric."""
    return registry.snapshot()


def collect() -> dict:
    """Copied stats from every registered external collector (μop
    cache, autotuning planner, ...)."""
    return registry.collect()


def register_collector(name, fn) -> None:
    registry.register_collector(name, fn)


# -- environment opt-in -----------------------------------------------------
# REPRO_OBS=1/true/yes/on → enabled with an in-memory sink;
# any other non-empty, non-zero value → live JSONL file at that path.
_env = os.environ.get("REPRO_OBS", "").strip()
if _env and _env.lower() not in ("0", "false", "no", "off"):
    enable(None if _env.lower() in ("1", "true", "yes", "on") else _env)
del _env
