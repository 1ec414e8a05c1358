"""Trace export: JSONL ↔ Chrome/Perfetto ``trace_event`` conversion and
text summaries.

Two on-disk forms, one in-memory record schema (see
:mod:`repro_torch.obs.tracer`):

* **JSONL** — one record per line, append-only (what the
  :class:`~repro_torch.obs.tracer.JsonlSink` writes live).
* **trace_event JSON** — ``{"traceEvents": [...]}``, the format
  ``chrome://tracing`` and https://ui.perfetto.dev open directly.
  Spans become complete (``"ph": "X"``) events, instant events
  ``"ph": "i"``, counters/gauges ``"ph": "C"``; histograms ride as
  instant events carrying their full bucket state in ``args``.  The
  ``cat`` field tags the record type so :func:`from_trace_events` can
  reconstruct the original records — the JSONL → trace_event → JSONL
  round trip is lossless for spans/events and pinned by tests.

:func:`read_records` sniffs the format, so ``python -m repro_torch.obs``
summarizes either file kind.
"""

from __future__ import annotations

import json
import os
from collections import defaultdict

__all__ = ["to_trace_events", "from_trace_events", "read_records",
           "write_jsonl", "write_trace_events", "summarize"]


def to_trace_events(records) -> dict:
    """Convert tracer records to a Chrome ``trace_event`` document."""
    events = []
    pid = os.getpid()
    for r in records:
        t = r.get("type")
        if t == "header":
            pid = r.get("pid", pid)
            events.append({"name": "obs_header", "ph": "i", "ts": 0,
                           "pid": pid, "tid": 0, "s": "g",
                           "cat": "obs.header",
                           "args": {k: v for k, v in r.items()
                                    if k != "type"}})
        elif t == "span":
            events.append({"name": r["name"], "ph": "X", "cat": "obs.span",
                           "ts": r["ts_us"], "dur": r["dur_us"],
                           "pid": pid, "tid": r.get("tid", 0),
                           "args": dict(r.get("attrs", {}),
                                        depth=r.get("depth", 0))})
        elif t == "event":
            events.append({"name": r["name"], "ph": "i", "cat": "obs.event",
                           "ts": r["ts_us"], "pid": pid,
                           "tid": r.get("tid", 0), "s": "t",
                           "args": dict(r.get("attrs", {}))})
        elif t == "metric":
            kind = r.get("kind", "counter")
            if kind in ("counter", "gauge"):
                events.append({"name": r["name"], "ph": "C",
                               "cat": f"obs.metric.{kind}",
                               "ts": r.get("ts_us", 0), "pid": pid,
                               "tid": 0,
                               "args": {"value": r.get("value", 0),
                                        "labels": r.get("labels", {})}})
            else:   # histogram: full state in args
                events.append({"name": r["name"], "ph": "i",
                               "cat": "obs.metric.histogram",
                               "ts": r.get("ts_us", 0), "pid": pid,
                               "tid": 0, "s": "g",
                               "args": {k: v for k, v in r.items()
                                        if k not in ("type", "kind",
                                                     "name")}})
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def from_trace_events(doc: dict) -> list[dict]:
    """Reconstruct tracer records from a ``trace_event`` document
    (inverse of :func:`to_trace_events` for obs-produced files)."""
    records = []
    for e in doc.get("traceEvents", []):
        cat = e.get("cat", "")
        if cat == "obs.header":
            records.append({"type": "header", **e.get("args", {})})
        elif cat == "obs.span" or (not cat and e.get("ph") == "X"):
            args = dict(e.get("args", {}))
            depth = args.pop("depth", 0)
            records.append({"type": "span", "name": e["name"],
                            "ts_us": e["ts"], "dur_us": e.get("dur", 0),
                            "tid": e.get("tid", 0), "depth": depth,
                            "attrs": args})
        elif cat == "obs.event" or (not cat and e.get("ph") == "i"):
            records.append({"type": "event", "name": e["name"],
                            "ts_us": e["ts"], "tid": e.get("tid", 0),
                            "attrs": dict(e.get("args", {}))})
        elif cat.startswith("obs.metric."):
            kind = cat.rsplit(".", 1)[-1]
            args = dict(e.get("args", {}))
            if kind in ("counter", "gauge"):
                records.append({"type": "metric", "kind": kind,
                                "name": e["name"],
                                "labels": args.get("labels", {}),
                                "value": args.get("value", 0)})
            else:
                records.append({"type": "metric", "kind": "histogram",
                                "name": e["name"], **args})
    return records


def read_records(path) -> list[dict]:
    """Load tracer records from a JSONL or trace_event file (format
    sniffed from the first non-space byte: ``{`` = one JSON document =
    trace_event)."""
    with open(path) as f:
        text = f.read()
    stripped = text.lstrip()
    if not stripped:
        return []
    if stripped.startswith("{") and "\n{" not in stripped.rstrip():
        try:
            doc = json.loads(stripped)
        except json.JSONDecodeError:
            doc = None      # fall through to JSONL parsing
        if isinstance(doc, dict) and "traceEvents" in doc:
            return from_trace_events(doc)
        if isinstance(doc, dict):
            return [doc]    # a one-line JSONL stream
    records = []
    for line in text.splitlines():
        line = line.strip()
        if line:
            records.append(json.loads(line))
    return records


def write_jsonl(records, path) -> None:
    with open(path, "w") as f:
        for r in records:
            f.write(json.dumps(r, default=str) + "\n")


def write_trace_events(records, path) -> None:
    with open(path, "w") as f:
        json.dump(to_trace_events(records), f, indent=1, default=str)
        f.write("\n")


def summarize(records, top: int = 20) -> str:
    """Human-readable summary: per-span-name aggregate table, event
    counts, and the metric values/percentiles in the stream."""
    spans = [r for r in records if r.get("type") == "span"]
    events = [r for r in records if r.get("type") == "event"]
    metrics = [r for r in records if r.get("type") == "metric"]
    lines = [f"{len(spans)} spans, {len(events)} events, "
             f"{len(metrics)} metrics"]

    agg = defaultdict(lambda: [0, 0.0, 0.0])    # count, total, max
    for s in spans:
        a = agg[s["name"]]
        a[0] += 1
        a[1] += s.get("dur_us", 0.0)
        a[2] = max(a[2], s.get("dur_us", 0.0))
    if agg:
        lines += ["", f"{'span':32s} {'count':>7s} {'total_ms':>10s} "
                      f"{'mean_us':>10s} {'max_us':>10s}"]
        ranked = sorted(agg.items(), key=lambda kv: -kv[1][1])[:top]
        for name, (n, tot, mx) in ranked:
            lines.append(f"{name:32s} {n:7d} {tot / 1e3:10.2f} "
                         f"{tot / n:10.1f} {mx:10.1f}")

    ev = defaultdict(int)
    for e in events:
        ev[e["name"]] += 1
    if ev:
        lines += ["", "events:"]
        for name, n in sorted(ev.items(), key=lambda kv: -kv[1])[:top]:
            lines.append(f"  {name:30s} {n}")

    if metrics:
        lines += ["", "metrics:"]
        for m in metrics:
            labels = m.get("labels") or {}
            lab = ",".join(f"{k}={v}" for k, v in sorted(labels.items()))
            qual = f"{m['name']}{{{lab}}}" if lab else m["name"]
            if m.get("kind") == "histogram":
                if m.get("count"):
                    lines.append(
                        f"  {qual:40s} count={m['count']} "
                        f"p50={m.get('p50', float('nan')):.1f} "
                        f"p90={m.get('p90', float('nan')):.1f} "
                        f"p99={m.get('p99', float('nan')):.1f}")
                else:
                    lines.append(f"  {qual:40s} count=0")
            else:
                lines.append(f"  {qual:40s} {m.get('value', 0)}")
    return "\n".join(lines)
