"""The PyTorch port's copy of ``repro.obs`` against the original.

The same metric operations give equal snapshots and percentiles; the
same span records give equal trace events and summaries; the same JSONL
file gives the same CLI output; spans nest, carry errors, decorate and
honour ``REPRO_OBS`` the same way.  The device bridge
(``torchbridge.profile``) writes a Chrome trace and an ``obs.profile``
span on the CPU.
"""

import ast
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.obs as jobs
import repro_torch.obs as tobs
from repro.obs import __main__ as jcli
from repro.obs import export as jexport
from repro.obs import metrics as jmetrics
from repro_torch.obs import __main__ as tcli
from repro_torch.obs import export as texport
from repro_torch.obs import metrics as tmetrics

ROOT = Path(__file__).resolve().parent.parent


def _metric_ops(reg, seed: int) -> None:
    """One seeded sequence of counter, gauge and histogram operations."""
    rng = np.random.default_rng(seed)
    for i in range(200):
        op = rng.integers(4)
        labels = {"who": f"w{rng.integers(3)}"}
        if op == 0:
            reg.counter("c.requests", **labels).inc(int(rng.integers(5)))
        elif op == 1:
            reg.gauge("g.depth", **labels).set(float(rng.normal()))
        elif op == 2:
            reg.histogram("h.latency_us", **labels).observe(
                float(rng.lognormal(6, 2)))
        else:
            reg.histogram("h.occupancy", bounds=(0.25, 0.5, 0.75, 1.0)
                          ).observe(float(rng.uniform()))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_snapshot_and_percentiles_match(seed):
    ours, theirs = tmetrics.Registry(), jmetrics.Registry()
    _metric_ops(ours, seed)
    _metric_ops(theirs, seed)
    assert ours.snapshot() == theirs.snapshot()
    for m_t, m_j in zip(sorted(ours.metrics(), key=lambda m: (m.name, str(
            m.labels))), sorted(theirs.metrics(), key=lambda m: (
            m.name, str(m.labels)))):
        if m_t.kind == "histogram":
            for p in (0, 1, 50, 90, 99, 100):
                assert m_t.percentile(p) == m_j.percentile(p)
    assert tmetrics.DEFAULT_LATENCY_BOUNDS_US == \
        jmetrics.DEFAULT_LATENCY_BOUNDS_US


def test_metric_edge_cases_match():
    for mod in (tmetrics, jmetrics):
        h = mod.Histogram("h")
        assert math.isnan(h.percentile(50)) and math.isnan(h.mean)
        with pytest.raises(ValueError):
            h.percentile(101)
        with pytest.raises(ValueError):
            mod.Histogram("h", bounds=(2.0, 1.0))
        with pytest.raises(ValueError):
            mod.Counter("c").inc(-1)
        reg = mod.Registry()
        reg.counter("x")
        with pytest.raises(TypeError):
            reg.gauge("x")


def _records():
    """Span, event, metric and header records of both schemas."""
    recs = [{"type": "header", "pid": 7, "epoch_wall_s": 1.5}]
    rng = np.random.default_rng(3)
    t = 0.0
    for i in range(40):
        name = ("serve.generate", "program.apply", "program.layer",
                "engine.request")[i % 4]
        dur = float(rng.lognormal(4, 1))
        recs.append({"type": "span", "name": name, "ts_us": t,
                     "dur_us": dur, "tid": 1 + i % 2, "depth": i % 3,
                     "attrs": {"n": i, "layer": f"g{i % 4}"}})
        t += dur / 2
        if i % 7 == 0:
            recs.append({"type": "event", "name": "train.checkpoint",
                         "ts_us": t, "tid": 1, "attrs": {"step": i}})
    reg = jmetrics.Registry()
    _metric_ops(reg, 4)
    recs += [{"type": "metric", "kind": m.kind, "name": m.name,
              "labels": m.labels, **m.to_json()} for m in reg.metrics()]
    return recs


def test_trace_events_and_summary_match():
    recs = _records()
    ours, theirs = texport.to_trace_events(recs), \
        jexport.to_trace_events(recs)
    assert ours == theirs
    assert texport.from_trace_events(ours) == \
        jexport.from_trace_events(theirs)
    for top in (3, 20):
        assert texport.summarize(recs, top=top) == \
            jexport.summarize(recs, top=top)


def test_cli_output_matches(tmp_path, capsys):
    src = tmp_path / "run.jsonl"
    jexport.write_jsonl(_records(), src)
    outs = []
    for name, cli in (("ours", tcli), ("theirs", jcli)):
        perfetto = tmp_path / f"{name}.trace.json"
        back = tmp_path / f"{name}.jsonl"
        assert cli.main([str(src), "--perfetto", str(perfetto),
                         "--jsonl", str(back), "--top", "5"]) == 0
        text = capsys.readouterr().out
        outs.append((text.replace(name, "X"), json.loads(
            perfetto.read_text()), back.read_text()))
    assert outs[0] == outs[1]
    for cli in (tcli, jcli):
        assert cli.main([str(tmp_path / "missing.jsonl")]) == 1


def _exercise_tracer(obs):
    """Nesting, a mid-span attribute, an error, the decorator, an event
    and a cross-thread span; returns the records minus timing."""
    sink = obs.enable()
    try:
        @obs.trace("decorated", kind="fn")
        def work(x):
            return x + 1

        with obs.trace("outer", a=1) as sp:
            with obs.trace("inner"):
                work(1)
            sp.set(b=2)
        with pytest.raises(KeyError):
            with obs.trace("failing"):
                raise KeyError("x")
        obs.event("marker", step=3)
        obs.emit_span("cross", obs.now_us(), n=4)
        obs.counter("t.count").inc(2)
        obs.flush_metrics()
    finally:
        obs.disable()
    assert obs.trace("off").__enter__() is not None   # inert when off
    out = []
    for r in sink.records:
        r = {k: v for k, v in r.items() if k not in ("ts_us", "dur_us",
                                                      "tid")}
        if r["type"] == "metric" and r["name"] != "t.count":
            continue
        out.append(r)
    return out


def test_span_nesting_errors_decorator_match():
    ours = _exercise_tracer(tobs)
    theirs = _exercise_tracer(jobs)
    assert ours == theirs
    depths = {r["name"]: r["depth"] for r in ours if r["type"] == "span"}
    assert depths == {"decorated": 2, "inner": 1, "outer": 0,
                      "failing": 0, "cross": 0}
    assert any(r.get("attrs", {}).get("error") == "KeyError" for r in ours)


@pytest.mark.parametrize("value", ["1", "on", "0", "PATH"])
def test_env_opt_in_matches(tmp_path, value):
    env_value = str(tmp_path / "run.jsonl") if value == "PATH" else value
    code = ("import repro.obs as a, repro_torch.obs as b\n"
            "print([(m.is_enabled(), type(m.get_sink()).__name__)"
            " for m in (a, b)])\n")
    env = dict(os.environ, REPRO_OBS=env_value,
               PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    ours, theirs = ast.literal_eval(out.stdout.strip().splitlines()[-1])
    assert ours == theirs
    assert ours[0] is (value != "0")


def test_torch_profile_writes_a_trace_and_a_span(tmp_path):
    sink = tobs.enable()
    try:
        with tobs.profile(tmp_path / "prof"):
            with tobs.annotate("ganax.forward"):
                torch.ones(8).sum()
    finally:
        tobs.disable()
    spans = sink.spans("obs.profile")
    assert len(spans) == 1 and "error" not in spans[0]["attrs"]
    path = Path(spans[0]["attrs"]["device_trace"])
    assert path.parent == tmp_path / "prof" and path.exists()
    events = json.loads(path.read_text())["traceEvents"]
    assert any(e.get("name") == "ganax.forward" for e in events)


def test_torch_profile_failure_records_an_error(tmp_path, monkeypatch):
    def refuse(*args, **kwargs):
        raise RuntimeError("profiler busy")
    monkeypatch.setattr(torch.profiler, "profile", refuse)
    sink = tobs.enable()
    try:
        with tobs.profile(tmp_path):
            ran = True
    finally:
        tobs.disable()
    (span,) = sink.spans("obs.profile")
    assert ran and span["attrs"]["device_trace"] is False
    assert "profiler busy" in span["attrs"]["error"]
