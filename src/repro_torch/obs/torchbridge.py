"""Opt-in bridge from the obs tracer to ``torch.profiler``.

``obs.profile(outdir)`` wraps ``torch.profiler.profile`` (CPU and CUDA
activities) around a code region and writes its Chrome trace into
``outdir`` — the *device*-side timeline the host-side obs spans cannot
see: every kernel with its stream, and every host-to-device or
device-to-host copy — and emits a matching ``obs.profile`` span (with
``device_trace=`` the path written, or False) so the two traces can be
aligned.  ``obs.annotate(name)`` returns a
``torch.profiler.record_function`` naming a region on that timeline.

As the reference's ``jaxbridge``, a profiler that will not start (or
will not export) records an ``error`` attribute on the span and does
not stop the workload: observability must never take it down.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch
from torch.profiler import ProfilerActivity, record_function

from repro_torch.obs import tracer as _tracer

__all__ = ["profile", "annotate"]


def _activities() -> list:
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def profile(outdir):
    """Context manager: capture a ``torch.profiler`` trace of the region
    into ``outdir`` (``trace-<pid>-<ns>.json``, Chrome trace format:
    open it in https://ui.perfetto.dev), plus an ``obs.profile`` span on
    the obs timeline whose ``device_trace`` attribute is the file's path
    (False when no trace was written)."""
    outdir = os.fspath(outdir)
    prof, err = None, None
    try:
        os.makedirs(outdir, exist_ok=True)
        prof = torch.profiler.profile(activities=_activities())
        prof.__enter__()
    except Exception as e:    # unsupported build / profiler busy
        prof, err = None, f"{type(e).__name__}: {e}"
    span = _tracer.trace("obs.profile", outdir=outdir, device_trace=False)
    if err is not None:
        span.attrs["error"] = err
    with span:
        try:
            yield
        finally:
            if prof is not None:
                try:
                    if torch.cuda.is_available():
                        torch.cuda.synchronize()
                    prof.__exit__(None, None, None)
                    path = os.path.join(
                        outdir, f"trace-{os.getpid()}-"
                                f"{time.monotonic_ns()}.json")
                    prof.export_chrome_trace(path)
                    span.attrs["device_trace"] = path
                except Exception as e:
                    span.attrs["error"] = f"{type(e).__name__}: {e}"


def annotate(name: str):
    """A named region on the ``torch.profiler`` timeline (a
    ``record_function``; near-free when no profiler is running)."""
    return record_function(name)
