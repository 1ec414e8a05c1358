"""Measurement harness: timed runs of one candidate on a layer's workload.

The port of ``repro.tune.measure``.  Each candidate runs on inputs
synthesized from the :class:`~repro_torch.tune.planner.PlanKey` (timing
depends on shapes and dtypes, not values), deterministically seeded with
numpy, with the key's fused epilogue.  After ``warmup`` untimed runs
(the first builds the kernels and the μop tables), ``repeats`` timed
runs give the **median**.

What is timed is what the choice changes.  On the CPU (the reference's
pool) the whole fused op on the host clock.  On the card a ``ganax``
candidate's kernel launch on operands built once (the pad and the tap
gather are the same for every route), as the device runs
``KERNEL_WINDOW`` launches back to back: CUDA events around them,
enqueued while the device sleeps so that the host's time to issue them
is left out, then a synchronize before the elapsed time is read.  The
whole op per call (CUDA events around one call, host gaps included) is
timed beside it as a report (``op_times=``), never ranked.  An oracle
named by ``backends=`` is timed as a whole op in the same windows.
Measurement happens only where the planner tunes (``plan``, ``tune``,
``warm``), never on the dispatch path.
"""

from __future__ import annotations

import statistics
import time
import zlib

import numpy as np
import torch

from repro_torch import obs as _obs
from repro_torch.core.dataflow import conv as df_conv
from repro_torch.core.dataflow import tconv as df_tconv
from repro_torch.kernels import ops
from repro_torch.quant.precision import storage_dtype
from repro_torch.tune.candidates import Candidate
from repro_torch.tune.planner import PlanKey

__all__ = ["synthesize_inputs", "synthesize_bias", "measure_candidate",
           "measure_candidates_interleaved", "time_fn",
           "time_interleaved", "candidate_fn", "ranked_thunk",
           "KERNEL_WINDOW"]

# Back-to-back calls per timed sample on the card
KERNEL_WINDOW = 5
# The device's sleep ahead of a window, in cycles (about 2 ms), and how
# often it is lengthened (4x each time) while the host is slower
_SLEEP_CYCLES = 1 << 22
_SLEEP_TRIES = 6


def _seed(key: PlanKey) -> int:
    return zlib.crc32(key.describe().encode())


def synthesize_inputs(key: PlanKey) -> tuple[torch.Tensor, torch.Tensor]:
    """Deterministic random (x, w) with the key's shapes and storage
    dtype, on the key's device (the card for an ``sm_*`` key)."""
    rng = np.random.default_rng(_seed(key))
    dtype = storage_dtype(key.dtype)
    x = torch.from_numpy(rng.normal(
        size=(key.batch, *key.in_spatial, key.cin)).astype(np.float32))
    w = torch.from_numpy(rng.normal(
        size=(*key.kernel, key.cin, key.cout)).astype(np.float32))
    return x.to(key.device, dtype), w.to(key.device, dtype)


def synthesize_bias(key: PlanKey) -> torch.Tensor | None:
    """Deterministic random f32 bias for keys whose epilogue carries one
    (None otherwise): timing must run the fused bias path."""
    if not key.bias:
        return None
    rng = np.random.default_rng(_seed(key) + 1)
    return torch.from_numpy(rng.normal(size=(key.cout,)).astype(
        np.float32)).to(key.device)


def _is_cuda(device) -> bool:
    return device is not None and torch.device(device).type == "cuda"


def _timed(thunk, device) -> float:
    """Seconds of one run of ``thunk``, finished on its device."""
    if _is_cuda(device):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        thunk()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    thunk()
    return time.perf_counter() - t0


def _device_window(thunk, calls: int) -> float:
    """Seconds per call of ``thunk`` as the card runs ``calls`` of them
    back to back: CUDA events around them, enqueued behind a device
    sleep (``torch.cuda._sleep``) so that the host's time to issue them
    is not in the window; a window the device reached before the host
    had issued every call is taken again behind a longer sleep."""
    cycles = _SLEEP_CYCLES
    for _ in range(_SLEEP_TRIES):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(calls):
            thunk()
        end.record()
        reached = start.query()
        end.synchronize()
        if not reached:
            return start.elapsed_time(end) / 1e3 / calls
        cycles *= 4
    raise RuntimeError("the host issued the timed calls too slowly to time "
                       "them on the device")


def _finish(device) -> None:
    if _is_cuda(device):
        torch.cuda.synchronize(device)


def time_fn(fn, *args, warmup: int = 1, repeats: int = 5) -> float:
    """Median seconds of ``fn(*args)`` over ``repeats`` timed runs after
    ``warmup`` untimed ones, on the device of the first tensor argument
    (CUDA events there, the host clock on the CPU)."""
    device = next((a.device for a in args if isinstance(a, torch.Tensor)),
                  None)
    for _ in range(max(1, warmup)):
        fn(*args)
    _finish(device)
    return statistics.median(_timed(lambda: fn(*args), device)
                             for _ in range(max(1, repeats)))


def time_interleaved(thunks, *, warmup: int = 1, repeats: int = 5,
                     reduce: str = "median", device=None,
                     window: int = 0) -> list[float]:
    """Seconds per thunk, with the timed runs interleaved round-robin
    (A,B,C,A,B,C,…) and the start position rotated per round, so that
    competing configurations share every noise window and whoever runs
    first in a round does not always pay the cold caches.  ``device``:
    a CUDA device times with events, else the host clock.  ``window``:
    on a CUDA device, > 0 times each run as the device runs ``window``
    calls back to back (the host's time to issue them left out); 0 times
    one call on the device's clock, host gaps included.  ``reduce``:
    ``"median"`` (the representative cost, for ranking) or ``"min"``
    (the noise floor)."""
    if reduce not in ("median", "min"):
        raise ValueError(f"unknown reduce {reduce!r}")
    for th in thunks:
        for _ in range(warmup):
            th()
    _finish(device)
    if window > 0 and _is_cuda(device):
        def timed(th):
            return _device_window(th, window)
    else:
        def timed(th):
            return _timed(th, device)
    times: list[list[float]] = [[] for _ in thunks]
    for r in range(max(1, repeats)):
        for i in range(len(thunks)):
            j = (r + i) % len(thunks)
            times[j].append(timed(thunks[j]))
    agg = min if reduce == "min" else statistics.median
    return [agg(t) for t in times]


def candidate_fn(key: PlanKey, cand: Candidate):
    """The forward op of one candidate, ``fn(x, w)``: the key's op,
    strides, paddings and fused epilogue (a synthesized bias) on the
    candidate's backend and route, under ``torch.inference_mode``."""
    op = df_tconv if key.kind == "tconv" else df_conv
    epilogue = key.epilogue
    bias = synthesize_bias(key)

    def run(x, w):
        with torch.inference_mode():
            return op(x, w, key.strides, key.paddings, backend=cand.backend,
                      route=cand.route, bias=bias, epilogue=epilogue)

    return run


def measure_candidate(key: PlanKey, cand: Candidate, *,
                      warmup: int = 1, repeats: int = 5) -> float:
    """Median seconds per call of what the planner ranks for ``cand`` on
    ``key``'s workload (:func:`ranked_thunk`, timed as
    :func:`measure_candidates_interleaved` times it).  Raises where the
    candidate does not run."""
    x, w = synthesize_inputs(key)
    with _obs.trace("tune.measure", kind=key.kind,
                    backend=cand.backend, candidates=1):
        t = time_interleaved([ranked_thunk(key, cand, x, w)],
                             warmup=max(1, warmup), repeats=repeats,
                             device=x.device, window=KERNEL_WINDOW)[0]
    _obs.counter("tune.measurements").inc()
    _obs.event("tune.candidate", backend=cand.backend,
               route=cand.route.describe() if cand.route else None,
               us=t * 1e6)
    return t


def ranked_thunk(key: PlanKey, cand: Candidate, x, w):
    """What the planner ranks for ``cand``, a thunk over ``x, w``: on the
    card, a ``ganax`` candidate's kernel launch on operands built here
    once (its route is all that differs between the kernel's
    candidates); else the whole fused op."""
    if cand.backend != "ganax" or not x.is_cuda:
        fn = candidate_fn(key, cand)
        return lambda: fn(x, w)
    bias = synthesize_bias(key)
    with torch.inference_mode():
        operands = ops.kernel_operands(x, w, key.strides, key.paddings,
                                       transposed=key.kind == "tconv")

    def launch():
        with torch.inference_mode():
            return ops.launch_kernel(operands, key.epilogue, bias, False,
                                     cand.route)
    return launch


def measure_candidates_interleaved(key: PlanKey,
                                   cands: list[Candidate], *,
                                   warmup: int = 1, repeats: int = 5,
                                   errors: dict | None = None,
                                   op_times: dict | None = None
                                   ) -> dict[Candidate, float]:
    """Median seconds per call of each candidate through
    :func:`time_interleaved`, of what the choice changes
    (:func:`ranked_thunk`; on the card ``KERNEL_WINDOW`` calls back to
    back on the device's clock).  A candidate that fails its warm-up
    runs (raises) gets ``inf``, its error in ``errors``, and is left out
    of the timed rounds.  ``op_times``, where given, gets each measured
    candidate's whole fused op per call (a report: on the CPU the
    ranked time itself)."""
    x, w = synthesize_inputs(key)
    cuda = _is_cuda(x.device)
    with _obs.trace("tune.measure", kind=key.kind,
                    candidates=len(cands)) as sp:
        good: list[Candidate] = []
        ranked, whole = [], []
        for cand in cands:
            fn = candidate_fn(key, cand)
            try:
                for _ in range(max(1, warmup)):   # a failure drops only
                    fn(x, w)                      # this candidate
                th = ranked_thunk(key, cand, x, w)
                th()
                _finish(x.device)
            except (RuntimeError, ValueError, NotImplementedError) as e:
                error = f"{type(e).__name__}: {e}"
                if errors is not None:
                    errors[cand] = error
                _obs.event("tune.candidate_failed", backend=cand.backend,
                           route=cand.route.describe() if cand.route
                           else None, error=error)
                continue
            good.append(cand)
            ranked.append(th)
            whole.append(lambda fn=fn: fn(x, w))
        out = {c: float("inf") for c in cands}
        timings = time_interleaved(ranked, warmup=0, repeats=repeats,
                                   device=x.device,
                                   window=KERNEL_WINDOW if cuda else 0)
        out.update(zip(good, timings))
        op = timings
        if op_times is not None:
            if cuda:
                op = time_interleaved(whole, warmup=0, repeats=repeats,
                                      device=x.device)
            op_times.update(zip(good, op))
        sp.set(measured=len(good), skipped=len(cands) - len(good))
    _obs.counter("tune.measurements").inc(len(good))
    _obs.counter("tune.measurements_skipped").inc(len(cands) - len(good))
    for cand, t, t_op in zip(good, timings, op):
        _obs.event("tune.candidate", backend=cand.backend,
                   route=cand.route.describe() if cand.route else None,
                   us=t * 1e6, op_us=t_op * 1e6)
    return out
