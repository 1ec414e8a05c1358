"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--out FILE]

Builds every CUDA kernel of the port from the sources in this checkout,
holds each kernel against its plain PyTorch version on the card, drives
the port's serving paths through ``GanServer.generate`` (random weights
from a seed): the full-width DCGAN generator through the planar kernel
and the full-width 3D-GAN generator through the volumetric one, and
checks the outputs and the launch counts of each path; then times each
layer's kernel beside its bound, its plain version, the whole op and one
library call, and each generator forward.  The training phases hold
every launch geometry of an adversarial step (the discriminators' convs
and every layer's ``dx``) against the plain version and time it beside
its ``dw`` contraction; drive full-width DCGAN training through the
quickstart entry point (``TrainLoop``, a checkpoint, 40 kernel launches
a step) and 3D-GAN training through the same code; hold one step's
losses and gradients against the same step through ``ganax-plain``; and
time and profile the D and G steps.  It imports nothing of JAX and
nothing of the JAX package.

The line before the last is a JSON object listing every kernel; the
last line is ``{"ok": true, "device": {...}}``.  Any failed phase exits
non-zero and prints no result; so does a machine without a CUDA card.
``--out`` also writes the whole record (per-layer times included) as
JSON.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent

# Published peaks of one H100 SXM (data sheet): FP32 outside the tensor
# cores, and HBM3 bandwidth.  The bound of a launch is the larger of its
# operations over the first and its bytes over the second.
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

BATCH = 64
# f32 against f32: the sums run in another order over K <= 16·1024
# terms, so a few ulps of the largest partial sums.
ATOL = RTOL = 1e-4

# name -> (source, the TPU kernel it replaces)
KERNELS = {
    "ganax_conv": ("src/repro_torch/kernels/csrc/ganax_conv.cu",
                   "src/repro/kernels/ganax_conv.py:99"),
    "ganax_conv3d": ("src/repro_torch/kernels/csrc/ganax_conv3d.cu",
                     "src/repro/kernels/ganax_conv.py:215"),
}
# the requests each serving path answers
REQUESTS = (64, 100, 37)
# the training paths: DCGAN steps through the quickstart entry point,
# 3D-GAN steps through the same training code
TRAIN_STEPS = 6
TRAIN3D_STEPS = 2
# kernel launches of one adversarial step: the D step runs G (4), D(real)
# and D(fake) (5 + 5), and the dx of d2-d5 of each (4 + 4; the reals and
# the no-grad fakes need no dx at d1); the G step runs G (4) and D(fake)
# (5), and the dx of d1-d5 (5) and of g1-g4 (4)
LAUNCHES_PER_STEP = 40
# one step's gradients through the kernel against the same step through
# ganax-plain: ||a - b|| <= GRAD_TOL * ||b|| per tensor.  A norm and not
# each element, because ReLU and LeakyReLU change slope at 0: the kernel
# and the plain version sum in another order, so an output within a few
# ulps of 0 can take one slope in one step and the other in the other,
# and such knife-edge elements move the gradients downstream of them by
# O(1) locally (on the card: one DCGAN step's g.proj_w off by 1.5e-3 in
# norm).
# The step through the polyphase oracle (cuDNN convs, a third summation
# order, no GANAX kernel) against ganax-plain is printed beside it as the
# control: what another f32 order alone does.  A missing tap or a wrong
# offset moves a gradient by several percent.
GRAD_TOL = 1e-2
# the same step's losses: |a - b| <= LOSS_TOL * max(1, |b|)
LOSS_TOL = 1e-4
# the autograd Function's profiler labels (core/dataflow.py)
RANGES = ("ganax.forward", "ganax.dx", "ganax.dw")


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, warmup: int = 3, runs: int = 15) -> float:
    """Median CUDA-event time of ``fn()`` in ms."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def q_sizes(operands: dict) -> tuple[int, ...]:
    """The phase grid of one launch's operands: (qy, qx) or (qz, qy, qx)."""
    return tuple(operands[k] for k in ("qz", "qy", "qx") if k in operands)


def bound(operands: dict, bias) -> tuple[float, str, float, int]:
    """(bound ms, what bounds it, flops, bytes) of one kernel launch, 2-D
    or 3-D: each input read once and the output written once; the
    operations the tap tables of this geometry need (2 per consequential
    MAC)."""
    x_pad, w_taps = operands["x_pad"], operands["w_taps"]
    b, cin = x_pad.shape[0], x_pad.shape[-1]
    p, _, _, cout = w_taps.shape
    q = math.prod(q_sizes(operands))
    taps = sum(len(ph) for ph in operands["tables"].taps)
    flops = 2.0 * b * q * taps * cin * cout
    out_elems = b * p * q * cout
    tables = operands["tables"]
    nbytes = 4 * (x_pad.numel() + w_taps.numel() + out_elems
                  + (bias.numel() if bias is not None else 0)) \
        + 4 * (tables.n_taps.numel()
               + sum(o.numel() for o in tables.offsets))
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes
            else "bytes", flops, nbytes)


def profile(fn, runs: int, what: str) -> dict:
    """Device time by kernel over ``runs`` calls of ``fn`` (torch.profiler),
    the span on the device's timeline of each training range of
    ``RANGES`` (the kernel backends' autograd Function labels its
    forward, ``dx`` and ``dw``; a span includes the device's idle gaps
    inside it), and the share of the wall time the device was busy.
    Prints the breakdown; returns it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name, ranges = {}, {}
    for evt in prof.key_averages():
        # kernels only: an operator's row repeats its kernels' time, and
        # a range's device-side row spans the kernels inside it
        if evt.device_type != DeviceType.CUDA:
            continue
        if evt.key in RANGES:
            ranges[evt.key] = evt.self_device_time_total / 1e3 / runs
        else:
            by_name[evt.key] = (by_name.get(evt.key, 0.0)
                                + evt.self_device_time_total / 1e3)
    device_ms = sum(by_name.values())
    if device_ms == 0:
        print(f"profile of {what}: the profiler saw no device time "
              f"(not measured)")
        return {"wall_ms_per_run": wall_ms / runs, "device": None}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    short = {}      # kernels whose names share 80 characters add up
    for k, v in top:
        short[k[:80]] = short.get(k[:80], 0.0) + v / runs
    out = {"wall_ms_per_run": wall_ms / runs,
           "device_ms_per_run": device_ms / runs,
           "device_busy_share": device_ms / wall_ms,
           "kernels_ms_per_run": short,
           "range_spans_ms_per_run": ranges}
    print(f"profile over {runs} {what}: wall {wall_ms / runs:.4f} ms/run, "
          f"device busy {device_ms / runs:.4f} ms/run "
          f"({100 * device_ms / wall_ms:.1f}% of the wall time)")
    for name, ms in top[:8]:
        print(f"  {ms / runs:9.4f} ms/run  {name[:90]}")
    for name, ms in ranges.items():
        print(f"  {ms:9.4f} ms/run  device-timeline span of {name}")
    return out


def max_err(got: torch.Tensor, ref: torch.Tensor) -> tuple[float, bool]:
    err = (got - ref).abs().max().item()
    ok = bool(torch.allclose(got, ref, atol=ATOL, rtol=RTOL))
    return err, ok


def library_conv_transpose(x, w, b, s, p):
    """One cuDNN transposed conv on channels-first tensors (TF32 off): a
    yardstick the port never calls."""
    nd = x.ndim - 2
    fn = F.conv_transpose2d if nd == 2 else F.conv_transpose3d
    xn = x.movedim(-1, 1).contiguous()
    wn = w.permute(nd, nd + 1, *range(nd)).contiguous()  # (Cin, Cout, K...)
    return lambda: fn(xn, wn, b, stride=s, padding=p)


def library_conv(x, w, b, s, p):
    """One cuDNN conv on channels-first tensors (TF32 off), the
    yardstick of a kernel launch in SIMD mode."""
    nd = x.ndim - 2
    fn = F.conv2d if nd == 2 else F.conv3d
    xn = x.movedim(-1, 1).contiguous()
    wn = w.permute(nd + 1, nd, *range(nd)).contiguous()  # (Cout, Cin, K...)
    return lambda: fn(xn, wn, b, stride=s, padding=p)


def train_cases(model: str, g_layers, d_layers) -> list[tuple]:
    """Every kernel launch geometry of one adversarial step at batch
    ``BATCH``: (label, part, transposed, x shape, w shape, strides,
    paddings, epilogue, kernel launches per step, dw contractions per
    step).  A layer's ``dx`` is the adjoint op on its output's
    cotangent with swapped weights: a conv for a tconv layer, an
    uncropped pad-0 tconv for a conv layer."""
    from repro_torch.core.dataflow import Epilogue
    from repro_torch.models.gan import (discriminator_epilogues,
                                        generator_epilogues)
    cases = []
    for l, ep in zip(g_layers, generator_epilogues(g_layers)):
        out = tuple((n - 1) * s + k - 2 * p for n, k, s, p in
                    zip(l.in_spatial, l.kernel, l.strides, l.paddings))
        cases += [
            (f"{model} {l.name}", "forward", True,
             (BATCH, *l.in_spatial, l.cin), (*l.kernel, l.cin, l.cout),
             l.strides, l.paddings, ep, 2, 1),
            (f"{model} {l.name} dx", "dx", False, (BATCH, *out, l.cout),
             (*l.kernel, l.cout, l.cin), l.strides, l.paddings, Epilogue(),
             1, 0)]
    for i, (l, ep) in enumerate(zip(d_layers,
                                    discriminator_epilogues(d_layers))):
        check(not l.transposed, f"{model} {l.name} is not a conv")
        q = tuple((n + 2 * p - k) // s + 1 for n, k, s, p in
                  zip(l.in_spatial, l.kernel, l.strides, l.paddings))
        cases += [
            (f"{model} {l.name}", "forward", False,
             (BATCH, *l.in_spatial, l.cin), (*l.kernel, l.cin, l.cout),
             l.strides, l.paddings, ep, 3, 2),
            (f"{model} {l.name} dx", "dx", True, (BATCH, *q, l.cout),
             (*l.kernel, l.cout, l.cin), l.strides, (0,) * len(q),
             Epilogue(), 1 if i == 0 else 3, 0)]
    return cases


def train_geometries(card, dev, wrappers, kernel_errs) -> dict:
    """Each launch geometry of the train step, kernel against plain on
    the card, then timed beside its bound, its plain version, the whole
    op and one cuDNN call of the same geometry, with the layer's dw
    contraction; returns the rows by kernel name."""
    from repro_torch.configs.gans import GAN_MODELS
    from repro_torch.core import dataflow as tdf
    from repro_torch.kernels import ops
    gen = torch.Generator().manual_seed(4321)

    def rand(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=gen)).to(dev)

    rows = {}
    for name, model in (("ganax_conv", "dcgan"), ("ganax_conv3d", "3dgan")):
        kernel, plain = wrappers[name]
        timing = dict(warmup=3, runs=15) if name == "ganax_conv" \
            else dict(warmup=1, runs=5)
        rows[name] = []
        for (label, part, tr, xs, ws, s, p, ep, launches,
             dw_launches) in train_cases(model, *GAN_MODELS[model]):
            nd = len(s)
            x = rand(*xs)
            w = rand(*ws, scale=(math.prod(ws[:nd]) * ws[-2]) ** -0.5)
            b = rand(ws[-1], scale=0.1) if ep.bias else None
            act = ep.activation
            with torch.no_grad():
                operands = ops.kernel_operands(x, w, s, p, transposed=tr)
                got = kernel(**operands, bias=b, activation=act,
                             leaky_slope=ep.leaky_slope)
                ref = plain(**operands, bias=b, activation=act,
                            leaky_slope=ep.leaky_slope)
                torch.cuda.synchronize()
                err, ok = max_err(got, ref)
                kernel_errs[name].append(err)
                print(f"{name} vs plain  {label:18s} x {tuple(xs)} "
                      f"max_abs_err {err:.3e} (atol=rtol={ATOL:g}) "
                      f"{'ok' if ok else 'FAIL'}")
                check(ok and bool(torch.isfinite(got).all()),
                      f"{label}: {name} disagrees with its plain version")
                del got, ref
                op = ops.ganax_conv_transpose if tr else ops.ganax_conv
                ms = time_ms(lambda: kernel(**operands, bias=b,
                                            activation=act), **timing)
                plain_ms = time_ms(lambda: plain(**operands, bias=b,
                                                 activation=act), **timing)
                op_ms = time_ms(lambda: op(x, w, s, p, bias=b, epilogue=ep),
                                **timing)
                library = library_conv_transpose if tr else library_conv
                library_ms = time_ms(library(x, w, b, s, p), **timing)
                bound_ms, bound_by, flops, nbytes = bound(operands, b)
                row = dict(layer=label, part=part, launches_per_step=launches,
                           ms=ms, plain_ms=plain_ms, op_ms=op_ms,
                           library_ms=library_ms, bound_ms=bound_ms,
                           bound_by=bound_by, gflop=flops / 1e9,
                           mbytes=nbytes / 1e6, dw_per_step=dw_launches)
                if part == "forward":
                    y_sp = op(x, w, s, p).shape[1:-1]
                    g = rand(BATCH, *y_sp, ws[-1])
                    wgrad = tdf._tconv_wgrad if tr else tdf._conv_wgrad
                    dw_ms = time_ms(lambda: wgrad(x, g, ws[:nd], s, p),
                                    **timing)
                    dw_bytes = 4 * (x.numel() + g.numel() + w.numel())
                    dw_bound = max(flops / PEAK_FP32_FLOPS,
                                   dw_bytes / PEAK_HBM_BYTES) * 1e3
                    row.update(dw_ms=dw_ms, dw_bound_ms=dw_bound)
                    del g
            rows[name].append(row)
            lib = ("conv_transpose" if tr else "conv") + f"{nd}d"
            dw = (f"; dw {row['dw_ms']:.4f} ms (bound "
                  f"{row['dw_bound_ms']:.4f})" if part == "forward" else "")
            print(f"train time {label}: {launches}/step, kernel {ms:.4f} ms, "
                  f"plain {plain_ms:.4f} ms, whole op {op_ms:.4f} ms, {lib} "
                  f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}; "
                  f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB){dw} "
                  f"[{card}]")
            del x, w, b, operands
        r = rows[name]
        per_step = {key: sum(row[key] * row["launches_per_step"] for row in r)
                    for key in ("ms", "bound_ms", "library_ms")}
        per_step["dw_ms"] = sum(row.get("dw_ms", 0.0) * row["dw_per_step"]
                                for row in r)
        per_step["dw_bound_ms"] = sum(row.get("dw_bound_ms", 0.0)
                                      * row["dw_per_step"] for row in r)
        print(f"{model} train step, per step: {sum(row['launches_per_step'] for row in r)} "
              f"{name} launches, kernels {per_step['ms']:.3f} ms (bound "
              f"{per_step['bound_ms']:.3f} ms, cuDNN {per_step['library_ms']:.3f}"
              f" ms), dw contractions {per_step['dw_ms']:.3f} ms (bound "
              f"{per_step['dw_bound_ms']:.3f} ms) [{card}]")
        rows[name] = dict(rows=r, per_step=per_step)
    return rows


def train_paths(dev, wrappers) -> dict:
    """The training paths: full-width DCGAN through the quickstart entry
    point (TrainLoop, checkpoints, then a served batch), and full-width
    3D-GAN through the same training code; each driven with every launch
    counter at 0 just before and read just after.  Returns the launches
    by kernel and path."""
    from repro_torch import quickstart
    from repro_torch.models.gan import GanConfig

    def zero():
        for kernel, _ in wrappers.values():
            kernel.launches = 0

    def counts():
        torch.cuda.synchronize()
        return {k: wrappers[k][0].launches for k in wrappers}

    def finite(loop, model):
        check(bool(loop.metrics_history), f"{model}: no losses logged")
        for m in loop.metrics_history:
            check(all(math.isfinite(v) for v in m.values()),
                  f"{model} step {m['step']}: a loss is not finite: {m}")

    zero()
    loop, server = quickstart.main([
        "--steps", str(TRAIN_STEPS), "--batch", str(BATCH),
        "--channel-scale", "1", "--device", "cuda"])
    c = counts()
    served = 4 * server.batches_served
    print(f"dcgan quickstart: {loop.steps} steps, {loop.checkpoints} "
          f"checkpoint(s), {loop.restarts} restarts; launches {c} = "
          f"{LAUNCHES_PER_STEP} x {TRAIN_STEPS} steps + {served} serving")
    check(loop.steps == TRAIN_STEPS and loop.restarts == 0
          and loop.checkpoints >= 1, f"dcgan: the loop ran {loop.steps} "
          f"steps, {loop.checkpoints} checkpoints, {loop.restarts} restarts")
    finite(loop, "dcgan")
    check(c["ganax_conv"] == LAUNCHES_PER_STEP * TRAIN_STEPS + served,
          f"dcgan training: {c['ganax_conv']} ganax_conv launches, "
          f"expected {LAUNCHES_PER_STEP} per step")
    check(c["ganax_conv3d"] == 0, f"dcgan launched the 3-D kernel: {c}")
    out = {"ganax_conv": c["ganax_conv"]}

    zero()
    with tempfile.TemporaryDirectory() as ckpt_dir:
        loop3, _ = quickstart.train(
            GanConfig("3dgan"), steps=TRAIN3D_STEPS, batch=BATCH, lr=4e-3,
            ckpt_dir=ckpt_dir, device=dev, ckpt_every=TRAIN3D_STEPS,
            log_every=1)
    c = counts()
    print(f"3dgan training: {loop3.steps} steps, {loop3.checkpoints} "
          f"checkpoint(s); launches {c} = {LAUNCHES_PER_STEP} x "
          f"{TRAIN3D_STEPS} steps")
    finite(loop3, "3dgan")
    check(c["ganax_conv3d"] == LAUNCHES_PER_STEP * TRAIN3D_STEPS,
          f"3dgan training: {c['ganax_conv3d']} ganax_conv3d launches, "
          f"expected {LAUNCHES_PER_STEP} per step")
    check(c["ganax_conv"] == 0, f"3dgan launched the 2-D kernel: {c}")
    out["ganax_conv3d"] = c["ganax_conv3d"]
    return out


def train_parity_and_times(card, dev) -> dict:
    """Per model: one step's losses and every gradient through the kernel
    against the same step through ganax-plain on the card (and, as the
    control, through the polyphase oracle); then the D
    step, the G step and the whole step timed with CUDA events, and a
    profile of whole steps."""
    from repro_torch.models.gan import (Discriminator, GanConfig, Generator,
                                        init_gan)
    from repro_torch.quickstart import make_batch_fn
    from repro_torch.train.loop import (discriminator_grads,
                                        generator_grads, sgd_update)
    out = {}
    for model, warmup, runs, prof_runs in (("dcgan", 3, 10, 2),
                                           ("3dgan", 1, 3, 1)):
        cfg = GanConfig(model)
        g, d = init_gan(cfg, torch.Generator().manual_seed(0), dev)
        batch = make_batch_fn(cfg, BATCH, dev)(0)
        z, real = batch["z"], batch["real"]
        res, nets = {}, None
        for backend in (None, "ganax-plain", "polyphase"):
            c = dataclasses.replace(cfg, backend=backend)
            gen = Generator(c, {k: v.clone() for k, v in g.items()}, dev)
            disc = Discriminator(c, {k: v.clone() for k, v in d.items()},
                                 dev)
            dl, dg = discriminator_grads(gen, disc, z, real)
            gl, gg = generator_grads(gen, disc, z)
            res[backend] = (dl, gl, {**{f"d.{k}": v for k, v in dg.items()},
                                     **{f"g.{k}": v for k, v in gg.items()}})
            if backend is None:
                nets = (gen, disc)
        ((dl, gl, grads), (ref_dl, ref_gl, ref_grads),
         (_, _, ctl_grads)) = res.values()
        loss_err = max(abs(float(dl - ref_dl)), abs(float(gl - ref_gl)))
        print(f"{model} step vs ganax-plain step: d_loss {float(dl):.6f} / "
              f"{float(ref_dl):.6f}, g_loss {float(gl):.6f} / "
              f"{float(ref_gl):.6f}")
        check(loss_err <= LOSS_TOL * max(1.0, abs(float(ref_dl)),
                                         abs(float(ref_gl))),
              f"{model}: the losses disagree with ganax-plain by {loss_err}")
        def rel(a, b):
            return float((a - b).norm() / b.norm().clamp_min(1e-30))

        worst, worst_ctl, worst_name = 0.0, 0.0, None
        for k, ref in ref_grads.items():
            err, ctl = rel(grads[k], ref), rel(ctl_grads[k], ref)
            if err > worst:
                worst, worst_name = err, k
            worst_ctl = max(worst_ctl, ctl)
            check(bool(torch.isfinite(grads[k]).all()) and err <= GRAD_TOL,
                  f"{model} gradient {k} disagrees with ganax-plain: "
                  f"||a-b||/||b|| {err:.3e} (polyphase control {ctl:.3e})")
        print(f"{model}: {len(ref_grads)} gradients vs ganax-plain, worst "
              f"||a-b||/||b|| {worst:.3e} at {worst_name} (tolerance "
              f"{GRAD_TOL:g}); polyphase control vs ganax-plain worst "
              f"{worst_ctl:.3e} ok")
        del res, grads, ref_grads, ctl_grads

        gen, disc = nets
        lr = 0.02

        def step(events=None):
            dl, dg = discriminator_grads(gen, disc, z, real)
            sgd_update(disc.params, dg, lr)
            if events:
                events[1].record()
            gl, gg = generator_grads(gen, disc, z)
            sgd_update(gen.params, gg, lr)

        times = []
        for i in range(warmup + runs):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            ev[0].record()
            step(ev)
            ev[2].record()
            ev[2].synchronize()
            if i >= warmup:
                times.append((ev[0].elapsed_time(ev[1]),
                              ev[1].elapsed_time(ev[2]),
                              ev[0].elapsed_time(ev[2])))
        d_ms, g_ms, step_ms = (statistics.median(t) for t in zip(*times))
        print(f"{model} train step at batch {BATCH}: D step {d_ms:.3f} ms, "
              f"G step {g_ms:.3f} ms, whole step {step_ms:.3f} ms (median of "
              f"{runs}) [{card}]")
        prof = profile(step, prof_runs, f"{model} train steps")
        out[model] = dict(d_step_ms=d_ms, g_step_ms=g_ms, step_ms=step_ms,
                          steps_timed=runs, worst_grad_rel_err=worst,
                          worst_grad_rel_err_control=worst_ctl,
                          loss_err=loss_err, profile=prof)
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, default=None,
                    help="also write the whole record as JSON here")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.gans import GAN_MODELS
    from repro_torch.kernels import build, ops
    from repro_torch.kernels.ganax_conv import (ganax_conv3d_cuda,
                                                ganax_conv3d_plain,
                                                ganax_conv_cuda,
                                                ganax_conv_plain)
    from repro_torch.core.dataflow import Epilogue
    from repro_torch.models.gan import (GanConfig, generator_epilogues,
                                        init_gan)
    from repro_torch.serve.gan import GanServer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    record: dict = {}
    wrappers = {"ganax_conv": (ganax_conv_cuda, ganax_conv_plain),
                "ganax_conv3d": (ganax_conv3d_cuda, ganax_conv3d_plain)}

    # -- 1. environment and build -----------------------------------------
    card = card_line()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    print(f"card: {card}")
    print("TF32 off: torch.backends.cuda.matmul.allow_tf32 = False, "
          "torch.backends.cudnn.allow_tf32 = False")
    t0 = time.perf_counter()
    built = build.build()
    build_s = time.perf_counter() - t0
    for name in KERNELS:
        check(name in built, f"{name} did not build")
    for name, res in built.items():
        print(f"built {name} ({'compiled' if res.compiled else 'cached'}, "
              f"{res.seconds:.1f} s) -> {res.path.name}")
        for line in res.log.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"  ptxas: {line.strip()}")
    print(f"build phase: {build_s:.1f} s")
    record["build_s"] = build_s

    # -- 2. each kernel against its plain version on the card --------------
    gen = torch.Generator().manual_seed(1234)

    def rand(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=gen)).to(dev)

    cases = {name: [] for name in KERNELS}
    timed = set()       # the generator layers, timed in phase 4
    for name, model in (("ganax_conv", "dcgan"), ("ganax_conv3d", "3dgan")):
        g_layers, d_layers = GAN_MODELS[model]
        for l, ep in zip(g_layers, generator_epilogues(g_layers)):
            timed.add(f"{model} {l.name}")
            cases[name].append((f"{model} {l.name}", True, l.in_spatial,
                                l.kernel, l.strides, l.paddings, l.cin,
                                l.cout, ep))
        d2 = d_layers[1]
        cases[name].append((f"{model} d2 (SIMD conv)", False, d2.in_spatial,
                            d2.kernel, d2.strides, d2.paddings, d2.cin,
                            d2.cout,
                            Epilogue(bias=True, activation="leaky_relu")))
    cases["ganax_conv"] += [
        ("k1 s2 zero-tap tconv", True, (16, 16), (1, 1), (2, 2), (0, 0), 64,
         32, Epilogue(bias=True, activation="relu")),
        ("k4 s2 no bias, none", True, (8, 8), (4, 4), (2, 2), (1, 1), 128,
         64, Epilogue())]
    cases["ganax_conv3d"] += [
        ("k1 s2 zero-tap tconv3d", True, (8, 8, 8), (1, 1, 1), (2, 2, 2),
         (0, 0, 0), 64, 32, Epilogue(bias=True, activation="relu")),
        ("ragged Cin 33 Cout 65 3d", True, (5, 6, 7), (3, 3, 3), (2, 2, 2),
         (1, 1, 1), 33, 65, Epilogue(bias=True, activation="leaky_relu"))]
    kernel_errs = {name: [] for name in KERNELS}
    layer_rows = {name: [] for name in KERNELS}
    with torch.inference_mode():
        for name, (kernel, plain) in wrappers.items():
            for label, transposed, sp, k, s, p, cin, cout, ep in cases[name]:
                x = rand(BATCH, *sp, cin)
                w = rand(*k, cin, cout, scale=(math.prod(k) * cin) ** -0.5)
                b = rand(cout, scale=0.1) if ep.bias else None
                operands = ops.kernel_operands(x, w, s, p,
                                               transposed=transposed)
                got = kernel(**operands, bias=b, activation=ep.activation,
                             leaky_slope=ep.leaky_slope)
                ref = plain(**operands, bias=b, activation=ep.activation,
                            leaky_slope=ep.leaky_slope)
                torch.cuda.synchronize()
                err, ok = max_err(got, ref)
                kernel_errs[name].append(err)
                print(f"{name} vs plain  {label:26s} out "
                      f"{tuple(got.shape)} max_abs_err {err:.3e} "
                      f"(atol=rtol={ATOL:g}) {'ok' if ok else 'FAIL'}")
                check(ok and bool(torch.isfinite(got).all()),
                      f"{label}: {name} disagrees with its plain version")
                if label in timed:
                    layer_rows[name].append((label, operands, b, ep, x, w, s,
                                             p))
                del got, ref

    # -- 3. the main paths: serve each full-width generator ----------------
    servers = {}
    launches = {}
    for name, model, shape in (("ganax_conv", "dcgan", (64, 64, 3)),
                               ("ganax_conv3d", "3dgan", (64, 64, 64, 1))):
        cfg = GanConfig(model)
        g_params, _ = init_gan(cfg, torch.Generator().manual_seed(0),
                               device=dev)
        server = GanServer(cfg, g_params, batch_size=BATCH, seed=0,
                           device=dev)
        for kernel, _ in wrappers.values():
            kernel.launches = 0
        served = [server.generate(n) for n in REQUESTS]
        torch.cuda.synchronize()
        counts = {k: wrappers[k][0].launches for k in wrappers}
        for n, img in zip(REQUESTS, served):
            check(tuple(img.shape) == (n, *shape),
                  f"{model} generate({n}) gave shape {tuple(img.shape)}")
            check(bool(torch.isfinite(img).all()),
                  f"{model} generate({n}) not finite")
            check(img.abs().max().item() <= 1.0,
                  f"{model} generate({n}) leaves [-1, 1] (tanh output)")
        check(server.samples_served + server.samples_buffered
              + server.samples_discarded
              == server.batches_served * server.batch_size,
              f"{model}: served + buffered + discarded != batches x "
              f"batch_size")
        n_layers = len(cfg.layers[0])
        check(counts[name] == n_layers * server.batches_served,
              f"{model}: {counts[name]} {name} launches for "
              f"{server.batches_served} batches of {n_layers} layers")
        check(all(c == 0 for k, c in counts.items() if k != name),
              f"{model} launched another path's kernel: {counts}")
        launches[name] = counts[name]
        print(f"{model}: served {', '.join(map(str, REQUESTS))}: {server}; "
              f"{counts[name]} {name} launches for "
              f"{server.batches_served} batches")
        # the same stream through the plain version of the kernel on the
        # card
        ref_server = GanServer(GanConfig(model, backend="ganax-plain"),
                               g_params, batch_size=BATCH, seed=0,
                               device=dev)
        ref_img = ref_server.generate(BATCH)
        err, ok = max_err(served[0][:BATCH], ref_img)
        print(f"{model} generator vs plain generator (same latents) "
              f"max_abs_err {err:.3e} (atol=rtol={ATOL:g}) "
              f"{'ok' if ok else 'FAIL'}")
        check(ok, f"the {model} generator disagrees with its plain version")
        record[f"{model}_generator_max_abs_err"] = err
        servers[name] = server
        del served, ref_img, ref_server

    # -- 4. times ----------------------------------------------------------
    rows = {name: [] for name in KERNELS}
    with torch.inference_mode():
        for name, (kernel, plain) in wrappers.items():
            for label, operands, b, ep, x, w, s, p in layer_rows[name]:
                act = ep.activation
                ms = time_ms(lambda: kernel(**operands, bias=b,
                                            activation=act))
                plain_ms = time_ms(lambda: plain(**operands, bias=b,
                                                 activation=act))
                library_ms = time_ms(library_conv_transpose(x, w, b, s, p))
                op_ms = time_ms(lambda: ops.ganax_conv_transpose(
                    x, w, s, p, bias=b, epilogue=ep))
                bound_ms, bound_by, flops, nbytes = bound(operands, b)
                rows[name].append(dict(
                    layer=label, ms=ms, plain_ms=plain_ms,
                    library_ms=library_ms, op_ms=op_ms, bound_ms=bound_ms,
                    bound_by=bound_by, gflop=flops / 1e9,
                    mbytes=nbytes / 1e6, launches_per_batch=1))
                lib = "conv_transpose2d" if x.ndim == 4 \
                    else "conv_transpose3d"
                print(f"time {label}: kernel {ms:.4f} ms, plain "
                      f"{plain_ms:.4f} ms, {lib} {library_ms:.4f} ms, whole "
                      f"op {op_ms:.4f} ms, bound {bound_ms:.4f} ms "
                      f"({bound_by}; {flops / 1e9:.2f} GFLOP, "
                      f"{nbytes / 1e6:.1f} MB) [{card}]")
            server = servers[name]
            z = torch.randn((BATCH, server.cfg.z_dim), device=dev,
                            generator=torch.Generator(device=dev)
                            .manual_seed(1))
            gen_ms = time_ms(lambda: server.generator(z))
            prof = profile(lambda: server.generator(z), 5,
                           "generator forwards")
            per_s = BATCH / (gen_ms / 1e3)
            model = server.cfg.name
            unit = "images" if name == "ganax_conv" else "volumes"
            print(f"{model} generator forward at batch {BATCH}: "
                  f"{gen_ms:.4f} ms, {per_s:.1f} {unit}/s [{card}]")
            record[model] = dict(layers=rows[name], generator_ms=gen_ms,
                                 per_s=per_s, unit=unit, profile=prof)
    servers.clear()
    torch.cuda.empty_cache()

    # -- 5. training: every launch geometry of the step, kernel vs plain --
    record["train_geometries"] = train_geometries(card, dev, wrappers,
                                                  kernel_errs)
    # -- 6. the training paths (DCGAN quickstart, 3D-GAN) ------------------
    train_launches = train_paths(dev, wrappers)
    # -- 7. one step against ganax-plain, step times, profiles -------------
    record["train"] = train_parity_and_times(card, dev)
    record.update(card=card, torch=torch.__version__, cuda=torch.version.cuda,
                  launches={"serve": launches, "train": train_launches})

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        r = rows[name]
        total_bound = sum(row["bound_ms"] for row in r)
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            # the serving path's launches and the training path's
            "launches": launches[name] + train_launches[name],
            "max_abs_err": max(kernel_errs[name]),
            # per batch of the path: the sum over its four launches
            "ms": sum(row["ms"] for row in r),
            "plain_ms": sum(row["plain_ms"] for row in r),
            "bound_ms": total_bound,
            "bound_by": ("operations" if sum(
                row["bound_ms"] for row in r
                if row["bound_by"] == "operations") >= total_bound / 2
                else "bytes"),
            "library_ms": sum(row["library_ms"] for row in r),
        })
    record["kernels"] = kernels
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(record, indent=1))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
