"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--out FILE]

Builds every CUDA kernel of the port from the sources in this checkout,
holds each kernel against its plain PyTorch version on the card, serves
the full-width DCGAN generator through ``GanServer.generate`` (random
weights from a seed) and checks the images and the launch counts, then
times each kernel beside its bound, its plain version and one library
call.  It imports nothing of JAX and nothing of the JAX package.

The line before the last is a JSON object listing every kernel; the
last line is ``{"ok": true, "device": {...}}``.  Any failed phase exits
non-zero and prints no result; so does a machine without a CUDA card.
``--out`` also writes the whole record (per-layer times included) as
JSON.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
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

KERNEL_SOURCE = "src/repro_torch/kernels/csrc/ganax_conv.cu"
KERNEL_REPLACES = "src/repro/kernels/ganax_conv.py:99"


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


def bound(operands: dict, bias) -> tuple[float, str, float, int]:
    """(bound ms, what bounds it, flops, bytes) of one kernel launch:
    each input read once and the output written once; the operations
    the tap tables of this geometry need (2 per consequential MAC)."""
    x_pad, w_taps = operands["x_pad"], operands["w_taps"]
    b, _, _, cin = x_pad.shape
    p, _, _, cout = w_taps.shape
    qy, qx = operands["qy"], operands["qx"]
    taps = sum(len(ph) for ph in operands["tables"].taps)
    flops = 2.0 * b * qy * qx * taps * cin * cout
    out_elems = b * p * qy * qx * cout
    tables = operands["tables"]
    nbytes = 4 * (x_pad.numel() + w_taps.numel() + out_elems
                  + (bias.numel() if bias is not None else 0)) \
        + 4 * (tables.n_taps.numel() + 2 * tables.tap_dy.numel())
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes
            else "bytes", flops, nbytes)


def profile_generator(generator, z, runs: int = 5) -> dict:
    """Device time by kernel over ``runs`` generator forwards
    (torch.profiler), and the share of the wall time the device was busy.
    Prints the breakdown; returns it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    generator(z)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(runs):
            generator(z)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for evt in prof.key_averages():
        # kernels only: an operator's row repeats its kernels' time
        if evt.device_type != DeviceType.CUDA:
            continue
        by_name[evt.key] = (by_name.get(evt.key, 0.0)
                            + evt.self_device_time_total / 1e3)
    device_ms = sum(by_name.values())
    if device_ms == 0:
        print("profile: the profiler saw no device time (not measured)")
        return {"wall_ms_per_batch": wall_ms / runs, "device": None}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    out = {"wall_ms_per_batch": wall_ms / runs,
           "device_ms_per_batch": device_ms / runs,
           "device_busy_share": device_ms / wall_ms,
           "kernels_ms_per_batch": {k[:80]: v / runs for k, v in top}}
    print(f"profile over {runs} generator forwards: wall "
          f"{wall_ms / runs:.4f} ms/batch, device busy "
          f"{device_ms / runs:.4f} ms/batch ({100 * device_ms / wall_ms:.1f}"
          f"% of the wall time)")
    for name, ms in top[:8]:
        print(f"  {ms / runs:9.4f} ms/batch  {name[:90]}")
    return out


def max_err(got: torch.Tensor, ref: torch.Tensor) -> tuple[float, bool]:
    err = (got - ref).abs().max().item()
    ok = bool(torch.allclose(got, ref, atol=ATOL, rtol=RTOL))
    return err, ok


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
    from repro_torch.kernels.ganax_conv import (ganax_conv_cuda,
                                                ganax_conv_plain)
    from repro_torch.core.dataflow import Epilogue
    from repro_torch.models.gan import (GanConfig, generator_epilogues,
                                        init_gan)
    from repro_torch.serve.gan import GanServer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    record: dict = {}

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
    check("ganax_conv" in built, "ganax_conv did not build")
    for name, res in built.items():
        print(f"built {name} ({'compiled' if res.compiled else 'cached'}, "
              f"{res.seconds:.1f} s) -> {res.path.name}")
        for line in res.log.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"  ptxas: {line.strip()}")
    print(f"build phase: {build_s:.1f} s")
    record["build_s"] = build_s

    # -- 2. kernel against its plain version on the card -------------------
    gen = torch.Generator().manual_seed(1234)

    def rand(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=gen)).to(dev)

    g_layers, d_layers = GAN_MODELS["dcgan"]
    eps = generator_epilogues(g_layers)
    cases = []
    for l, ep in zip(g_layers, eps):
        cases.append((f"dcgan {l.name}", True, l.in_spatial, l.kernel,
                      l.strides, l.paddings, l.cin, l.cout, ep))
    d2 = d_layers[1]
    cases.append(("dcgan d2 (SIMD conv)", False, d2.in_spatial, d2.kernel,
                  d2.strides, d2.paddings, d2.cin, d2.cout,
                  Epilogue(bias=True, activation="leaky_relu")))
    cases.append(("k1 s2 zero-tap tconv", True, (16, 16), (1, 1), (2, 2),
                  (0, 0), 64, 32, Epilogue(bias=True, activation="relu")))
    cases.append(("k4 s2 no bias, none", True, (8, 8), (4, 4), (2, 2),
                  (1, 1), 128, 64, Epilogue()))
    kernel_errs = []
    layer_rows = []
    with torch.inference_mode():
        for label, transposed, sp, k, s, p, cin, cout, ep in cases:
            x = rand(BATCH, *sp, cin)
            w = rand(*k, cin, cout, scale=(math.prod(k) * cin) ** -0.5)
            b = rand(cout, scale=0.1) if ep.bias else None
            operands = ops.kernel_operands(x, w, s, p, transposed=transposed)
            got = ganax_conv_cuda(**operands, bias=b,
                                  activation=ep.activation,
                                  leaky_slope=ep.leaky_slope)
            ref = ganax_conv_plain(**operands, bias=b,
                                   activation=ep.activation,
                                   leaky_slope=ep.leaky_slope)
            torch.cuda.synchronize()
            err, ok = max_err(got, ref)
            kernel_errs.append(err)
            print(f"kernel vs plain  {label:24s} out {tuple(got.shape)} "
                  f"max_abs_err {err:.3e} (atol=rtol={ATOL:g}) "
                  f"{'ok' if ok else 'FAIL'}")
            check(ok and bool(torch.isfinite(got).all()),
                  f"{label}: kernel disagrees with its plain version")
            if label.startswith("dcgan g"):
                layer_rows.append((label, operands, b, ep, x, w, s, p))

    # -- 3. the main path: serve the full-width DCGAN generator ------------
    cfg = GanConfig("dcgan")
    g_params, _ = init_gan(cfg, torch.Generator().manual_seed(0),
                           device=dev)
    server = GanServer(cfg, g_params, batch_size=BATCH, seed=0, device=dev)
    ganax_conv_cuda.launches = 0
    served = [server.generate(n) for n in (64, 100, 37)]
    torch.cuda.synchronize()
    launches = ganax_conv_cuda.launches
    for n, img in zip((64, 100, 37), served):
        check(tuple(img.shape) == (n, 64, 64, 3),
              f"generate({n}) gave shape {tuple(img.shape)}")
        check(bool(torch.isfinite(img).all()), f"generate({n}) not finite")
        check(img.abs().max().item() <= 1.0,
              f"generate({n}) leaves [-1, 1] (tanh output)")
    check(server.samples_served + server.samples_buffered
          + server.samples_discarded
          == server.batches_served * server.batch_size,
          "served + buffered + discarded != batches x batch_size")
    check(launches == len(g_layers) * server.batches_served,
          f"{launches} kernel launches for {server.batches_served} batches "
          f"of {len(g_layers)} layers")
    print(f"served 64, 100, 37 images: {server}; {launches} ganax_conv "
          f"launches for {server.batches_served} batches")
    # the same stream through the plain version of the kernel on the card
    ref_server = GanServer(GanConfig("dcgan", backend="ganax-plain"),
                           g_params, batch_size=BATCH, seed=0, device=dev)
    ref_img = ref_server.generate(BATCH)
    err, ok = max_err(served[0][:BATCH], ref_img)
    print(f"generator vs plain generator (same latents) max_abs_err "
          f"{err:.3e} (atol=rtol={ATOL:g}) {'ok' if ok else 'FAIL'}")
    check(ok, "the generator disagrees with its plain version")
    record["generator_max_abs_err"] = err

    # -- 4. times ----------------------------------------------------------
    rows = []
    with torch.inference_mode():
        for label, operands, b, ep, x, w, s, p in layer_rows:
            act = ep.activation
            ms = time_ms(lambda: ganax_conv_cuda(**operands, bias=b,
                                                 activation=act))
            plain_ms = time_ms(lambda: ganax_conv_plain(
                **operands, bias=b, activation=act))
            x_nchw = x.permute(0, 3, 1, 2).contiguous()
            w_oihw = w.permute(2, 3, 0, 1).contiguous()   # (Cin, Cout, K, K)
            library_ms = time_ms(lambda: F.conv_transpose2d(
                x_nchw, w_oihw, b, stride=s, padding=p))
            op_ms = time_ms(lambda: ops.ganax_conv_transpose(
                x, w, s, p, bias=b, epilogue=ep))
            bound_ms, bound_by, flops, nbytes = bound(operands, b)
            rows.append(dict(layer=label, ms=ms, plain_ms=plain_ms,
                             library_ms=library_ms, op_ms=op_ms,
                             bound_ms=bound_ms, bound_by=bound_by,
                             gflop=flops / 1e9, mbytes=nbytes / 1e6,
                             launches_per_batch=1))
            print(f"time {label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
                  f"ms, conv_transpose2d {library_ms:.4f} ms, whole op "
                  f"{op_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}; "
                  f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB) "
                  f"[{card}]")
        z = torch.randn((BATCH, cfg.z_dim), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(1))
        gen_ms = time_ms(lambda: server.generator(z))
        profile = profile_generator(server.generator, z)
    images_per_s = BATCH / (gen_ms / 1e3)
    print(f"generator forward at batch {BATCH}: {gen_ms:.4f} ms, "
          f"{images_per_s:.1f} images/s [{card}]")
    record.update(layers=rows, generator_ms=gen_ms,
                  images_per_s=images_per_s, card=card,
                  torch=torch.__version__, cuda=torch.version.cuda,
                  profile=profile)

    kernels = [{
        "name": "ganax_conv",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES,
        "launches": launches,
        "max_abs_err": max(kernel_errs),
        # per batch of the main path: the sum over its four launches
        "ms": sum(r["ms"] for r in rows),
        "plain_ms": sum(r["plain_ms"] for r in rows),
        "bound_ms": sum(r["bound_ms"] for r in rows),
        "bound_by": ("operations" if sum(
            r["bound_ms"] for r in rows if r["bound_by"] == "operations")
            >= sum(r["bound_ms"] for r in rows) / 2 else "bytes"),
        "library_ms": sum(r["library_ms"] for r in rows),
    }]
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
