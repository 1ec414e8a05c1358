"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--out FILE]

Builds every CUDA kernel of the port from the sources in this checkout,
holds each kernel against its plain PyTorch version on the card, drives
the port's two paths through ``GanServer.generate`` (random weights from
a seed): the full-width DCGAN generator through the planar kernel and
the full-width 3D-GAN generator through the volumetric one, and checks
the outputs and the launch counts of each path; then times each layer's
kernel beside its bound, its plain version, the whole op and one library
call, and each generator forward.  It imports nothing of JAX and nothing
of the JAX package.

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

# name -> (source, the TPU kernel it replaces)
KERNELS = {
    "ganax_conv": ("src/repro_torch/kernels/csrc/ganax_conv.cu",
                   "src/repro/kernels/ganax_conv.py:99"),
    "ganax_conv3d": ("src/repro_torch/kernels/csrc/ganax_conv3d.cu",
                     "src/repro/kernels/ganax_conv.py:215"),
}
# the requests each serving path answers
REQUESTS = (64, 100, 37)


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
    short = {}      # kernels whose names share 80 characters add up
    for k, v in top:
        short[k[:80]] = short.get(k[:80], 0.0) + v / runs
    out = {"wall_ms_per_batch": wall_ms / runs,
           "device_ms_per_batch": device_ms / runs,
           "device_busy_share": device_ms / wall_ms,
           "kernels_ms_per_batch": short}
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


def library_conv_transpose(x, w, b, s, p):
    """One cuDNN transposed conv on channels-first tensors (TF32 off): a
    yardstick the port never calls."""
    nd = x.ndim - 2
    fn = F.conv_transpose2d if nd == 2 else F.conv_transpose3d
    xn = x.movedim(-1, 1).contiguous()
    wn = w.permute(nd, nd + 1, *range(nd)).contiguous()  # (Cin, Cout, K...)
    return lambda: fn(xn, wn, b, stride=s, padding=p)


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
            profile = profile_generator(server.generator, z)
            per_s = BATCH / (gen_ms / 1e3)
            model = server.cfg.name
            unit = "images" if name == "ganax_conv" else "volumes"
            print(f"{model} generator forward at batch {BATCH}: "
                  f"{gen_ms:.4f} ms, {per_s:.1f} {unit}/s [{card}]")
            record[model] = dict(layers=rows[name], generator_ms=gen_ms,
                                 per_s=per_s, unit=unit, profile=profile)
    record.update(card=card, torch=torch.__version__, cuda=torch.version.cuda)

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        r = rows[name]
        total_bound = sum(row["bound_ms"] for row in r)
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": launches[name],
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
