"""The path gate of ``chip_smoke.py``'s quant phase, rehearsed on the CPU.

    PYTHONPATH=src python tools/quant_path_gate.py dcgan bf16 --batch 4
    PYTHONPATH=src python tools/quant_path_gate.py 3dgan f16 --batch 1

Serves one full-width generator (random weights, seed 0) at a storage
dtype four ways, on the same latents: through the plain version of the
GANAX kernel (the reference path), through the tc route's order of sums
(``tc_route_emulation``) on every layer that takes it, and with one
layer's sums kept in the storage dtype (each layer in turn: the planted
fault of ``chip_smoke.py``).  For each it prints the error against the
f32 plain path divided by the plain path's (the ratio
``chip_smoke.PATH_ACCURACY`` gates), its distance from the plain path
in norm and the share of outputs that differ.  It runs on the CPU and
says how the gate separates orders of sums, not how fast anything runs.
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.kernels import ganax_conv as gc
from repro_torch.kernels import ops
from repro_torch.models.gan import GanConfig, Generator, init_gan
from repro_torch.quant import storage_dtype


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("model", choices=("dcgan", "3dgan"))
    ap.add_argument("dtype", choices=("bf16", "f16"))
    ap.add_argument("--batch", type=int, default=2)
    args = ap.parse_args(argv)
    sd = storage_dtype(args.dtype)
    state = {"mode": "plain", "fault": -1, "call": 0}

    def launch(x_pad, w_taps, tables, out_strides, bias=None,
               activation="none", leaky_slope=0.2, **q):
        q = tuple(q[k] for k in ("qz", "qy", "qx") if k in q)
        i, state["call"] = state["call"], state["call"] + 1
        if state["mode"] == "tc order" and w_taps.shape[-1] > 8:
            return gc.tc_route_emulation(x_pad, w_taps, tables, out_strides,
                                         q, bias, activation, leaky_slope)
        if state["mode"] == "fault" and i == state["fault"]:
            acc = gc.plain_sums(x_pad, w_taps, tables, out_strides, q,
                                acc_dtype=x_pad.dtype)
            return gc.apply_epilogue_to_acc(acc.float(), bias, activation,
                                            leaky_slope).to(x_pad.dtype)
        return gc._plain(x_pad, w_taps, tables, out_strides, q, bias,
                         activation, leaky_slope)

    # every launch on the CPU goes through `launch`
    for nd in (2, 3):
        ops._KERNELS[nd] = (launch, launch)
    cfg = GanConfig(args.model, dtype=sd)
    g, _ = init_gan(cfg, torch.Generator().manual_seed(0), device="cpu")
    z = torch.randn((args.batch, cfg.z_dim),
                    generator=torch.Generator().manual_seed(1))
    nets = {dt: Generator(GanConfig(args.model, dtype=dt), g,
                          "cpu").requires_grad_(False)
            for dt in ("float32", sd)}

    def run(mode, fault=-1, dt=sd):
        state.update(mode=mode, fault=fault, call=0)
        with torch.inference_mode():
            return nets[dt](z).double()

    ref32 = run("plain", dt="float32")
    plain = run("plain")
    base = (plain - ref32).norm().item()
    print(f"{args.model} {args.dtype} batch {args.batch}: images rms "
          f"{plain.pow(2).mean().sqrt().item():.3e}")
    cases = [("tc order", -1)] + [("fault", i) for i in range(4)]
    for mode, fault in cases:
        y = run(mode, fault)
        label = mode if fault < 0 else \
            f"{args.dtype} sums at layer {fault + 1}"
        print(f"  {label:28s} ||y - f32|| / ||plain - f32|| "
              f"{(y - ref32).norm().item() / base:.4f}, ||y - plain|| / "
              f"||plain|| {((y - plain).norm() / plain.norm()).item():.3e}, "
              f"outputs differing {(y != plain).double().mean().item():.3f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
