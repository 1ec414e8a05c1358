"""The gradient gate of ``chip_smoke.py``'s mixed_train phase, read at any
layer's planted fault.

    PYTHONPATH=src python tools/grad_gate.py dcgan bf16 --batch 4
    PYTHONPATH=src python tools/grad_gate.py dcgan f16 --batch 64 \
        --layer g2 g3 g4 d2 d3 d4

One adversarial step's gradients of the full-width generator and
discriminator (random weights, seed 0; the quickstart's first batch) at
a storage dtype against the f32 plain step: through the plain version of
the GANAX kernel (the reference path), through the kernel path (on the
CPU: the plain version again, so its ratios are 1), and with each
planted fault (``--layer``'s dx with its sums in the storage dtype,
every product added to a storage-dtype running sum).  Prints the ratios
``||g - g32|| / ||g_plain - g32||`` over every gradient, over D's and
over G's (``chip_smoke.PATH_ACCURACY`` gates the first two) and per
layer, and whether each fault exceeds the gate.  It says which layers' faults the gate can see, not
how fast anything runs; ``chip_smoke.py`` asks it at batch 64, seed 0,
of ``chip_smoke.GRAD_FAULT_LAYERS``.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from chip_smoke import (GRAD_FAULT_LAYERS, GRAD_GATED,  # noqa: E402
                        GRAD_PARTS, PATH_ACCURACY, exact_sums, grad_gate)
from repro_torch.quant import canonical_dtype  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("model", choices=("dcgan", "3dgan"))
    ap.add_argument("dtype", choices=("bf16", "f16"))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--channel-scale", type=float, default=1.0)
    ap.add_argument("--layer", nargs="+", default=list(GRAD_FAULT_LAYERS),
                    help="the layers whose dx carries a fault, one step "
                         "each")
    ap.add_argument("--seed", type=int, nargs="+", default=[0],
                    help="parameters' seed and the batch's step, one "
                         "reading each")
    ap.add_argument("--device", default="cuda" if torch.cuda.is_available()
                    else "cpu")
    args = ap.parse_args(argv)
    exact_sums()
    for seed in args.seed:
        report(args, seed, grad_gate(
            args.model, canonical_dtype(args.dtype),
            torch.device(args.device), args.batch, args.channel_scale,
            tuple(args.layer), seed))
    return 0


def report(args, seed: int, gate: dict) -> None:

    def per_net(r):
        return ", ".join(f"{n} {r[n]:.4f}" for n in GRAD_PARTS)
    print(f"{args.model} {args.dtype} batch {args.batch} seed {seed} on "
          f"{args.device}: "
          f"||g_plain - g32|| / ||g32|| {per_net(gate['plain_rel'])}; "
          f"kernel path {per_net(gate['ratio'])} (worst tensor "
          f"{gate['tensor_ratio']:.4f} at {gate['tensor_worst']})")
    for layer, f in gate["faults"].items():
        seen = max(f["ratio"][n] for n in GRAD_GATED) > PATH_ACCURACY
        print(f"  planted fault at {layer}'s dx ({f['calls']} calls): "
              f"{per_net(f['ratio'])} (gate {PATH_ACCURACY}: "
              f"{'seen' if seen else 'NOT seen'})")
    print("per layer (weight and bias): ||g_plain - g32|| / ||g32||, the "
          "kernel path's ratio, each fault's ratio")
    for n, r in gate["layers"].items():
        print(f"  {n:6s} {gate['plain_layer_rel'][n]:.3e} {r:.4f} " + " ".join(
            f"{layer}:{f['layers'][n]:.4f}"
            for layer, f in gate["faults"].items()))


if __name__ == "__main__":
    sys.exit(main())
