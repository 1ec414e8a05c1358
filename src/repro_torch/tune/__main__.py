"""``python -m repro_torch.tune`` — tune the Table-I GAN model zoo on the
card and write the tuned-against-heuristic times per model.

Typical use::

    PYTHONPATH=src python -m repro_torch.tune --models dcgan \\
        --batch 64 --channel-scale 1 --plans plans.json
    PYTHONPATH=src python -m repro_torch.tune --device cpu --no-e2e

The plan file (``--plans``) is the persistent cache: a second run with
a warm file measures nothing and only re-times the generators.  Point
``REPRO_TUNE_PLANS`` at the same file, and training and serving
processes pick the plans up with ``backend="auto"``.  The payload goes
to ``--out`` (default ``build/tune/tune.json``, inside the git-ignored
build directory; the repository's ``BENCH_tune.json`` is the
reference's and this CLI never writes it).
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

from repro_torch.configs.gans import GAN_MODELS
from repro_torch.core.dataflow import available_backends

DEFAULT_OUT = "build/tune/tune.json"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.tune",
        description="Measure per-layer backend and GANAX kernel-route "
                    "plans for the Table-I GAN model zoo.")
    ap.add_argument("--models", nargs="+", default=sorted(GAN_MODELS),
                    choices=sorted(GAN_MODELS),
                    help="models to tune (default: the whole zoo)")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--channel-scale", type=float, default=0.25,
                    help="shrink channels for a quick measurement")
    ap.add_argument("--backends", nargs="+", default=None,
                    help="restrict the candidate backend pool "
                         f"(registered: {', '.join(available_backends())};"
                         " default: the platform's)")
    ap.add_argument("--warmup", type=int, default=1)
    ap.add_argument("--repeats", type=int, default=3,
                    help="timed runs per candidate (median reported)")
    ap.add_argument("--plans", default=None, metavar="PATH",
                    help="persistent JSON plan file (default: in memory)")
    ap.add_argument("--out", default=DEFAULT_OUT, metavar="PATH")
    ap.add_argument("--device", default="cuda",
                    help="where to measure: cuda (default) or cpu")
    ap.add_argument("--no-e2e", action="store_true",
                    help="skip the end-to-end generator timings")
    args = ap.parse_args(argv)

    if args.backends:
        unknown = set(args.backends) - set(available_backends())
        if unknown:
            ap.error(f"unknown backends {sorted(unknown)}; "
                     f"registered: {available_backends()}")
    out = pathlib.Path(args.out)

    from repro_torch.device import resolve_device
    from repro_torch.tune.planner import Planner
    from repro_torch.tune.zoo import tune_model_zoo

    device = resolve_device(args.device)
    planner = Planner(args.plans, backends=args.backends,
                      warmup=args.warmup, repeats=args.repeats)
    if planner.load_error:
        print(f"warning: plan file ignored ({planner.load_error})")

    print(f"== repro_torch.tune: {len(args.models)} models, "
          f"batch={args.batch}, channels×{args.channel_scale}, "
          f"on {device} ==")
    bench = tune_model_zoo(args.models, planner, batch=args.batch,
                           channel_scale=args.channel_scale,
                           warmup=args.warmup, repeats=args.repeats,
                           end_to_end=not args.no_e2e, device=device)
    stats = planner.stats()
    bench["_meta"] = {
        "batch": args.batch,
        "channel_scale": args.channel_scale,
        "repeats": args.repeats,
        "device": str(device),
        "planner": stats,
        "plan_file": args.plans,
    }
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(bench, indent=2, sort_keys=True) + "\n")
    print(f"planner: {stats['plans']} plans, "
          f"{stats['measurements']} measurements this run, "
          f"{stats['failures']} failed candidates")
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
