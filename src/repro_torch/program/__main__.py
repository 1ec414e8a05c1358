"""``python -m repro_torch.program`` — build, describe, export and load
ahead-of-time resolved GAN programs.

Typical use::

    PYTHONPATH=src python -m repro_torch.program dcgan
    PYTHONPATH=src python -m repro_torch.program dcgan --role generator \
        --export dcgan-program.json
    PYTHONPATH=src python -m repro_torch.program dcgan \
        --load dcgan-program.json --stats
    PYTHONPATH=src python -m repro_torch.program dcgan --dtype bf16 \
        --quantize int8 --export dcgan-int8.json

The first form is the smoke: resolving the whole spec touches no
tensors and launches nothing.  ``--load`` reads a file written by this
CLI or by the reference's ``python -m repro.program`` (its backends
mapped to the port's), falling back to fresh resolution when the file
is corrupt or stale.  ``--stats`` prints the resolution-counter deltas
of the invocation from the ``repro_torch.obs`` registry.  ``--dtype``
freezes the storage precision, and ``--quantize int8`` with
``--export`` embeds int8 weights from a seed-0 init of the model (the
reference's export flow; a deployment calls
:func:`repro_torch.quant.quantize_program` on trained parameters).
``--backend auto`` resolves each layer through the autotuning planner
(``--plans`` names its plan file, default ``$REPRO_TUNE_PLANS`` or in
memory); ``--measure`` tunes the plan misses while building, on the
card when there is one (else on the CPU), so the export carries the
tuned backends and kernel routes::

    PYTHONPATH=src python -m repro_torch.program dcgan --role generator \
        --backend auto --measure --plans plans.json --export tuned.json

``--mesh DATAxMODEL`` freezes a mesh into the spec.  Run as one process
it describes the frozen layout (each layer's ``@cout`` or data
sharding); run under a process group of ``data·model`` ranks (a caller
that initialised one, or ``torchrun``, whose ``RANK`` / ``WORLD_SIZE``
environment it reads) it also builds each role's sharded program on
every rank and prints the rank's place on the mesh::

    torchrun --nproc-per-node 2 -m repro_torch.program dcgan --mesh 1x2
"""

from __future__ import annotations

import argparse
import os
import sys

from repro_torch.configs.gans import GAN_MODELS
from repro_torch.core.dataflow import DataflowPolicy, available_backends
from repro_torch.device import default_platform


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.program",
        description="Build, describe, export/load, and (--stats) "
                    "account the resolution of an ahead-of-time "
                    "resolved GAN program of the PyTorch port.")
    ap.add_argument("model", choices=sorted(GAN_MODELS))
    ap.add_argument("--role", default="both",
                    choices=("generator", "discriminator", "both"))
    ap.add_argument("--batch", type=int, default=8,
                    help="planning batch (provenance; apply() accepts "
                         "any batch)")
    ap.add_argument("--channel-scale", type=float, default=1.0)
    ap.add_argument("--mesh", default=None, metavar="DATAxMODEL",
                    help="freeze a (data, model) device mesh into the "
                         "spec, e.g. 4x2; under a process group of that "
                         "many ranks, build the sharded programs too")
    ap.add_argument("--dtype", default=None,
                    help="storage precision frozen into the spec: "
                         "float32 (default), bfloat16, or float16 "
                         "(aliases f32/bf16/f16 accepted); "
                         "accumulation is always f32")
    ap.add_argument("--backend", default=None,
                    help="policy backend (a port or reference name, "
                         f"'pallas', or 'auto'; registered: "
                         f"{', '.join(available_backends())}; default: "
                         "heuristic)")
    ap.add_argument("--plans", default=None, metavar="PATH",
                    help="autotuner plan file consulted by --backend auto "
                         "(a file of either package)")
    ap.add_argument("--measure", action="store_true",
                    help="with --backend auto: tune plan misses while "
                         "building (without it, resolution is lookup-only "
                         "and a cold planner exports heuristic layers)")
    ap.add_argument("--quantize", default=None, choices=("int8",),
                    help="with --export: embed per-channel symmetric "
                         "int8 weights (+ f32 scales) in the program "
                         "file, from a seed-0 init of the model")
    ap.add_argument("--export", default=None, metavar="PATH",
                    help="write the (first-role) spec JSON here")
    ap.add_argument("--load", default=None, metavar="PATH",
                    help="load a program file instead of resolving "
                         "(falls back to fresh resolution when "
                         "corrupt/stale)")
    ap.add_argument("--stats", action="store_true",
                    help="after describing, print the resolution "
                         "metrics this invocation produced")
    args = ap.parse_args(argv)

    from repro_torch import obs
    from repro_torch.models.gan import GanConfig
    from repro_torch.program import ProgramSpec, load_or_build

    counters0 = dict(obs.snapshot()["counters"]) if args.stats else {}
    planner = None
    if args.plans:
        from repro_torch.tune import Planner
        planner = Planner(args.plans)
        if planner.load_error:
            print(f"warning: plan file ignored ({planner.load_error})")
    mesh = None
    if args.mesh:
        try:
            data, model = args.mesh.lower().split("x")
            mesh = (int(data), int(model))
        except ValueError:
            ap.error(f"--mesh wants DATAxMODEL (e.g. 4x2), "
                     f"got {args.mesh!r}")
    try:
        cfg = GanConfig(name=args.model, channel_scale=args.channel_scale,
                        backend=args.backend, mesh=mesh,
                        dtype=args.dtype or "float32")
    except ValueError as e:
        ap.error(str(e))
    if args.quantize and not args.export:
        ap.error("--quantize only makes sense with --export")
    policy = DataflowPolicy(backend=args.backend) if args.backend \
        else None
    roles = (args.role,) if args.role != "both" \
        else ("generator", "discriminator")
    if args.load and args.role == "both":
        # a program file freezes one network; describe that one (a
        # corrupt file keeps the generator default and falls back)
        try:
            roles = (ProgramSpec.load(args.load).role,)
        except Exception:
            roles = ("generator",)

    ranked, owned = _process_group() if mesh is not None else (False,
                                                                False)
    exported = False
    for role in roles:
        if args.load:
            # binding a program touches no tensors; the card's when
            # there is one, so that a rebuild measures where it will run
            prog, loaded = load_or_build(
                args.load, cfg, args.batch, role, policy=policy,
                planner=planner, measure=args.measure,
                device="cpu" if default_platform() == "cpu" else "cuda")
            if not loaded:
                print(f"note: {args.load} unusable for "
                      f"{args.model}/{role}; rebuilt from config")
            spec = prog.spec
        else:
            spec = ProgramSpec.build(cfg, args.batch, role, policy=policy,
                                     planner=planner, measure=args.measure)
        print(spec.describe())
        if ranked:
            from repro_torch.program import Program
            prog = Program(spec, differentiable=False,
                           device="cpu" if default_platform() == "cpu"
                           else "cuda")
            axes = prog.axes
            where = "" if axes is None else \
                f" (this rank: data {axes.data}, model {axes.model})"
            print(f"sharded: mesh {prog.mesh_str} over "
                  f"{prog.device_count} ranks{where}")
        if args.export and not exported:
            if args.quantize:
                import torch

                from repro_torch.models.gan import init_gan
                from repro_torch.quant import quantize_program
                g_params, d_params = init_gan(
                    cfg, torch.Generator().manual_seed(0), device="cpu")
                spec = quantize_program(
                    spec, g_params if spec.role == "generator"
                    else d_params)
            spec.save(args.export)
            print(f"wrote {args.export}"
                  + (" (int8 weights embedded)" if args.quantize else ""))
            exported = True
        if role != roles[-1]:
            print()
    if args.stats:
        counters = obs.snapshot()["counters"]
        deltas = {k: v - counters0.get(k, 0)
                  for k, v in sorted(counters.items())
                  if v - counters0.get(k, 0)
                  and (k.startswith("dataflow.resolve")
                       or k.startswith("program."))}
        print("\nresolution stats:")
        for name, v in deltas.items():
            print(f"  {name:36s} {v}")
        if not deltas:
            print("  (none)")
    if owned:
        import torch.distributed as dist
        dist.destroy_process_group()
    return 0


def _process_group() -> tuple[bool, bool]:
    """Whether this process is a rank of a process group (one a caller
    initialised, or one this call initialises from ``torchrun``'s
    environment, ``RANK`` and ``WORLD_SIZE``: gloo on the CPU, NCCL on
    the card), and whether this call initialised it."""
    import torch.distributed as dist
    if dist.is_initialized():
        return True, False
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return False, False
    if default_platform() == "cpu":
        dist.init_process_group("gloo")
    else:
        import torch
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group("nccl")
    return True, True


if __name__ == "__main__":
    sys.exit(main())
