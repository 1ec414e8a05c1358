"""The dry-run of the production cells (the port of
``repro.launch.dryrun``).

For every supported (architecture × input shape) cell this builds the
step as ONE rank of the production mesh (16×16, or 2×16×16 with
``multi_pod``) and runs it once on ``meta`` tensors, which allocate
nothing: no card is needed.  The reference forces 256 or 512 host
devices and compiles the whole SPMD program; the port runs this process
as rank ``r`` of a ``torch.distributed`` process group on the built-in
``"fake"`` backend (its collectives return at once), builds
``launch.mesh.make_production_mesh`` over it, and counts what rank
``r`` would run on the H100 (``utils/opcount.py``): FLOPs, HBM bytes,
collective bytes, and argument, output and peak memory.  Each cell
writes one JSON artifact under ``artifacts/dryrun_torch/``, with the
reference's keys (``op_counts`` in place of ``hlo_parsed``, with its
fields; ``compile_s`` is the count's seconds); ``utils/roofline.py``
reads them.  With ``allow_uneven=False`` every rank holds blocks of
one shape, so rank 0 stands for all of them.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-7b \\
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

A cell that ``cell_supported`` rejects gets a ``skipped`` artifact; a
cell the port cannot build or run an ``error`` artifact with the
exception, and the command then exits 1.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback

import torch.distributed as dist

from repro_torch.configs.base import (SHAPES, cell_supported, get_config,
                                      list_configs)
from repro_torch.launch.mesh import (make_production_mesh,
                                     production_mesh_shape)
from repro_torch.launch.specs import build_cell
from repro_torch.utils.opcount import GPUS_PER_NODE, count

__all__ = ["run_cell", "artifact_path", "mesh_name", "main",
           "ARTIFACT_DIR"]

ARTIFACT_DIR = os.path.normpath(os.path.join(
    os.path.dirname(__file__), "..", "..", "..", "artifacts",
    "dryrun_torch"))


def mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def _fake_group(rank: int, world: int) -> None:
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)


def run_cell(arch: str, shape: str, multi_pod: bool, rank: int = 0
             ) -> dict:
    """Count one cell as rank ``rank`` of the production mesh and return
    its artifact (``status`` ``"ok"``).  Starts the fake process group
    of 256 (512) ranks and destroys it on the way out; raises what the
    port raises for a cell it cannot build or run.  A collective whose
    group spans two nodes of ``GPUS_PER_NODE`` ranks counts under
    ``collective_dcn_bytes``."""
    world = math.prod(production_mesh_shape(multi_pod)[0])
    if dist.is_initialized():
        raise RuntimeError("run_cell starts its own process group; one is "
                           "already initialised")
    _fake_group(rank, world)
    try:
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        t0 = time.perf_counter()
        plan = build_cell(arch, shape, mesh)
        args = plan.local_args()
        t_build = time.perf_counter() - t0
        rec = count(plan.fn, *args, stride=GPUS_PER_NODE)
    finally:
        dist.destroy_process_group()
    return {
        "arch": arch,
        "shape": shape,
        "mesh": mesh_name(multi_pod),
        "n_devices": world,
        "rank": rank,
        "meta": plan.meta,
        "lower_s": round(t_build, 2),
        "compile_s": round(rec.seconds, 2),
        "memory_analysis": dict(rec.memory),
        "op_counts": rec.to_json(),
        "node_stride": GPUS_PER_NODE,
        "status": "ok",
    }


def artifact_path(arch: str, shape: str, mesh: str,
                  directory: str | None = None) -> str:
    d = directory or ARTIFACT_DIR
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, f"{arch}_{shape}_{mesh}.json")


def _write(path: str, art: dict) -> None:
    with open(path, "w") as f:
        json.dump(art, f, indent=1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--rank", type=int, default=0,
                    help="the rank of the production mesh to count")
    ap.add_argument("--dir", default=None,
                    help=f"where the artifacts go (default {ARTIFACT_DIR})")
    args = ap.parse_args(argv)

    archs = list_configs() if (args.all or args.arch is None) \
        else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) \
        else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    cells = []
    for arch in archs:
        cfg = get_config(arch)
        for shape in shapes:
            ok, why = cell_supported(cfg, SHAPES[shape])
            for mp in meshes:
                name = mesh_name(mp)
                path = artifact_path(arch, shape, name, args.dir)
                if not ok:
                    _write(path, {"arch": arch, "shape": shape,
                                  "mesh": name, "status": "skipped",
                                  "reason": why})
                    print(f"[dryrun] SKIP {arch}×{shape}×{name}: {why}")
                    continue
                if args.skip_existing and os.path.exists(path):
                    print(f"[dryrun] exists {arch}×{shape}×{name}")
                    continue
                cells.append((arch, shape, mp, path))

    n_fail = 0
    t0 = time.perf_counter()
    for arch, shape, mp, path in cells:
        name = mesh_name(mp)
        tag = f"{arch}×{shape}×{name}"
        try:
            art = run_cell(arch, shape, mp, rank=args.rank)
            _write(path, art)
            oc, mem = art["op_counts"], art["memory_analysis"]
            print(f"[dryrun] OK   {tag}: count={art['compile_s']}s "
                  f"flops/dev={oc['flops']:.3e} bytes/dev={oc['bytes']:.3e} "
                  f"coll={sum(oc['collective_bytes'].values()):.3e}B "
                  f"temp={mem['temp_bytes']}")
        except Exception as e:
            n_fail += 1
            _write(path, {"arch": arch, "shape": shape, "mesh": name,
                          "status": "error",
                          "error": f"{type(e).__name__}: {e}"[:2000]})
            print(f"[dryrun] FAIL {tag}: {type(e).__name__}: "
                  f"{str(e)[:300]}")
            traceback.print_exc(limit=3)
    print(f"[dryrun] done: {len(cells) - n_fail}/{len(cells)} counted in "
          f"{time.perf_counter() - t0:.1f} s")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
