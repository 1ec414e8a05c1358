"""Roofline terms of the dry-run's cells on the H100 (the port of
``repro.utils.roofline`` and of ``benchmarks/roofline.py``'s table).

Terms, in seconds a step a GPU (each artifact counts one rank's step,
``launch/dryrun.py``):

  compute    = counted FLOPs / peak FLOP/s
  memory     = counted HBM bytes / HBM bytes/s
  collective = NVLink bytes (all-reduce counted twice, for a ring) /
               NVLink bytes/s
  dcn        = bytes of the collectives whose group spans two nodes /
               network bytes/s a GPU

with the reference's arithmetic (the within-node bytes are the
ring-adjusted total less twice the inter-node bytes).  The constants
are those of the data sheet of the NVIDIA H100 SXM5 80 GB
(:data:`H100`): 989 TFLOP/s of dense bf16 on the tensor cores, 3.35 TB/s
of HBM3, 450 GB/s a direction of NVLink between the 8 GPUs of a node,
and 50 GB/s a GPU between nodes (one 400 Gb/s NDR InfiniBand link a
GPU).  They are counts at data-sheet rates, not measurements.

``MODEL_FLOPS`` = 6·N·D (dense) or 6·N_active·D (MoE), from the config;
``useful_ratio`` = MODEL / counted FLOPs flags recompute and dispatch
waste, and ``mfu_bound`` = MODEL-compute time / the largest term is the
share of the peak the counted program permits.

``python -m repro_torch.utils.roofline [--dir DIR]`` prints the table.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os

from repro_torch.launch.dryrun import ARTIFACT_DIR

__all__ = ["Consts", "H100", "RooflineRow", "analyze_artifact",
           "load_rows", "render", "main"]


@dataclasses.dataclass(frozen=True)
class Consts:
    """A device's rates: ``peak_flops`` (FLOP/s), ``hbm_bw``,
    ``ici_bw`` (within a node) and ``dcn_bw`` (across nodes), in
    bytes/s."""
    name: str
    peak_flops: float
    hbm_bw: float
    ici_bw: float
    dcn_bw: float


# the H100 SXM5 80 GB data sheet: dense bf16 on the tensor cores, HBM3,
# NVLink 4 (900 GB/s both directions), NDR InfiniBand (400 Gb/s a GPU)
H100 = Consts("H100 SXM5 80GB data sheet", peak_flops=989e12,
              hbm_bw=3.35e12, ici_bw=450e9, dcn_bw=50e9)


@dataclasses.dataclass
class RooflineRow:
    arch: str
    shape: str
    mesh: str
    status: str
    reason: str = ""
    compute_s: float = 0.0
    memory_s: float = 0.0
    collective_s: float = 0.0
    dcn_s: float = 0.0
    dominant: str = ""
    model_flops_global: float = 0.0
    hlo_flops_global: float = 0.0
    useful_ratio: float = 0.0
    mfu_bound: float = 0.0
    temp_gb: float = 0.0
    compile_s: float = 0.0
    note: str = ""

    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s,
                   self.dcn_s)


_MOVE_NOTE = {
    "compute": "reduce recompute (remat policy) / skip masked causal work",
    "memory": "shrink resident working set (int8 cache, smaller dispatch "
              "buffers, fused one-hot)",
    "collective": "reshard to cut per-layer gathers / overlap with compute"
                  " (collective matmul)",
    "dcn": "compress node-crossing gradients (int8 + error feedback)",
}


def analyze_artifact(art: dict, consts: Consts = H100) -> RooflineRow:
    """The roofline row of one artifact (the port's ``op_counts``, or a
    reference artifact's ``hlo_parsed``) at ``consts``' rates."""
    if art.get("status") != "ok":
        return RooflineRow(arch=art["arch"], shape=art["shape"],
                           mesh=art.get("mesh", "?"),
                           status=art.get("status", "error"),
                           reason=art.get("reason", art.get("error", "")))
    hp = art["op_counts"] if "op_counts" in art else art["hlo_parsed"]
    n_dev = art["n_devices"]
    coll = hp["collective_bytes"]
    ring_adjusted = sum(v * (2.0 if k == "all-reduce" else 1.0)
                        for k, v in coll.items())
    dcn = hp.get("collective_dcn_bytes", 0.0)
    ici = max(0.0, ring_adjusted - 2.0 * dcn)
    meta = art["meta"]
    model_flops = meta["model_flops_per_token"] * meta["tokens_per_step"]
    hlo_global = hp["flops"] * n_dev
    row = RooflineRow(
        arch=art["arch"], shape=art["shape"], mesh=art["mesh"], status="ok",
        compute_s=hp["flops"] / consts.peak_flops,
        memory_s=hp["bytes"] / consts.hbm_bw,
        collective_s=ici / consts.ici_bw,
        dcn_s=dcn / consts.dcn_bw,
        model_flops_global=model_flops,
        hlo_flops_global=hlo_global,
        useful_ratio=model_flops / hlo_global if hlo_global else 0.0,
        temp_gb=(art["memory_analysis"]["temp_bytes"] or 0) / 2**30,
        compile_s=art.get("compile_s", 0.0),
    )
    terms = {"compute": row.compute_s, "memory": row.memory_s,
             "collective": row.collective_s, "dcn": row.dcn_s}
    row.dominant = max(terms, key=terms.get)
    model_time = (model_flops / n_dev) / consts.peak_flops
    row.mfu_bound = model_time / row.bound_s() if row.bound_s() else 0.0
    row.note = _MOVE_NOTE[row.dominant]
    return row


def load_rows(artifact_dir: str | None = None,
              consts: Consts = H100) -> list[RooflineRow]:
    """The rows of every artifact in ``artifact_dir`` (default
    ``launch.dryrun.ARTIFACT_DIR``), in file-name order."""
    d = artifact_dir or ARTIFACT_DIR
    rows = []
    for path in sorted(glob.glob(os.path.join(d, "*.json"))):
        with open(path) as f:
            rows.append(analyze_artifact(json.load(f), consts))
    return rows


def render(rows, title: str = f"Roofline (per GPU, {H100.name} "
           f"constants; counts, not measurements)") -> list[tuple]:
    """Print the table of ``rows``; returns ``(name, mfu_bound, note)``
    a row, as the reference's ``benchmarks/roofline.py``."""
    print(f"\n== {title} ==")
    hdr = (f"{'arch':24s} {'shape':11s} {'mesh':8s} {'compute':>9s} "
           f"{'memory':>9s} {'coll':>9s} {'dcn':>9s} {'bound':>10s} "
           f"{'useful':>7s} {'mfu≤':>6s} {'tempGB':>7s}")
    print(hdr)
    out = []
    for r in sorted(rows, key=lambda r: (r.arch, r.shape, r.mesh)):
        if r.status != "ok":
            what = "SKIP" if r.status == "skipped" else r.status.upper()
            print(f"{r.arch:24s} {r.shape:11s} {r.mesh:8s} "
                  f"{what}: {r.reason}")
            out.append((f"roofline/{r.arch}/{r.shape}/{r.mesh}", 0.0,
                        f"{r.status}: {r.reason}"))
            continue
        print(f"{r.arch:24s} {r.shape:11s} {r.mesh:8s} "
              f"{r.compute_s:9.4f} {r.memory_s:9.4f} "
              f"{r.collective_s:9.4f} {r.dcn_s:9.4f} "
              f"{r.dominant:>10s} {r.useful_ratio:7.2f} "
              f"{r.mfu_bound:6.2f} {r.temp_gb:7.1f}")
        out.append((f"roofline/{r.arch}/{r.shape}/{r.mesh}/mfu_bound",
                    r.mfu_bound, f"dominant={r.dominant}"))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="The roofline table of the "
                                 "dry-run's artifacts at the H100's "
                                 "data-sheet constants.")
    ap.add_argument("--dir", default=None,
                    help=f"the artifacts (default {ARTIFACT_DIR})")
    args = ap.parse_args(argv)
    rows = load_rows(args.dir)
    if not rows:
        print("no dry-run artifacts found; run `python -m "
              "repro_torch.launch.dryrun --all` first")
        return 1
    render(rows)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
