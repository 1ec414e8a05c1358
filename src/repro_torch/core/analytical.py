"""Analytical cycle/energy model reproducing the paper's evaluation.

A numpy-only copy of ``repro.core.analytical``: the port imports nothing
of the JAX package, and the parity tests hold the two copies equal field
by field (the same arithmetic in the same order, so the reports are
bit-equal).  ``ConvLayer`` is also the layer record of the GAN
topologies (``configs/gans.py``) that drive the port's executable models.

The paper evaluates GANAX with a cycle-level simulator over an EYERISS-like
16×16 PE array at 500 MHz, with TSMC-45nm energy numbers (Table II).  This
module implements that methodology in closed form so the paper's figures can
be reproduced quantitatively (``python -m repro_torch.paper_figs``); every
figure it yields is an output of this model of the paper's 45 nm
accelerator, not a measurement of any chip:

* Fig. 1 — fraction of inconsequential MACs per model (pure geometry; exact).
* Fig. 8 — speedup and energy reduction of generative models vs EYERISS.
* Fig. 9 — runtime/energy split between generative and discriminative models.
* Fig. 10 — energy breakdown by microarchitectural unit.
* Fig. 11 — PE utilization, EYERISS vs GANAX.

Model assumptions (documented per the paper's text):

* EYERISS baseline executes the transposed conv by sliding over the
  **zero-inserted** input: every (consequential or not) MAC occupies a PE
  cycle.  Zero-gating saves the *arithmetic* energy of inconsequential MACs
  (the paper: "EYERISS exploits data gating … but still wastes cycles")
  but register-file reads and the occupied cycle remain.
* GANAX executes only consequential MACs; PV load imbalance (different tap
  counts per phase) is computed exactly from the schedule; MIMD execution
  overlaps phase programs so the makespan is the balanced maximum over PVs.
* Horizontal partial-sum accumulation costs ``taps_y`` inter-PE hops per
  output-row wave (paper Fig. 4/5: 5 cycles → 2/3 cycles after
  reorganization).
* Memory traffic: the baseline streams the zero-inserted input through
  DRAM→global-buffer→RF (the zeros are materialized, as a conventional
  accelerator requires); GANAX streams the compact input.  Both stream
  weights once per output-tile wave and outputs once.
* Energy/bit numbers are Table II verbatim; 16-bit fixed-point datapath.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

import numpy as np

from repro_torch.core.scheduler import PhaseSchedule, make_schedule

__all__ = [
    "EnergyTable",
    "AcceleratorConfig",
    "ConvLayer",
    "LayerReport",
    "analyze_layer",
    "analyze_model",
]


@dataclasses.dataclass(frozen=True)
class EnergyTable:
    """Table II: energy per bit (pJ) in TSMC 45nm."""
    rf: float = 0.20           # register file access
    pe: float = 0.36           # 16-bit fixed-point MAC (incl. μindex gens)
    inter_pe: float = 0.40     # inter-PE communication
    gbuf: float = 1.20         # global buffer access
    dram: float = 15.00        # DDR4 access


@dataclasses.dataclass(frozen=True)
class AcceleratorConfig:
    """§V architecture configuration (same array for EYERISS & GANAX)."""
    n_pvs: int = 16
    pes_per_pv: int = 16
    freq_hz: float = 500e6
    bits: int = 16

    @property
    def n_pes(self) -> int:
        return self.n_pvs * self.pes_per_pv


@dataclasses.dataclass(frozen=True)
class ConvLayer:
    """One (transposed) convolution layer of a GAN.

    For ``transposed=True`` the geometry follows ``core.scheduler``;
    for plain convs ``strides`` is the downsampling stride.
    """
    name: str
    in_spatial: tuple[int, ...]
    kernel: tuple[int, ...]
    strides: tuple[int, ...]
    paddings: tuple[int, ...]
    cin: int
    cout: int
    transposed: bool = True
    batch: int = 1

    def schedule(self) -> PhaseSchedule:
        if not self.transposed:
            raise ValueError("schedule() only applies to transposed layers")
        return make_schedule(self.in_spatial, self.kernel, self.strides,
                             self.paddings)

    def conv_out_spatial(self) -> tuple[int, ...]:
        assert not self.transposed
        return tuple((n + 2 * p - k) // s + 1
                     for n, k, s, p in zip(self.in_spatial, self.kernel,
                                           self.strides, self.paddings))


@dataclasses.dataclass
class LayerReport:
    layer: ConvLayer
    total_macs: int                 # zero-inserted dataflow MACs
    consequential_macs: int
    cycles_baseline: float
    cycles_ganax: float
    energy_baseline_pj: dict[str, float]
    energy_ganax_pj: dict[str, float]
    util_baseline: float
    util_ganax: float

    @property
    def speedup(self) -> float:
        return self.cycles_baseline / self.cycles_ganax

    @property
    def energy_reduction(self) -> float:
        return (sum(self.energy_baseline_pj.values()) /
                sum(self.energy_ganax_pj.values()))

    @property
    def inconsequential_fraction(self) -> float:
        return 1.0 - self.consequential_macs / self.total_macs


def _pv_balance(sched: PhaseSchedule, acc: AcceleratorConfig) -> float:
    """Makespan inflation from PV load imbalance under MIMD scheduling.

    Rows (y-phase groups, longest first) are dealt to PVs in contiguous
    runs; returns max-PV-work / mean-PV-work (≥ 1).  Longest-first dealing
    keeps this near 1 for realistic sizes.
    """
    if sched.n_dims < 2:
        return 1.0
    y_dims = sched.dims[0]
    x_dims = sched.dims[1]
    per_row_work = {pd.phase: pd.n_taps * sum(xd.n_taps * xd.out_size
                                              for xd in x_dims)
                    for pd in y_dims}
    rows = []
    for pd in sorted(y_dims, key=lambda p: p.n_taps, reverse=True):
        rows.extend([per_row_work[pd.phase]] * pd.out_size)
    # LPT (longest processing time) assignment to PVs.
    loads = np.zeros(acc.n_pvs)
    for w in rows:
        loads[np.argmin(loads)] += w
    mean = loads.mean()
    return float(loads.max() / mean) if mean > 0 else 1.0


def analyze_layer(layer: ConvLayer,
                  acc: AcceleratorConfig = AcceleratorConfig(),
                  energy: EnergyTable = EnergyTable()) -> LayerReport:
    """Cycle + energy model for one layer under both dataflows."""
    b = layer.batch
    sched = layer.schedule() if layer.transposed else None
    if layer.transposed:
        total = sched.zero_inserted_macs(layer.cin, layer.cout, b)
        conseq = sched.consequential_macs(layer.cin, layer.cout, b)
        out_sizes = sched.out_sizes
    else:
        out_sizes = layer.conv_out_spatial()
        total = conseq = (int(np.prod(out_sizes)) *
                          int(np.prod(layer.kernel)) *
                          layer.cin * layer.cout * b)

    bits = acc.bits
    n_pes = acc.n_pes

    # ---- cycles ------------------------------------------------------------
    # Baseline: all MACs occupy cycles; EYERISS conv mapping utilization on a
    # dense conv is taken as 1.0 at this granularity (its conv dataflow is
    # the reference point the paper normalizes to).  Horizontal accumulation:
    # K_y hops per output-row wave.
    out_pix = int(np.prod(out_sizes)) * b
    waves = out_pix * layer.cout / n_pes
    ky = layer.kernel[0]
    cycles_base = total / n_pes + waves * ky

    # GANAX: consequential MACs, inflated by PV imbalance; accumulation
    # shortens to the per-phase tap count.
    imbalance = _pv_balance(sched, acc) if layer.transposed else 1.0
    if layer.transposed and sched.n_dims >= 1:
        y_dims = sched.dims[0]
        mean_taps_y = (sum(pd.n_taps * pd.out_size for pd in y_dims) /
                       max(1, sum(pd.out_size for pd in y_dims)))
    else:
        mean_taps_y = ky
    cycles_ganax = conseq / n_pes * imbalance + waves * mean_taps_y

    # ---- energy (pJ) --------------------------------------------------------
    # Per-MAC register file traffic: 2 operand reads + 1 partial-sum
    # read-modify-write ≈ 4 RF accesses of `bits` bits.
    rf_per_mac = 4 * bits * energy.rf
    pe_per_mac = bits * energy.pe
    hop = bits * energy.inter_pe

    # Data volumes (bits).
    in_bits_ganax = int(np.prod(layer.in_spatial)) * layer.cin * b * bits
    if layer.transposed:
        exp_pix = int(np.prod([s * (n - 1) + 1 + 2 * (k - 1 - p)
                               for n, s, k, p in zip(sched.in_sizes,
                                                     sched.strides,
                                                     sched.kernel,
                                                     sched.paddings)]))
        in_bits_base = exp_pix * layer.cin * b * bits      # zeros included
    else:
        in_bits_base = in_bits_ganax
    w_bits = int(np.prod(layer.kernel)) * layer.cin * layer.cout * bits
    out_bits = out_pix * layer.cout * bits

    # Global buffer: inputs re-read once per filter-row (row-stationary
    # vertical reuse covers the PE set, horizontal re-fetch per ky), weights
    # once per input-tile wave, outputs once.
    gb_base = (in_bits_base * ky + w_bits * max(1, waves / layer.cout)
               + out_bits) * energy.gbuf
    gb_ganax = (in_bits_ganax * mean_taps_y
                + w_bits * max(1, waves / layer.cout) + out_bits
                ) * energy.gbuf
    # DRAM: each tensor streamed once; the baseline streams the expanded
    # input (zeros materialized by the zero-insertion stage).
    dram_base = (in_bits_base + w_bits + out_bits) * energy.dram
    dram_ganax = (in_bits_ganax + w_bits + out_bits) * energy.dram
    # Inter-PE: one hop per MAC's partial-sum forward (horizontal
    # accumulation), charged per executed (cycle-occupying) MAC.
    inter_base = total * hop
    inter_ganax = conseq * hop
    # RF: baseline pays RF for every occupied cycle (zeros are fetched, then
    # gated); PE arithmetic energy only for consequential MACs (data gating).
    e_base = {
        "rf": total * rf_per_mac,
        "pe": conseq * pe_per_mac,
        "inter_pe": inter_base,
        "gbuf": gb_base,
        "dram": dram_base,
    }
    e_ganax = {
        "rf": conseq * rf_per_mac,
        "pe": conseq * pe_per_mac,
        "inter_pe": inter_ganax,
        "gbuf": gb_ganax,
        "dram": dram_ganax,
    }

    util_base = conseq / (cycles_base * n_pes)
    util_ganax = conseq / (cycles_ganax * n_pes)
    return LayerReport(layer=layer, total_macs=total,
                       consequential_macs=conseq,
                       cycles_baseline=cycles_base,
                       cycles_ganax=cycles_ganax,
                       energy_baseline_pj=e_base, energy_ganax_pj=e_ganax,
                       util_baseline=util_base, util_ganax=util_ganax)


@dataclasses.dataclass
class ModelReport:
    name: str
    generator: list[LayerReport]
    discriminator: list[LayerReport]

    def _agg(self, reports: list[LayerReport], field: str) -> float:
        return sum(getattr(r, field) for r in reports)

    @property
    def gen_speedup(self) -> float:
        return (self._agg(self.generator, "cycles_baseline") /
                self._agg(self.generator, "cycles_ganax"))

    @property
    def gen_energy_reduction(self) -> float:
        base = sum(sum(r.energy_baseline_pj.values())
                   for r in self.generator)
        gx = sum(sum(r.energy_ganax_pj.values()) for r in self.generator)
        return base / gx

    @property
    def gen_inconsequential_fraction(self) -> float:
        t = self._agg(self.generator, "total_macs")
        c = self._agg(self.generator, "consequential_macs")
        return 1.0 - c / t if t else 0.0

    def utilization(self, which: Literal["baseline", "ganax"]) -> float:
        field = f"util_{which}"
        # cycle-weighted mean over generator layers
        cfield = ("cycles_baseline" if which == "baseline"
                  else "cycles_ganax")
        cyc = self._agg(self.generator, cfield)
        return sum(getattr(r, field) * getattr(r, cfield)
                   for r in self.generator) / cyc if cyc else 0.0

    def energy_breakdown(self, which: Literal["baseline", "ganax"]) -> dict:
        key = ("energy_baseline_pj" if which == "baseline"
               else "energy_ganax_pj")
        out: dict[str, float] = {}
        for r in self.generator:
            for k, v in getattr(r, key).items():
                out[k] = out.get(k, 0.0) + v
        return out

    def runtime_split(self, which: Literal["baseline", "ganax"]) -> dict:
        cfield = ("cycles_baseline" if which == "baseline"
                  else "cycles_ganax")
        return {
            "generative": self._agg(self.generator, cfield),
            "discriminative": self._agg(self.discriminator, cfield),
        }


def analyze_model(name: str, gen_layers: list[ConvLayer],
                  disc_layers: list[ConvLayer],
                  acc: AcceleratorConfig = AcceleratorConfig(),
                  energy: EnergyTable = EnergyTable()) -> ModelReport:
    return ModelReport(
        name=name,
        generator=[analyze_layer(l, acc, energy) for l in gen_layers],
        discriminator=[analyze_layer(l, acc, energy) for l in disc_layers],
    )
