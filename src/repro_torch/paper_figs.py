"""Reproductions of the paper's figures (analytical model + ISA machine).

    python -m repro_torch.paper_figs

The port's counterpart of the reference's ``benchmarks/paper_figs.py``,
on the port's numpy copies of the analytical model
(``repro_torch.core.analytical``) and the μop ISA machine
(``repro_torch.core.uop``).  One function per table/figure; each
returns a list of CSV rows ``(name, value, derived)`` and prints a
readable table, the reference's rows and tables.

Every value is an output of the paper's model of its accelerator (a
16×16 PE array at 500 MHz with TSMC 45 nm energies, EYERISS as the
baseline) or of the interpreted ISA machine, computed on the host: no
chip measured any of them, and no time of any device appears here.
"""

from __future__ import annotations

import numpy as np

from repro_torch.configs.gans import GAN_MODELS
from repro_torch.core.analytical import analyze_layer, analyze_model
from repro_torch.core.scheduler import make_schedule
from repro_torch.core.uop import run_tconv_on_machine

HEADER = ("GANAX paper figures: outputs of the analytical cycle/energy "
          "model (16x16 PEs, 500 MHz, TSMC 45 nm, vs EYERISS) and the "
          "interpreted uop machine; no chip measured these")

PAPER_FIG8 = {  # (speedup, energy) headline anchors from the paper text
    "3dgan": (6.1, None), "magan": (1.3, None),
}
PAPER_MEANS = {"speedup": 3.6, "energy": 3.1}


def _reports():
    return {n: analyze_model(n, g, d) for n, (g, d) in GAN_MODELS.items()}


def fig1_inconsequential():
    """Fig. 1: fraction of inconsequential MACs in tconv layers."""
    rows = []
    print("\n== Fig.1: inconsequential MAC fraction (tconv layers) ==")
    for name, (g, _) in GAN_MODELS.items():
        reps = [analyze_layer(l) for l in g if l.transposed]
        t = sum(r.total_macs for r in reps)
        c = sum(r.consequential_macs for r in reps)
        frac = 1 - c / t
        rows.append((f"fig1/{name}", frac, "fraction_inconsequential"))
        print(f"  {name:10s} {frac:6.3f}")
    mean = np.mean([r[1] for r in rows])
    rows.append(("fig1/mean", mean, "paper: >0.60"))
    print(f"  {'mean':10s} {mean:6.3f}  (paper: >0.60)")
    return rows


def fig8_speedup_energy():
    """Fig. 8: speedup and energy reduction vs EYERISS."""
    rows = []
    reports = _reports()
    print("\n== Fig.8: generative-model speedup / energy vs EYERISS ==")
    sp, en = [], []
    for name, r in reports.items():
        s, e = r.gen_speedup, r.gen_energy_reduction
        sp.append(s)
        en.append(e)
        anchor = PAPER_FIG8.get(name, (None, None))[0]
        rows.append((f"fig8/speedup/{name}", s,
                     f"paper≈{anchor}" if anchor else ""))
        rows.append((f"fig8/energy/{name}", e, ""))
        print(f"  {name:10s} speedup={s:5.2f}x  energy={e:5.2f}x"
              + (f"   (paper {anchor}x)" if anchor else ""))
    rows.append(("fig8/speedup/mean", float(np.mean(sp)), "paper 3.6"))
    rows.append(("fig8/energy/mean", float(np.mean(en)), "paper 3.1"))
    print(f"  {'mean':10s} speedup={np.mean(sp):5.2f}x  "
          f"energy={np.mean(en):5.2f}x   (paper 3.6x / 3.1x)")
    return rows


def fig9_breakdown():
    """Fig. 9: runtime split generative vs discriminative, EYERISS→GANAX."""
    rows = []
    print("\n== Fig.9: runtime split (normalized to EYERISS total) ==")
    for name, r in _reports().items():
        b = r.runtime_split("baseline")
        g = r.runtime_split("ganax")
        tot = b["generative"] + b["discriminative"]
        for which, d in (("eyeriss", b), ("ganax", g)):
            gen = d["generative"] / tot
            dis = d["discriminative"] / tot
            rows.append((f"fig9/{name}/{which}/generative", gen, ""))
            rows.append((f"fig9/{name}/{which}/discriminative", dis, ""))
        print(f"  {name:10s} eyeriss G/D={b['generative']/tot:5.2f}/"
              f"{b['discriminative']/tot:5.2f}  ganax G/D="
              f"{g['generative']/tot:5.2f}/{g['discriminative']/tot:5.2f}")
    return rows


def fig10_energy_units():
    """Fig. 10: energy by microarchitectural unit (normalized)."""
    rows = []
    print("\n== Fig.10: energy by unit (GANAX / EYERISS) ==")
    for name, r in _reports().items():
        eb = r.energy_breakdown("baseline")
        eg = r.energy_breakdown("ganax")
        tot = sum(eb.values())
        parts = " ".join(
            f"{k}={eg[k]/tot:4.2f}/{eb[k]/tot:4.2f}" for k in sorted(eb))
        for k in eb:
            rows.append((f"fig10/{name}/{k}", eg[k] / tot,
                         f"baseline={eb[k]/tot:.3f}"))
        print(f"  {name:10s} {parts}")
    return rows


def fig11_utilization():
    """Fig. 11: PE utilization — analytical + measured on the ISA machine."""
    rows = []
    print("\n== Fig.11: PE utilization ==")
    for name, r in _reports().items():
        ub, ug = r.utilization("baseline"), r.utilization("ganax")
        rows.append((f"fig11/{name}/eyeriss", ub, ""))
        rows.append((f"fig11/{name}/ganax", ug, "paper ≈0.9"))
        print(f"  {name:10s} eyeriss={ub:5.2f}  ganax={ug:5.2f}")
    # ISA-machine measurement on a small representative layer
    rng = np.random.default_rng(0)
    sched = make_schedule((16, 16), (4, 4), (2, 2), (1, 1))
    _, st = run_tconv_on_machine(rng.normal(size=(16, 16)),
                                 rng.normal(size=(4, 4)), sched,
                                 n_pvs=4, pes_per_pv=4)
    rows.append(("fig11/machine_16x16_k4s2", st["utilization"],
                 "ISA-machine measured"))
    print(f"  {'machine':10s} measured={st['utilization']:5.2f} "
          f"(16×16 k4 s2 layer, 4×4 array)")
    return rows


def run_all():
    print(HEADER)
    rows = []
    for fn in (fig1_inconsequential, fig8_speedup_energy, fig9_breakdown,
               fig10_energy_units, fig11_utilization):
        rows.extend(fn())
    return rows


if __name__ == "__main__":
    run_all()
