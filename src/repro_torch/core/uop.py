"""Executable model of the GANAX ISA (paper §III-B and §IV).

A *software* model of the accelerator, faithful at the level the paper's
figures describe:

* :class:`StridedIndexGenerator` — the access μ-engine's reconfigurable
  index generator (Fig. 7b): ``Addr/Offset/Step/End/Repeat`` registers and a
  modulo adder, emitting one address per cycle.
* Access μops (``access.cfg``, ``access.start``) and execute μops (``mac``,
  ``repeat``/``mimd.ld``) per §IV; execute μops carry **no address fields**
  — all operand addresses stream from the generators (decoupled
  access-execute).
* :class:`GanaxMachine` — a PV×PE array interpreter.  Each PV runs its own
  μop stream (MIMD across PVs) while all PEs inside a PV execute the same
  μop on different data (SIMD).  Running the same program in *SIMD-lockstep*
  mode (every global step waits for the slowest PV) models a conventional
  accelerator on the same reorganized dataflow, quantifying the MIMD win.

:func:`compile_tconv_program` performs the paper's static translation of a
2-D transposed-conv layer: output rows grouped by zero-pattern (y-phase,
"output row reorganization"), filter taps regrouped per phase ("filter row
reorganization"), column access as strided generator sweeps over only the
consequential taps (fine-grain zero skipping).  Executing the compiled
program reproduces the dense transposed conv in float64 — the end-to-end
ISA-level validation — and yields cycle/utilization statistics (Fig. 11).

A numpy-only copy of ``repro.core.uop``: the port imports nothing of the
JAX package, and the parity tests hold the two machines' outputs and
statistics equal bit for bit.  ``chip_smoke.py``'s ``paper`` phase holds
the machine's output against the port's ``ganax_conv`` CUDA kernel on
the card.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np

from repro_torch.core.scheduler import PhaseSchedule

__all__ = [
    "StridedIndexGenerator",
    "Uop",
    "UopKind",
    "PEProgram",
    "GanaxMachine",
    "compile_tconv_program",
    "run_tconv_on_machine",
]


class StridedIndexGenerator:
    """Fig. 7(b): five config registers + a modulo adder; one address/cycle.

    The generator sweeps ``Addr, Addr+Step, …`` modulo ``End``; each wrap
    decrements ``Repeat``; when ``Repeat`` hits zero the stop signal rises.
    ``Offset`` shifts the emitted range (so the same sweep can be replayed
    over different bases without reprogramming the sweep itself).
    """

    __slots__ = ("addr", "offset", "step", "end", "repeat", "_cur",
                 "running")

    REGS = ("addr", "offset", "step", "end", "repeat")

    def __init__(self) -> None:
        self.addr = 0
        self.offset = 0
        self.step = 0
        self.end = 1 << 30
        self.repeat = 1
        self._cur = 0
        self.running = False

    def configure(self, reg: str, value: int) -> None:  # access.cfg
        if reg not in self.REGS:
            raise ValueError(f"unknown config register {reg!r}")
        setattr(self, reg, int(value))

    def start(self) -> None:  # access.start
        self._cur = self.addr
        self.running = True

    def stop(self) -> None:  # access.stop
        self.running = False

    def emit(self) -> int:
        if not self.running:
            raise RuntimeError("index generator stopped (FIFO empty)")
        out = self.offset + self._cur
        nxt = self._cur + self.step
        if self.step >= 0 and nxt >= self.end:
            nxt -= self.end
            self.repeat -= 1
            if self.repeat <= 0:
                self.running = False
        elif self.step < 0 and nxt < 0:
            nxt += self.end
            self.repeat -= 1
            if self.repeat <= 0:
                self.running = False
        self._cur = nxt
        return out


class UopKind(enum.Enum):
    ACCESS_CFG = "access.cfg"      # %gen, %reg, imm  (per-PE imm table)
    ACCESS_START = "access.start"  # %gen
    MIMD_LD = "mimd.ld"            # load repeat register, imm per PE
    MAC = "mac"                    # repeat-register many MACs, no addresses
    NOP = "nop"


@dataclasses.dataclass(frozen=True)
class Uop:
    """One μop as issued to a PV.  ``imms`` carries the per-PE immediate
    (hardware: SIMD broadcast with per-lane operand from the access engine;
    configuration values differ per PE because each PE owns a different
    output row)."""
    kind: UopKind
    gen: int | None = None
    reg: str | None = None
    imms: tuple[int, ...] | None = None  # one immediate per PE (or None)


# Generator roles per PE
GEN_IN, GEN_W, GEN_OUT = 0, 1, 2


class _PE:
    __slots__ = ("gens", "repeat_reg", "busy_cycles", "macs")

    def __init__(self) -> None:
        self.gens = [StridedIndexGenerator() for _ in range(3)]
        self.repeat_reg = 0
        self.busy_cycles = 0
        self.macs = 0


@dataclasses.dataclass
class PEProgram:
    """A per-PV μop stream (all PEs in the PV execute it in SIMD)."""
    uops: list[Uop]


class GanaxMachine:
    """PV × PE array with decoupled access-execute PEs (Fig. 6/7)."""

    def __init__(self, n_pvs: int = 16, pes_per_pv: int = 16) -> None:
        self.n_pvs = n_pvs
        self.pes_per_pv = pes_per_pv
        self.pes = [[_PE() for _ in range(pes_per_pv)]
                    for _ in range(n_pvs)]
        self.mem: dict[str, np.ndarray] = {}

    def load_memory(self, name: str, arr: np.ndarray) -> None:
        self.mem[name] = np.array(arr, dtype=np.float64).ravel()

    def _exec(self, pv: int, uop: Uop) -> int:
        """Execute one μop across the PV; returns the PV's cycle cost."""
        cost = 0
        for pe_idx in range(self.pes_per_pv):
            pe = self.pes[pv][pe_idx]
            imm = uop.imms[pe_idx] if uop.imms is not None else None
            k = uop.kind
            if k == UopKind.NOP:
                c = 0
            elif k == UopKind.ACCESS_CFG:
                if imm is not None:
                    pe.gens[uop.gen].configure(uop.reg, imm)
                c = 1
            elif k == UopKind.ACCESS_START:
                if imm is None or imm:
                    pe.gens[uop.gen].start()
                c = 1
            elif k == UopKind.MIMD_LD:
                pe.repeat_reg = imm if imm is not None else 0
                c = 1
            elif k == UopKind.MAC:
                reps = pe.repeat_reg
                x, w, o = self.mem["input"], self.mem["weight"], \
                    self.mem["output"]
                for _ in range(reps):
                    ia = pe.gens[GEN_IN].emit()
                    wa = pe.gens[GEN_W].emit()
                    oa = pe.gens[GEN_OUT].emit()
                    o[oa] += x[ia] * w[wa]
                pe.busy_cycles += reps
                pe.macs += reps
                c = reps
            else:
                raise NotImplementedError(k)
            cost = max(cost, c)
        return cost

    def run(self, programs: list[PEProgram], mimd: bool = True) -> dict:
        """Execute one μop stream per PV.

        MIMD-SIMD mode: PVs run independently; time = max PV time.
        SIMD-lockstep mode (``mimd=False``): global stream steps advance in
        lockstep; every step costs the max across PVs (idle PVs wait) —
        the conventional-accelerator behavior the paper contrasts against.
        """
        assert len(programs) == self.n_pvs
        pv_times = [0] * self.n_pvs
        if mimd:
            for pv, prog in enumerate(programs):
                for uop in prog.uops:
                    pv_times[pv] += self._exec(pv, uop)
            cycles = max(pv_times)
        else:
            n_steps = max(len(p.uops) for p in programs)
            cycles = 0
            for i in range(n_steps):
                step_cost = 0
                for pv, prog in enumerate(programs):
                    if i < len(prog.uops):
                        step_cost = max(step_cost,
                                        self._exec(pv, prog.uops[i]))
                cycles += step_cost
            pv_times = [cycles] * self.n_pvs
        busy = sum(pe.busy_cycles for row in self.pes for pe in row)
        total_slots = cycles * self.n_pvs * self.pes_per_pv
        return {
            "cycles": cycles,
            "pv_cycles": pv_times,
            "busy_pe_cycles": busy,
            "utilization": busy / total_slots if total_slots else 0.0,
            "macs": sum(pe.macs for row in self.pes for pe in row),
        }


# ---------------------------------------------------------------------------
# Static translation of a 2-D transposed conv (the paper's compiler).
# ---------------------------------------------------------------------------

def compile_tconv_program(sched: PhaseSchedule, n_pvs: int, pes_per_pv: int,
                          wq_pad: int, wp: int
                          ) -> tuple[list[PEProgram], list]:
    """Compile the layer into one μop stream per PV.

    Output rows are reorganized phase-major (rows with identical zero
    patterns adjacent — Fig. 5a, longest microprogram first) and dealt to
    PE slots in contiguous runs, so a PV serves rows of a single y-phase
    whenever possible (the compulsory adjacency that reclaims filter-row
    reuse across neighboring PEs).  Each PE owns a run of reorganized
    output rows; its program is one ``(cfg×…, start×3, mimd.ld, mac)``
    block per consequential ``(row, ky, x-phase, kx)`` tap triple — program
    length therefore varies with the y-phase mix (MIMD across PVs).

    ``wq_pad``: row pitch of the reorganized output buffer;
    ``wp``: row pitch of the (padded) input buffer.
    Returns (programs, reorg_rows).
    """
    if sched.n_dims != 2:
        raise ValueError("ISA-level model is 2-D")
    y_dims, x_dims = sched.dims
    (py_lo, _), (px_lo, _) = sched.uniform_padding()

    # Reorganized row order: phase groups, longest microprogram first.
    reorg_rows: list[tuple[int, int]] = []
    for pd in sorted(y_dims, key=lambda p: p.n_taps, reverse=True):
        reorg_rows.extend((pd.phase, q) for q in range(pd.out_size))

    n_slots = n_pvs * pes_per_pv
    # Contiguous dealing: slot k owns rows [k*per, ...) — keeps a PV within
    # one phase group when possible.
    per = -(-len(reorg_rows) // n_slots)
    slot_rows: list[list[int]] = [
        list(range(k * per, min((k + 1) * per, len(reorg_rows))))
        for k in range(n_slots)]

    # Column phase layout inside a reorganized output row: x-phases stored
    # contiguously (phase-major), widths xd.out_size, in phase order.
    x_base = {}
    acc = 0
    for xd in x_dims:
        x_base[xd.phase] = acc
        acc += xd.out_size

    programs: list[PEProgram] = []
    for pv in range(n_pvs):
        progs_per_pe = []
        for pe_idx in range(pes_per_pv):
            slot = pv * pes_per_pv + pe_idx
            blocks = []
            for r in slot_rows[slot]:
                blocks.extend(_row_blocks(r, reorg_rows[r], sched, x_dims,
                                          y_dims, x_base, wq_pad, wp,
                                          px_lo, py_lo))
            progs_per_pe.append(blocks)
        n_blocks = max(len(b) for b in progs_per_pe)
        uops: list[Uop] = []
        for bi in range(n_blocks):
            blocks = [b[bi] if bi < len(b) else None for b in progs_per_pe]
            uops.extend(_emit_block(blocks))
        programs.append(PEProgram(uops))
    return programs, reorg_rows


def _row_blocks(r, yq, sched, x_dims, y_dims, x_base, wq_pad, wp,
                px_lo, py_lo):
    """MAC blocks for reorganized output row ``r``."""
    y_phase, qy = yq
    ypd = y_dims[y_phase]
    blocks = []
    for ty, ky in enumerate(ypd.taps):
        in_row = qy + ypd.offset - ty + py_lo
        for xd in x_dims:
            for tx, kx in enumerate(xd.taps):
                blocks.append(dict(
                    in_start=in_row * wp + (xd.offset - tx + px_lo),
                    w_addr=ky * sched.kernel[1] + kx,
                    out_start=r * wq_pad + x_base[xd.phase],
                    n=xd.out_size,
                    in_step=1, out_step=1,
                ))
    return blocks


def _emit_block(blocks) -> list[Uop]:
    """Emit the μop sequence for one MAC block across a PV's PEs.

    Per the paper, execute μops are address-free; the access μops configure
    the three generators, then ``mimd.ld`` sets the repeat register and a
    single ``mac`` μop streams the whole sweep.
    """
    def imm(key, default=0):
        return tuple(b[key] if b is not None else default for b in blocks)

    active = tuple(1 if b is not None else 0 for b in blocks)
    n = imm("n", 0)
    uops = [
        Uop(UopKind.ACCESS_CFG, gen=GEN_IN, reg="addr", imms=imm("in_start")),
        Uop(UopKind.ACCESS_CFG, gen=GEN_IN, reg="step", imms=imm("in_step", 1)),
        Uop(UopKind.ACCESS_CFG, gen=GEN_IN, reg="end",
            imms=tuple(1 << 30 for _ in blocks)),
        Uop(UopKind.ACCESS_CFG, gen=GEN_IN, reg="repeat",
            imms=tuple(1 for _ in blocks)),
        Uop(UopKind.ACCESS_CFG, gen=GEN_W, reg="addr", imms=imm("w_addr")),
        Uop(UopKind.ACCESS_CFG, gen=GEN_W, reg="step",
            imms=tuple(0 for _ in blocks)),
        Uop(UopKind.ACCESS_CFG, gen=GEN_OUT, reg="addr", imms=imm("out_start")),
        Uop(UopKind.ACCESS_CFG, gen=GEN_OUT, reg="step", imms=imm("out_step", 1)),
        Uop(UopKind.ACCESS_CFG, gen=GEN_OUT, reg="end",
            imms=tuple(1 << 30 for _ in blocks)),
        Uop(UopKind.ACCESS_START, gen=GEN_IN, imms=active),
        Uop(UopKind.ACCESS_START, gen=GEN_W, imms=active),
        Uop(UopKind.ACCESS_START, gen=GEN_OUT, imms=active),
        Uop(UopKind.MIMD_LD, imms=n),
        Uop(UopKind.MAC),
    ]
    return uops


def run_tconv_on_machine(x: np.ndarray, w: np.ndarray,
                         sched: PhaseSchedule,
                         n_pvs: int = 4, pes_per_pv: int = 4,
                         mimd: bool = True
                         ) -> tuple[np.ndarray, dict]:
    """Execute a single-channel 2-D tconv end-to-end through the ISA model.

    Every arithmetic contribution flows through the strided index
    generators and address-free ``mac`` μops; the result is then
    de-reorganized (inverse of the output-row/column reorganization) and
    compared against the dense reference by the tests.
    """
    y_dims, x_dims = sched.dims
    (py_lo, py_hi), (px_lo, px_hi) = sched.uniform_padding()
    xp = np.pad(np.asarray(x, np.float64), ((py_lo, py_hi),
                                            (px_lo, px_hi)))
    Hp, Wp = xp.shape
    wq_pad = sum(xd.out_size for xd in x_dims)

    machine = GanaxMachine(n_pvs, pes_per_pv)
    machine.load_memory("input", xp)
    machine.load_memory("weight", np.asarray(w, np.float64))

    programs, reorg_rows = compile_tconv_program(
        sched, n_pvs, pes_per_pv, wq_pad, Wp)

    # Reorganized output buffer: one row of width wq_pad per reorg row.
    machine.load_memory("output", np.zeros((len(reorg_rows), wq_pad)))
    stats_acc = machine.run(programs, mimd=mimd)
    stats_acc["utilization_mac_only"] = (
        stats_acc["macs"] / (max(stats_acc["pv_cycles"]) * n_pvs *
                             pes_per_pv)
        if stats_acc["pv_cycles"] else 0.0)
    out_buf = machine.mem["output"].reshape(len(reorg_rows), wq_pad)

    # De-reorganize: reorg row (y_phase, qy) and column block (x_phase, qx)
    # map to output (qy*s_y + y_phase, qx*s_x + x_phase).
    H_out, W_out = sched.out_sizes
    out = np.zeros((H_out, W_out), np.float64)
    x_base = {}
    acc = 0
    for xd in x_dims:
        x_base[xd.phase] = acc
        acc += xd.out_size
    for r, (y_phase, qy) in enumerate(reorg_rows):
        oy = qy * sched.strides[0] + y_phase
        for xd in x_dims:
            qs = np.arange(xd.out_size)
            out[oy, qs * sched.strides[1] + xd.phase] = \
                out_buf[r, x_base[xd.phase]: x_base[xd.phase] + xd.out_size]
    return out, stats_acc
