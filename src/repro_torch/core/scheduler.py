"""Static GANAX schedule generation (the paper's "μop compilation" stage).

A numpy-only copy of ``repro.core.scheduler``: the port imports nothing
of the JAX package, and the parity tests hold the two copies equal.

The paper statically translates each (transposed-)convolution layer into a
set of microprograms: output rows are grouped by their zero-pattern
("output row reorganization", Fig. 5a), filter rows are regrouped to match
("filter row reorganization", Fig. 5b), and the resulting per-group programs
are preloaded into the global/local μop buffers.

In tensor terms this is exactly the *polyphase decomposition* of the
transposed convolution.  For a stride-``s`` transposed conv with kernel size
``K`` and padding ``p`` (PyTorch/``lax.conv_transpose`` semantics), output
position ``o`` receives contributions only from kernel taps

    k ≡ (o + p) (mod s),

so output positions fall into ``s`` *phases* ``φ = o mod s`` per spatial
dimension, and each phase is a **dense** correlation between the
(un-expanded!) input and a strided sub-sampling of the kernel taps.  The
number of taps varies per phase — the paper's "variable number of operations
per convolution window" — which is what forces MIMD-SIMD execution.

This module computes, ahead of time and with pure Python/numpy (it runs at
trace time; nothing here is traced):

* per-phase tap lists, tap counts, input offsets, paddings and
  phase-plane output sizes (`PhaseDim`, `PhaseSchedule`);
* flattened, padded tap tables the CUDA kernel reads per phase (the
  "local μop buffer" contents);
* MAC statistics used by the analytical model (consequential vs. total).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

__all__ = [
    "PhaseDim",
    "PhaseSchedule",
    "make_schedule",
    "transposed_conv_output_size",
]


def transposed_conv_output_size(in_size: int, kernel: int, stride: int,
                                padding: int, output_padding: int = 0) -> int:
    """Output size of a transposed convolution (PyTorch semantics)."""
    return stride * (in_size - 1) + kernel - 2 * padding + output_padding


@dataclasses.dataclass(frozen=True)
class PhaseDim:
    """Per-dimension data for one output phase ``φ`` (``o ≡ φ mod s``).

    Attributes:
      phase: the phase index ``φ`` in ``[0, stride)``.
      taps: original kernel tap indices contributing to this phase,
        ascending (``k = c, c+s, c+2s, ...``).
      n_taps: ``len(taps)`` — the per-phase "microprogram length".
      offset: ``m(φ) = (φ + p - c(φ)) // s``; contribution ``t`` (indexing
        ``taps``) reads input position ``q + offset - t`` for phase-plane
        output position ``q``.
      out_size: size of this phase's output plane
        (``ceil((out_size_total - φ)/s)``).
      pad_lo / pad_hi: zero padding of the *input* so that the dense
        sub-correlation stays in bounds: position ``q`` reads padded input
        ``[q, q + n_taps)`` when correlating with the reversed tap order.
    """

    phase: int
    taps: tuple[int, ...]
    n_taps: int
    offset: int
    out_size: int
    pad_lo: int
    pad_hi: int


@dataclasses.dataclass(frozen=True)
class PhaseSchedule:
    """Complete static schedule for an N-D transposed convolution.

    ``dims[d][φ]`` is the `PhaseDim` for spatial dim ``d`` phase ``φ``.
    ``phase_order`` lists multi-dim phases longest-microprogram-first (the
    equal-work MIMD scheduling heuristic: long programs issue first so the
    pipeline tail is short).
    """

    in_sizes: tuple[int, ...]
    kernel: tuple[int, ...]
    strides: tuple[int, ...]
    paddings: tuple[int, ...]
    out_sizes: tuple[int, ...]
    dims: tuple[tuple[PhaseDim, ...], ...]

    # -- derived -----------------------------------------------------------
    @property
    def n_dims(self) -> int:
        return len(self.in_sizes)

    @property
    def n_phases(self) -> int:
        return int(np.prod([len(d) for d in self.dims]))

    def phase_tuple(self, flat: int) -> tuple[int, ...]:
        """Unflatten a phase id (row-major over dims)."""
        out = []
        for dim in reversed(self.dims):
            out.append(flat % len(dim))
            flat //= len(dim)
        return tuple(reversed(out))

    def phase_dims(self, flat: int) -> tuple[PhaseDim, ...]:
        return tuple(self.dims[d][φ]
                     for d, φ in enumerate(self.phase_tuple(flat)))

    @property
    def phase_order(self) -> tuple[int, ...]:
        """Phases ordered longest-first by total tap count."""
        def work(i: int) -> int:
            return int(np.prod([pd.n_taps for pd in self.phase_dims(i)]))
        return tuple(sorted(range(self.n_phases), key=work, reverse=True))

    @property
    def max_taps(self) -> tuple[int, ...]:
        return tuple(max(pd.n_taps for pd in dim) for dim in self.dims)

    @property
    def phase_out_sizes(self) -> tuple[tuple[int, ...], ...]:
        return tuple(tuple(pd.out_size for pd in self.phase_dims(i))
                     for i in range(self.n_phases))

    # -- MAC statistics (paper Fig. 1) --------------------------------------
    def consequential_macs(self, cin: int, cout: int, batch: int = 1) -> int:
        """MACs actually contributing to the output (non-zero operands)."""
        total = 0
        for i in range(self.n_phases):
            pds = self.phase_dims(i)
            pix = int(np.prod([pd.out_size for pd in pds]))
            taps = int(np.prod([pd.n_taps for pd in pds]))
            total += pix * taps
        return total * cin * cout * batch

    def zero_inserted_macs(self, cin: int, cout: int, batch: int = 1) -> int:
        """MACs a conventional conv dataflow performs on the zero-inserted
        input (the EYERISS-style baseline cost)."""
        pix = int(np.prod(self.out_sizes))
        taps = int(np.prod(self.kernel))
        return pix * taps * cin * cout * batch

    def inconsequential_fraction(self) -> float:
        """Fraction of baseline MACs that are wasted on inserted zeros
        (paper Fig. 1)."""
        c = self.consequential_macs(1, 1)
        z = self.zero_inserted_macs(1, 1)
        return 1.0 - c / z if z else 0.0

    # -- kernel tap tables ("local μop buffer" contents) ---------------------
    def tap_tables(self) -> dict[str, np.ndarray]:
        """Flattened per-phase tables, padded to the max tap count.

        Returns int32 arrays (first axis = flat phase id, in ``phase_order``
        so the kernel grid walks longest-first):
          n_taps:      (P,)            total taps (product over dims)
          tap_dx:      (P, T_max, D)   input offset per tap per dim
                        (pre-composed with per-phase padding so offsets are
                        always >= 0 into the padded input)
          tap_k:       (P, T_max, D)   original kernel tap index per dim
          out_base:    (P, D)          first output coordinate (== phase φ)
          out_size:    (P, D)          phase-plane output sizes
          pad_lo:      (P, D)          input left-padding per dim
        """
        D = self.n_dims
        order = self.phase_order
        P = self.n_phases
        t_max = int(np.prod(self.max_taps))
        n_taps = np.zeros((P,), np.int32)
        tap_dx = np.zeros((P, t_max, D), np.int32)
        tap_k = np.zeros((P, t_max, D), np.int32)
        out_base = np.zeros((P, D), np.int32)
        out_size = np.zeros((P, D), np.int32)
        pad_lo = np.zeros((P, D), np.int32)
        # Uniform padding across phases (max over phases per dim) so a single
        # padded input works for every phase:
        upad_lo = [max(pd.pad_lo for pd in dim) for dim in self.dims]
        for row, flat in enumerate(order):
            pds = self.phase_dims(flat)
            per_dim_taps = []
            for d, pd in enumerate(pds):
                # tap t reads padded_input[q + upad_lo + offset - t]
                # → store dx(t) = upad_lo[d] + pd.offset - t  (>= 0 by
                #   construction of pad_lo).
                taps_d = [(upad_lo[d] + pd.offset - t, pd.taps[t])
                          for t in range(pd.n_taps)]
                per_dim_taps.append(taps_d)
                out_base[row, d] = pd.phase
                out_size[row, d] = pd.out_size
                pad_lo[row, d] = upad_lo[d]
            # Cartesian product of per-dim taps, row-major.
            combos = [[]]
            for taps_d in per_dim_taps:
                combos = [c + [t] for c in combos for t in taps_d]
            n_taps[row] = len(combos)
            for ti, combo in enumerate(combos):
                for d, (dx, k) in enumerate(combo):
                    tap_dx[row, ti, d] = dx
                    tap_k[row, ti, d] = k
        return dict(n_taps=n_taps, tap_dx=tap_dx, tap_k=tap_k,
                    out_base=out_base, out_size=out_size, pad_lo=pad_lo)

    def uniform_padding(self) -> tuple[tuple[int, int], ...]:
        """(lo, hi) input padding per dim covering every phase's needs."""
        return tuple(
            (max(pd.pad_lo for pd in dim), max(pd.pad_hi for pd in dim))
            for dim in self.dims)


def _phase_dim(in_size: int, kernel: int, stride: int, padding: int,
               phase: int, out_size_total: int) -> PhaseDim:
    c = (phase + padding) % stride
    taps = tuple(range(c, kernel, stride))
    n = len(taps)
    offset = (phase + padding - c) // stride
    out_size = max(0, -(-(out_size_total - phase) // stride))
    # position q reads input[q + offset - t], t in [0, n)
    pad_lo = max(0, (n - 1) - offset)
    pad_hi = max(0, (out_size - 1 + offset) - (in_size - 1))
    return PhaseDim(phase=phase, taps=taps, n_taps=n, offset=offset,
                    out_size=out_size, pad_lo=pad_lo, pad_hi=pad_hi)


def make_schedule(in_sizes: Sequence[int], kernel: Sequence[int],
                  strides: Sequence[int], paddings: Sequence[int],
                  output_paddings: Sequence[int] | None = None
                  ) -> PhaseSchedule:
    """Build the static GANAX schedule for an N-D transposed convolution.

    A stride-1 schedule degenerates to a single phase == plain convolution
    (the paper's "SIMD mode"); stride > 1 produces the multi-phase
    "MIMD-SIMD mode".
    """
    in_sizes = tuple(int(x) for x in in_sizes)
    kernel = tuple(int(x) for x in kernel)
    strides = tuple(int(x) for x in strides)
    paddings = tuple(int(x) for x in paddings)
    if output_paddings is None:
        output_paddings = (0,) * len(in_sizes)
    output_paddings = tuple(int(x) for x in output_paddings)
    if not (len(in_sizes) == len(kernel) == len(strides) == len(paddings)
            == len(output_paddings)):
        raise ValueError("dimension mismatch between schedule arguments")
    for k, s, p in zip(kernel, strides, paddings):
        if s < 1 or k < 1 or p < 0:
            raise ValueError(f"invalid tconv geometry k={k} s={s} p={p}")
        if p >= k:
            raise ValueError(f"padding {p} >= kernel {k} unsupported")
    out_sizes = tuple(
        max(0, transposed_conv_output_size(i, k, s, p, op))
        for i, k, s, p, op in zip(in_sizes, kernel, strides, paddings,
                                  output_paddings))
    dims = []
    for d in range(len(in_sizes)):
        dims.append(tuple(
            _phase_dim(in_sizes[d], kernel[d], strides[d], paddings[d],
                       φ, out_sizes[d])
            for φ in range(strides[d])))
    return PhaseSchedule(in_sizes=in_sizes, kernel=kernel, strides=strides,
                         paddings=paddings, out_sizes=out_sizes,
                         dims=tuple(dims))
