"""GANAX transposed convolution: the plain reference dataflows in PyTorch.

The port of ``repro.core.tconv`` (channels-last layout, PyTorch
``ConvTranspose`` geometry, f32 accumulation):

* :func:`tconv_zero_insert` — the conventional-accelerator baseline:
  materialize the zero-inserted input and run a dense correlation over
  it, so every inserted zero costs a MAC.
* :func:`tconv_ganax` — the paper's dataflow: one dense correlation per
  output phase (the polyphase decomposition of ``core/scheduler.py``),
  then a zero-arithmetic interleave.

Both are oracles for the kernel path; they run only when pinned by name
(``core.dataflow``).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.scheduler import PhaseSchedule, make_schedule
from repro_torch.device import require_ieee_f32

__all__ = [
    "correlate",
    "zero_insert",
    "tconv_zero_insert",
    "tconv_ganax",
    "interleave_phases",
    "tconv_output_shape",
]

_CONVS = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


def correlate(x: torch.Tensor, w: torch.Tensor, strides: Sequence[int],
              pads: Sequence[tuple[int, int]]) -> torch.Tensor:
    """Channels-last correlation ``y[q] = Σ_t w[t]·x[s·q + t - lo]``.

    x: (N, *spatial, Cin); w: (*K, Cin, Cout); ``pads`` is one (lo, hi)
    pair per spatial dim — negative values crop, as in
    ``lax.conv_general_dilated``.  Accumulates in f32 at least: bf16 and
    f16 operands are widened to f32 (where their products are exact),
    contracted, and the result cast back to x's dtype, as the
    reference's ``preferred_element_type=float32`` does."""
    nd = x.ndim - 2
    require_ieee_f32(x, conv=True)
    acc = torch.promote_types(x.dtype, torch.float32)
    xn = x.movedim(-1, 1).to(acc)
    flat = []
    for lo, hi in reversed(tuple(pads)):
        flat += [int(lo), int(hi)]
    xn = F.pad(xn, flat)
    wn = w.permute(nd + 1, nd, *range(nd)).to(acc)   # (Cout, Cin, *K)
    return _CONVS[nd](xn, wn, stride=tuple(strides)).movedim(1, -1) \
        .to(x.dtype)


def zero_insert(x: torch.Tensor, strides: Sequence[int]) -> torch.Tensor:
    """Materialize the zero-expanded input (size ``s*(n-1)+1`` per dim)."""
    nd = x.ndim - 2
    strides = tuple(strides)
    out_sp = tuple(s * (n - 1) + 1
                   for n, s in zip(x.shape[1:1 + nd], strides))
    out = x.new_zeros((x.shape[0], *out_sp, x.shape[-1]))
    idx = (slice(None),) + tuple(slice(None, None, s) for s in strides) + (
        slice(None),)
    out[idx] = x
    return out


def tconv_zero_insert(x: torch.Tensor, w: torch.Tensor,
                      strides: Sequence[int], paddings: Sequence[int]
                      ) -> torch.Tensor:
    """Transposed conv via the conventional dataflow (baseline).

    x: (N, *spatial, C_in); w: (*kernel, C_in, C_out); strides/paddings
    per spatial dim, PyTorch ``ConvTranspose`` semantics."""
    nd = x.ndim - 2
    kernel = w.shape[:nd]
    expanded = zero_insert(x, strides)
    # correlate with the flipped kernel, padded by (k - 1 - p) per side
    w_flipped = torch.flip(w, dims=tuple(range(nd)))
    pads = tuple((k - 1 - p, k - 1 - p) for k, p in zip(kernel, paddings))
    return correlate(expanded, w_flipped, (1,) * nd, pads)


def tconv_output_shape(x_shape: Sequence[int], w_shape: Sequence[int],
                       strides: Sequence[int], paddings: Sequence[int]
                       ) -> tuple[int, ...]:
    """(N, *spatial_out, C_out) for channels-last x and (K..., C_in, C_out) w."""
    nd = len(x_shape) - 2
    sched = make_schedule(x_shape[1:1 + nd], w_shape[:nd], strides, paddings)
    return (x_shape[0], *sched.out_sizes, w_shape[-1])


def _phase_conv(x: torch.Tensor, w: torch.Tensor, sched: PhaseSchedule,
                flat_phase: int) -> torch.Tensor:
    """Dense sub-correlation for one phase (one GANAX microprogram)."""
    pds = sched.phase_dims(flat_phase)
    # taps reversed so the correlation realizes
    # out[q] = Σ_t w[tap_t]·x[q + offset - t]
    w_sub = w
    for d, pd in enumerate(pds):
        taps = torch.as_tensor(pd.taps[::-1], dtype=torch.long,
                               device=w.device)
        w_sub = w_sub.index_select(d, taps)
    pads = [(pd.n_taps - 1 - pd.offset,
             pd.out_size - sched.in_sizes[d] + pd.offset)
            for d, pd in enumerate(pds)]
    return correlate(x, w_sub, (1,) * sched.n_dims, pads)


def interleave_phases(phase_outs: dict[tuple[int, ...], torch.Tensor],
                      sched: PhaseSchedule) -> torch.Tensor:
    """Scatter phase planes into the full output (the "row reorganization"
    permutation applied in reverse): pad each plane to the common
    ``ceil(out/s)`` grid, stack, and interleave with a reshape — a pure
    layout op, no arithmetic."""
    nd = sched.n_dims
    strides = sched.strides
    q_sizes = tuple(-(-o // s) for o, s in zip(sched.out_sizes, strides))
    first = next(iter(phase_outs.values()))
    n, c = first.shape[0], first.shape[-1]
    planes = []
    for idx in np.ndindex(*strides):
        out = phase_outs[tuple(int(i) for i in idx)]
        flat = [0, 0]
        for d in reversed(range(nd)):
            flat += [0, q_sizes[d] - out.shape[1 + d]]
        planes.append(F.pad(out, flat))
    stacked = torch.stack(planes).reshape(tuple(strides) + (n, *q_sizes, c))
    # target order: (N, q_0, phase_0, q_1, phase_1, ..., C)
    perm = [nd]
    for d in range(nd):
        perm.extend([nd + 1 + d, d])
    perm.append(2 * nd + 1)
    full = stacked.permute(perm).reshape(
        (n,) + tuple(q * s for q, s in zip(q_sizes, strides)) + (c,))
    slc = (slice(None),) + tuple(slice(0, o) for o in sched.out_sizes) + (
        slice(None),)
    return full[slc]


def tconv_ganax(x: torch.Tensor, w: torch.Tensor, strides: Sequence[int],
                paddings: Sequence[int],
                schedule: PhaseSchedule | None = None) -> torch.Tensor:
    """Transposed conv via the GANAX dataflow (plain PyTorch reference).

    Executes only consequential MACs: one dense sub-correlation per
    output phase, then a zero-arithmetic interleave.  Stride 1
    degenerates to a single plain correlation (the SIMD mode)."""
    nd = x.ndim - 2
    sched = schedule or make_schedule(x.shape[1:1 + nd], w.shape[:nd],
                                      strides, paddings)
    outs = {}
    for flat in sched.phase_order:
        phases = sched.phase_tuple(flat)
        pds = sched.phase_dims(flat)
        if any(pd.n_taps == 0 for pd in pds):
            # no consequential taps (kernel < stride): all-zero phase
            outs[phases] = x.new_zeros(
                (x.shape[0],) + tuple(pd.out_size for pd in pds)
                + (w.shape[-1],))
            continue
        outs[phases] = _phase_conv(x, w, sched, flat)
    if sched.n_phases == 1:
        return outs[(0,) * nd]
    return interleave_phases(outs, sched)
