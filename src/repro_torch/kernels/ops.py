"""One (transposed) convolution through the unified GANAX kernel.

The kernel backend of ``core.dataflow`` (the port of
``repro.kernels.ops``), for 2-D and 3-D layers: pad the input once for
every phase, gather each phase's weight taps, launch the kernel of the
input's rank, then crop the phase planes and interleave them into the
image or volume.  The kernel is :func:`ganax_conv_cuda` (2-D) or
:func:`ganax_conv3d_cuda` (3-D) for a CUDA tensor, and its plain version
(:func:`ganax_conv_plain` / :func:`ganax_conv3d_plain`) for a CPU
tensor; ``plain=True`` (the ``"ganax-plain"`` oracle, pinned by name
only) runs the plain version on any device.  x and w share one storage
dtype (float32, bfloat16 or float16): the taps are gathered in it, the
bias goes in as f32, and the output comes out in x's dtype.

The tap tables and gather indices of a layer geometry are built once
per device and cached, as ``compile_uops`` caches the schedule; only
the weight gather depends on the values.  These ops record no
gradient and raise when one is asked for: the gradient comes from
``core.dataflow.tconv`` / ``conv``, whose ``torch.autograd.Function``
calls them with grad mode off, forward and backward.

``kernel_supported(nd)`` keeps the reference's name for the ranks the
kernels take.  The reference's ``default_blocks`` / ``resolve_blocks``
choose Pallas tile shapes and have no counterpart here: the CUDA
kernels' tiles are a route's (``kernels.ganax_conv.kernel_route``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Sequence

import torch
import torch.nn.functional as F

from repro_torch.core.dataflow import (Epilogue, _f_pad,
                                       canonical_epilogue,
                                       compile_conv_uops, compile_uops,
                                       require_kernel_rank)
from repro_torch.core.dataflow import \
    pallas_kernel_supported as kernel_supported
from repro_torch.core.tconv import interleave_phases
from repro_torch.kernels.ganax_conv import (STORAGE_SUFFIX, KernelRoute,
                                            TapTables, check_route,
                                            ganax_conv3d_cuda,
                                            ganax_conv3d_plain,
                                            ganax_conv_cuda, ganax_conv_plain)

__all__ = ["ganax_conv_transpose", "ganax_conv", "kernel_operands",
           "kernel_supported"]


@dataclasses.dataclass(frozen=True, eq=False)
class _Prep:
    """The value-independent prep of one geometry on one device."""

    tables: TapTables
    pad: tuple[int, ...]            # F.pad argument for (N, *S, C)
    q_sizes: tuple[int, ...]
    k_idx: torch.Tensor | None      # (P*T,) gather index (tconv only)
    valid: torch.Tensor | None      # (P, T, 1, 1) tap mask (tconv only)


@functools.lru_cache(maxsize=512)
def _tconv_prep(in_spatial, kernel, strides, paddings, device) -> _Prep:
    u = compile_uops(in_spatial, kernel, strides, paddings)
    p, t = u.k_idx.shape
    return _Prep(
        tables=TapTables.from_numpy(u.n_taps, u.tap_dy, u.tap_dx, device,
                                    tap_dz=u.tap_dz),
        pad=_f_pad(u.pad), q_sizes=u.q_sizes,
        k_idx=torch.tensor(u.k_idx.reshape(-1), dtype=torch.long,
                           device=device),
        valid=torch.tensor(u.valid, device=device).reshape(p, t, 1, 1))


@functools.lru_cache(maxsize=512)
def _conv_prep(in_spatial, kernel, strides, paddings, device) -> _Prep:
    u = compile_conv_uops(in_spatial, kernel, strides, paddings)
    return _Prep(
        tables=TapTables.from_numpy(u.n_taps, u.tap_dy, u.tap_dx, device,
                                    tap_dz=u.tap_dz),
        pad=_f_pad(u.pad), q_sizes=u.out_sizes, k_idx=None, valid=None)


def _check_inputs(x: torch.Tensor, w: torch.Tensor, route: str) -> None:
    require_kernel_rank(x.ndim - 2, f"the ganax {route} input")
    if w.ndim != x.ndim:
        raise ValueError(f"x {tuple(x.shape)} and w {tuple(w.shape)} "
                         f"differ in rank")
    if x.dtype not in STORAGE_SUFFIX or w.dtype != x.dtype:
        raise TypeError(
            f"ganax {route} takes x and w of one storage dtype (float32, "
            f"bfloat16 or float16), got {x.dtype} and {w.dtype}")
    if x.device != w.device:
        raise ValueError(f"x on {x.device} but w on {w.device}")
    if x.shape[-1] != w.shape[-2]:
        raise ValueError(f"x has {x.shape[-1]} channels but w takes "
                         f"{w.shape[-2]}")
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        raise NotImplementedError(
            f"ganax {route} records no gradient when called directly; "
            f"differentiate through repro_torch.core.dataflow.tconv/conv "
            f"(its autograd Function), or run it under torch.no_grad()")


def kernel_operands(x: torch.Tensor, w: torch.Tensor,
                    strides: Sequence[int], paddings: Sequence[int], *,
                    transposed: bool) -> dict:
    """The kernel's operands for one (transposed) conv: the padded input
    ``x_pad``, the gathered weight taps ``w_taps``, the tap ``tables``,
    ``out_strides`` and the phase-grid extents (``qy``/``qx``, or
    ``qz``/``qy``/``qx`` for a 3-D input) — keyword arguments of the
    kernel of the input's rank and of its plain version, in x's storage
    dtype."""
    _check_inputs(x, w, "tconv" if transposed else "conv")
    nd = x.ndim - 2
    geometry = (tuple(x.shape[1:1 + nd]), tuple(w.shape[:nd]),
                tuple(strides), tuple(paddings), x.device)
    cin, cout = w.shape[-2:]
    if transposed:
        prep = _tconv_prep(*geometry)
        p, t = prep.valid.shape[:2]
        w_taps = w.reshape(-1, cin, cout).index_select(0, prep.k_idx)
        w_taps = torch.where(prep.valid, w_taps.reshape(p, t, cin, cout),
                             0.0)
        out_strides = (1,) * nd
    else:
        prep = _conv_prep(*geometry)
        w_taps = w.reshape(1, -1, cin, cout).contiguous()
        out_strides = tuple(strides)
    return dict(x_pad=F.pad(x, prep.pad).contiguous(), w_taps=w_taps,
                tables=prep.tables, out_strides=out_strides,
                **dict(zip(("qz", "qy", "qx")[-nd:], prep.q_sizes)))


# (CUDA kernel, plain version) of each spatial rank
_KERNELS = {2: (ganax_conv_cuda, ganax_conv_plain),
            3: (ganax_conv3d_cuda, ganax_conv3d_plain)}


def launch_kernel(operands: dict, epilogue, bias, plain: bool,
                  route: KernelRoute | None) -> torch.Tensor:
    """One call of the kernel of the operands' rank (its plain version
    where ``plain`` or on the CPU) on :func:`kernel_operands`' output,
    with the epilogue fused; (B, P, *Q, Cout) before the interleave."""
    ep = canonical_epilogue(epilogue, bias,
                            int(operands["w_taps"].shape[-1]))
    if bias is not None:
        bias = bias.to(torch.float32).contiguous()
    x_pad = operands["x_pad"]
    cuda_kernel, plain_kernel = _KERNELS[x_pad.ndim - 2]
    args = dict(operands, bias=bias, activation=ep.activation,
                leaky_slope=ep.leaky_slope)
    if not plain and x_pad.is_cuda:
        return cuda_kernel(**args, route=route)
    if route is not None:
        # the plain version's sums are every route's function; the
        # choice is held to the kernels' routes all the same
        _, t, cin, cout = operands["w_taps"].shape
        check_route(route, cin, cout, t * cin, x_pad.element_size())
    return plain_kernel(**args)


def ganax_conv_transpose(x: torch.Tensor, w: torch.Tensor,
                         strides: Sequence[int], paddings: Sequence[int],
                         *, epilogue: Epilogue | None = None,
                         bias: torch.Tensor | None = None,
                         plain: bool = False,
                         route: KernelRoute | None = None) -> torch.Tensor:
    """Transposed convolution through the unified GANAX kernel.

    x: (N, *spatial, Cin) channels-last with 2 or 3 spatial dims;
    w: (K..., Cin, Cout).
    ``epilogue``/``bias`` fuse a bias add and activation into the
    kernel's flush; phases with no taps (kernel < stride) still get it,
    their outputs are ``act(0 + b)``.  The epilogue is elementwise, so it
    commutes with the phase interleave that follows.  ``route`` names
    the CUDA kernel's route (a tuned one; default ``kernel_route``'s):
    ``ValueError`` unless the kernels take it for this geometry, on any
    device."""
    out_pm = launch_kernel(kernel_operands(x, w, strides, paddings,
                                           transposed=True),
                           epilogue, bias, plain, route)
    # out_pm: (B, P, *Q, Cout) in schedule.phase_order; interleave
    nd = x.ndim - 2
    sched = compile_uops(tuple(x.shape[1:1 + nd]), tuple(w.shape[:nd]),
                         tuple(strides), tuple(paddings)).schedule
    phase_planes = {}
    for row, flat in enumerate(sched.phase_order):
        crop = tuple(slice(0, pd.out_size) for pd in sched.phase_dims(flat))
        phase_planes[sched.phase_tuple(flat)] = \
            out_pm[(slice(None), row) + crop]
    if sched.n_phases == 1:
        return phase_planes[(0,) * nd]
    return interleave_phases(phase_planes, sched)


def ganax_conv(x: torch.Tensor, w: torch.Tensor, strides: Sequence[int],
               paddings: Sequence[int], *,
               epilogue: Epilogue | None = None,
               bias: torch.Tensor | None = None,
               plain: bool = False,
               route: KernelRoute | None = None) -> torch.Tensor:
    """Plain (strided) convolution through the same kernel — the paper's
    SIMD mode: one phase whose taps are the full kernel.  Arguments as
    in :func:`ganax_conv_transpose`."""
    return launch_kernel(kernel_operands(x, w, strides, paddings,
                                         transposed=False),
                         epilogue, bias, plain, route)[:, 0]
