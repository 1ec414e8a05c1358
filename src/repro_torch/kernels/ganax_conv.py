"""The unified GANAX conv/tconv kernels (MIMD over phases, SIMD inside one).

The port of ``repro.kernels.ganax_conv``, which holds a planar and a
volumetric kernel; so does this module.  :func:`ganax_conv_cuda` and
:func:`ganax_conv3d_cuda` launch the hand-written CUDA C++ kernels of
``csrc/ganax_conv.cu`` and ``csrc/ganax_conv3d.cu`` (the ports of
``ganax_conv_kernel`` / ``ganax_conv_pallas`` and ``ganax_conv3d_kernel``
/ ``ganax_conv3d_pallas``); :func:`ganax_conv_plain` and
:func:`ganax_conv3d_plain` compute the same functions in plain PyTorch,
on any device.

Layout contract (prepared by ``ops.py`` from the schedule), with
``S`` the spatial dims ``(Hp, Wp)`` or ``(Dp, Hp, Wp)`` and ``Q`` the
phase grid ``(Qy, Qx)`` or ``(Qz, Qy, Qx)``:

  x_pad   (B, *S, Cin)         input, uniformly padded for every phase
  w_taps  (P, T, Cin, Cout)    per-phase gathered taps, zero-padded to T
  tables  TapTables            per phase: tap count, and per tap the
                               input offset along each spatial dim
                               (≥ 0, into x_pad)
  bias    (Cout,)              optional fused-epilogue bias (f32)
  out     (B, P, *Q, Cout)     phase-major output planes

Phase ``p``'s output ``q`` is
``act(bias + Σ_{t < n_taps[p]} x_pad[b, d + q·s, :] @ w_taps[p, t])``
with ``d`` its tap's offsets and ``s`` the output strides, per spatial
dim.  A phase with no taps still writes ``act(bias)``.  f32 storage and
f32 accumulation.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from repro_torch.device import require_ieee_f32

__all__ = ["TapTables", "apply_epilogue_to_acc", "ganax_conv_plain",
           "ganax_conv_cuda", "ganax_conv3d_plain", "ganax_conv3d_cuda",
           "ACTIVATION_CODES"]

# The kernels' activation argument (see ganax_conv.cu).
ACTIVATION_CODES = {"none": 0, "relu": 1, "leaky_relu": 2, "tanh": 3}

_INT32_MAX = 2 ** 31 - 1


@dataclasses.dataclass(frozen=True, eq=False)
class TapTables:
    """The per-phase tap tables of one layer geometry, on one device.

    ``n_taps`` (P,), ``tap_dy`` / ``tap_dx`` (P, T) and, for a 3-D
    geometry, ``tap_dz`` (P, T) are int32 tensors the kernel reads
    (``tap_dz`` is ``None`` for 2-D); ``taps`` holds the same offsets on
    the host (``taps[p]`` lists phase ``p``'s ``(dy, dx)`` or
    ``(dz, dy, dx)`` tuples), so neither the plain version nor the
    wrapper's bounds checks read the device."""

    n_taps: torch.Tensor
    tap_dy: torch.Tensor
    tap_dx: torch.Tensor
    taps: tuple[tuple[tuple[int, ...], ...], ...]
    tap_dz: torch.Tensor | None = None

    @classmethod
    def from_numpy(cls, n_taps: np.ndarray, tap_dy: np.ndarray,
                   tap_dx: np.ndarray, device: torch.device,
                   tap_dz: np.ndarray | None = None) -> "TapTables":
        n_taps = np.asarray(n_taps, np.int32)
        offsets = [np.asarray(a, np.int32)
                   for a in ((tap_dy, tap_dx) if tap_dz is None
                             else (tap_dz, tap_dy, tap_dx))]
        p, t = offsets[0].shape
        if n_taps.shape != (p,) or any(a.shape != (p, t) for a in offsets):
            raise ValueError(f"tap tables disagree: n_taps "
                             f"{n_taps.shape}, offsets "
                             f"{[a.shape for a in offsets]}")
        if n_taps.min(initial=0) < 0 or n_taps.max(initial=0) > t:
            raise ValueError(f"n_taps must lie in [0, {t}], got {n_taps}")
        taps = tuple(tuple(tuple(int(a[i, j]) for a in offsets)
                           for j in range(int(n_taps[i])))
                     for i in range(p))
        if any(d < 0 for ph in taps for tap in ph for d in tap):
            raise ValueError("tap offsets must be >= 0 (into x_pad)")

        def dev(a):
            return torch.tensor(a, dtype=torch.int32, device=device)

        *dz, dy, dx = (dev(a) for a in offsets)
        return cls(dev(n_taps), dy, dx, taps, dz[0] if dz else None)

    @property
    def rank(self) -> int:
        """Spatial dims the tables address: 2 or 3."""
        return 2 if self.tap_dz is None else 3

    @property
    def offsets(self) -> tuple[torch.Tensor, ...]:
        """The device offset tables in the kernel's argument order."""
        if self.tap_dz is None:
            return self.tap_dy, self.tap_dx
        return self.tap_dz, self.tap_dy, self.tap_dx

    @property
    def n_phases(self) -> int:
        return len(self.taps)

    @property
    def t_max(self) -> int:
        return int(self.tap_dy.shape[1])


def apply_epilogue_to_acc(acc: torch.Tensor, bias: torch.Tensor | None,
                          activation: str, leaky_slope: float
                          ) -> torch.Tensor:
    """The fused epilogue on the f32 accumulator: optional (Cout,) bias
    broadcast over the rows, then the activation."""
    if bias is not None:
        acc = acc + bias
    if activation == "relu":
        acc = torch.relu(acc)
    elif activation == "leaky_relu":
        acc = torch.where(acc > 0, acc, leaky_slope * acc)
    elif activation == "tanh":
        acc = torch.tanh(acc)
    return acc


def _check(x_pad, w_taps, tables: TapTables, out_strides, q_sizes, bias,
           activation) -> None:
    """Validate one call against the layout contract, at the rank of
    ``q_sizes``."""
    nd = len(q_sizes)
    if x_pad.dtype != torch.float32 or w_taps.dtype != torch.float32:
        raise TypeError(f"ganax_conv takes float32 x_pad and w_taps, got "
                        f"{x_pad.dtype} and {w_taps.dtype}")
    if x_pad.ndim != nd + 2 or w_taps.ndim != 4:
        raise ValueError(f"x_pad must be (B, {nd} spatial dims, Cin) and "
                         f"w_taps (P, T, Cin, Cout), got "
                         f"{tuple(x_pad.shape)} and {tuple(w_taps.shape)}")
    if tables.rank != nd:
        raise ValueError(f"{tables.rank}-D tap tables for a {nd}-D call")
    b, *spatial, cin = x_pad.shape
    p, t, cin_w, cout = w_taps.shape
    if cin_w != cin:
        raise ValueError(f"w_taps Cin {cin_w} != x_pad Cin {cin}")
    if (p, t) != (tables.n_phases, tables.t_max):
        raise ValueError(f"w_taps has (P, T)=({p}, {t}) but the tap "
                         f"tables ({tables.n_phases}, {tables.t_max})")
    if min(b, *spatial, cin, p, cout, *q_sizes) <= 0:
        raise ValueError("ganax_conv needs non-empty operands")
    strides = tuple(int(s) for s in out_strides)
    if len(strides) != nd or min(strides) <= 0:
        raise ValueError(f"out_strides must be {nd} positive ints, got "
                         f"{out_strides}")
    for ph in tables.taps:
        for tap in ph:
            if any(d + (q - 1) * s >= n for d, q, s, n
                   in zip(tap, q_sizes, strides, spatial)):
                raise ValueError(
                    f"tap {tap} reads past x_pad {tuple(spatial)} for a "
                    f"{tuple(q_sizes)} phase plane at strides {strides}")
    if activation not in ACTIVATION_CODES:
        raise ValueError(f"unknown activation {activation!r}")
    if bias is not None and (tuple(bias.shape) != (cout,)
                             or bias.dtype != torch.float32):
        raise ValueError(f"bias must be a float32 ({cout},) vector, got "
                         f"{bias.dtype} {tuple(bias.shape)}")


def _plain(x_pad, w_taps, tables, out_strides, q_sizes, bias, activation,
           leaky_slope) -> torch.Tensor:
    _check(x_pad, w_taps, tables, out_strides, q_sizes, bias, activation)
    require_ieee_f32(x_pad)
    b, cin = x_pad.shape[0], x_pad.shape[-1]
    p, _, _, cout = w_taps.shape
    out = x_pad.new_empty((b, p, *q_sizes, cout))
    for ph, taps in enumerate(tables.taps):
        acc = x_pad.new_zeros((b * int(np.prod(q_sizes)), cout))
        for t, tap in enumerate(taps):
            window = tuple(slice(d, d + (q - 1) * s + 1, s) for d, q, s
                           in zip(tap, q_sizes, out_strides))
            xt = x_pad[(slice(None),) + window]
            acc += xt.reshape(-1, cin) @ w_taps[ph, t]
        out[:, ph] = apply_epilogue_to_acc(
            acc, bias, activation, leaky_slope).reshape(b, *q_sizes, cout)
    return out


def ganax_conv_plain(x_pad: torch.Tensor, w_taps: torch.Tensor,
                     tables: TapTables, out_strides: tuple[int, int],
                     qy: int, qx: int, bias: torch.Tensor | None = None,
                     activation: str = "none", leaky_slope: float = 0.2
                     ) -> torch.Tensor:
    """The planar kernel's function in plain PyTorch: per phase, a loop
    over its taps of f32 matmuls into an accumulator, then the epilogue.
    Runs on any device (TF32 off on the card)."""
    return _plain(x_pad, w_taps, tables, out_strides, (qy, qx), bias,
                  activation, leaky_slope)


def ganax_conv3d_plain(x_pad: torch.Tensor, w_taps: torch.Tensor,
                       tables: TapTables, out_strides: tuple[int, int, int],
                       qz: int, qy: int, qx: int,
                       bias: torch.Tensor | None = None,
                       activation: str = "none", leaky_slope: float = 0.2
                       ) -> torch.Tensor:
    """The volumetric kernel's function in plain PyTorch: per phase, f32
    matmuls on the strided 3-D windows of its taps, then the epilogue.
    Runs on any device (TF32 off on the card)."""
    return _plain(x_pad, w_taps, tables, out_strides, (qz, qy, qx), bias,
                  activation, leaky_slope)


@functools.cache
def _library(name: str, nd: int):
    from repro_torch.kernels.build import load
    fn = getattr(load(name), f"{name}_f32")
    # x, w, n_taps, one offset table per dim, bias, out; then B, the
    # spatial dims, Cin, P, T, Cout, the phase grid, the strides, act
    fn.argtypes = [ctypes.c_void_p] * (nd + 5) + [ctypes.c_int] * (
        3 * nd + 6) + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _cuda(wrapper, x_pad, w_taps, tables, out_strides, q_sizes, bias,
          activation, leaky_slope) -> torch.Tensor:
    """Check, allocate and launch one call of the kernel of ``wrapper``
    (``<name>_cuda`` launches ``csrc/<name>.cu``); count it there."""
    name = wrapper.__name__
    _check(x_pad, w_taps, tables, out_strides, q_sizes, bias, activation)
    dev = x_pad.device
    operands = [x_pad, w_taps, tables.n_taps, *tables.offsets]
    if bias is not None:
        operands.append(bias)
    for a in operands:
        if a.device != dev or not a.is_cuda:
            raise ValueError(f"{name} takes tensors on one CUDA device, "
                             f"got {a.device} beside {dev}")
        if not a.is_contiguous():
            raise ValueError(f"{name} takes contiguous tensors")
    b, *spatial, cin = x_pad.shape
    p, t, _, cout = w_taps.shape
    out = torch.empty((b, p, *q_sizes, cout), dtype=torch.float32,
                      device=dev)
    if max(x_pad.numel(), w_taps.numel(), out.numel()) > _INT32_MAX:
        raise ValueError(f"{name} indexes with 32-bit offsets; split the "
                         f"batch")
    fn = _library(name.removesuffix("_cuda"), len(q_sizes))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(x_pad.data_ptr(), w_taps.data_ptr(),
                 tables.n_taps.data_ptr(),
                 *(o.data_ptr() for o in tables.offsets),
                 bias.data_ptr() if bias is not None else None,
                 out.data_ptr(), b, *spatial, cin, p, t, cout, *q_sizes,
                 *(int(s) for s in out_strides), ACTIVATION_CODES[activation],
                 float(leaky_slope), stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error "
                           f"{err}")
    wrapper.launches += 1
    return out


def ganax_conv_cuda(x_pad: torch.Tensor, w_taps: torch.Tensor,
                    tables: TapTables, out_strides: tuple[int, int],
                    qy: int, qx: int, bias: torch.Tensor | None = None,
                    activation: str = "none", leaky_slope: float = 0.2
                    ) -> torch.Tensor:
    """Launch the planar CUDA kernel on the current stream (no
    synchronise).

    Takes contiguous float32 CUDA tensors on one device and raises on
    anything else; the output is allocated here.  Each launch adds one
    to ``ganax_conv_cuda.launches``."""
    return _cuda(ganax_conv_cuda, x_pad, w_taps, tables, out_strides,
                 (qy, qx), bias, activation, leaky_slope)


def ganax_conv3d_cuda(x_pad: torch.Tensor, w_taps: torch.Tensor,
                      tables: TapTables, out_strides: tuple[int, int, int],
                      qz: int, qy: int, qx: int,
                      bias: torch.Tensor | None = None,
                      activation: str = "none", leaky_slope: float = 0.2
                      ) -> torch.Tensor:
    """Launch the volumetric CUDA kernel on the current stream (no
    synchronise).  Takes what :func:`ganax_conv_cuda` takes, with a depth
    axis; each launch adds one to ``ganax_conv3d_cuda.launches``."""
    return _cuda(ganax_conv3d_cuda, x_pad, w_taps, tables, out_strides,
                 (qz, qy, qx), bias, activation, leaky_slope)


ganax_conv_cuda.launches = 0
ganax_conv3d_cuda.launches = 0
