"""The unified GANAX conv/tconv kernel (MIMD over phases, SIMD inside one).

:func:`ganax_conv_cuda` launches the hand-written CUDA C++ kernel of
``csrc/ganax_conv.cu`` (the port of ``repro.kernels.ganax_conv``'s
``ganax_conv_kernel`` / ``ganax_conv_pallas``); :func:`ganax_conv_plain`
computes the same function in plain PyTorch, on any device.

Layout contract (prepared by ``ops.py`` from the schedule):

  x_pad   (B, Hp, Wp, Cin)     input, uniformly padded for every phase
  w_taps  (P, T, Cin, Cout)    per-phase gathered taps, zero-padded to T
  tables  TapTables            per phase: tap count, and per tap the
                               input row/col offset (≥ 0, into x_pad)
  bias    (Cout,)              optional fused-epilogue bias (f32)
  out     (B, P, Qy, Qx, Cout) phase-major output planes

Phase ``p``'s output ``(qy, qx)`` is
``act(bias + Σ_{t < n_taps[p]} x_pad[b, dy + qy·sy, dx + qx·sx, :] @
w_taps[p, t])`` with ``(dy, dx)`` its tap's offsets.  A phase with no
taps still writes ``act(bias)``.  f32 storage and f32 accumulation.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from repro_torch.device import require_ieee_f32

__all__ = ["TapTables", "apply_epilogue_to_acc", "ganax_conv_plain",
           "ganax_conv_cuda", "ACTIVATION_CODES"]

# The kernel's activation argument (see ganax_conv.cu).
ACTIVATION_CODES = {"none": 0, "relu": 1, "leaky_relu": 2, "tanh": 3}

_INT32_MAX = 2 ** 31 - 1


@dataclasses.dataclass(frozen=True, eq=False)
class TapTables:
    """The per-phase tap tables of one layer geometry, on one device.

    ``n_taps`` (P,), ``tap_dy`` / ``tap_dx`` (P, T) are int32 tensors the
    kernel reads; ``taps`` holds the same offsets on the host
    (``taps[p]`` lists phase ``p``'s ``(dy, dx)`` pairs), so neither the
    plain version nor the wrapper's bounds checks read the device."""

    n_taps: torch.Tensor
    tap_dy: torch.Tensor
    tap_dx: torch.Tensor
    taps: tuple[tuple[tuple[int, int], ...], ...]

    @classmethod
    def from_numpy(cls, n_taps: np.ndarray, tap_dy: np.ndarray,
                   tap_dx: np.ndarray, device: torch.device
                   ) -> "TapTables":
        n_taps = np.asarray(n_taps, np.int32)
        tap_dy = np.asarray(tap_dy, np.int32)
        tap_dx = np.asarray(tap_dx, np.int32)
        p, t = tap_dy.shape
        if n_taps.shape != (p,) or tap_dx.shape != (p, t):
            raise ValueError(f"tap tables disagree: n_taps "
                             f"{n_taps.shape}, tap_dy {tap_dy.shape}, "
                             f"tap_dx {tap_dx.shape}")
        if n_taps.min(initial=0) < 0 or n_taps.max(initial=0) > t:
            raise ValueError(f"n_taps must lie in [0, {t}], got {n_taps}")
        taps = tuple(tuple((int(tap_dy[i, j]), int(tap_dx[i, j]))
                           for j in range(int(n_taps[i])))
                     for i in range(p))
        if any(dy < 0 or dx < 0 for ph in taps for dy, dx in ph):
            raise ValueError("tap offsets must be >= 0 (into x_pad)")

        def dev(a):
            return torch.tensor(a, dtype=torch.int32, device=device)

        return cls(dev(n_taps), dev(tap_dy), dev(tap_dx), taps)

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


def _check(x_pad, w_taps, tables: TapTables, out_strides, qy, qx, bias,
           activation) -> None:
    """Validate one call against the layout contract."""
    if x_pad.dtype != torch.float32 or w_taps.dtype != torch.float32:
        raise TypeError(f"ganax_conv takes float32 x_pad and w_taps, got "
                        f"{x_pad.dtype} and {w_taps.dtype}")
    if x_pad.ndim != 4 or w_taps.ndim != 4:
        raise ValueError(f"x_pad must be (B, Hp, Wp, Cin) and w_taps "
                         f"(P, T, Cin, Cout), got {tuple(x_pad.shape)} "
                         f"and {tuple(w_taps.shape)}")
    b, hp, wp, cin = x_pad.shape
    p, t, cin_w, cout = w_taps.shape
    if cin_w != cin:
        raise ValueError(f"w_taps Cin {cin_w} != x_pad Cin {cin}")
    if (p, t) != (tables.n_phases, tables.t_max):
        raise ValueError(f"w_taps has (P, T)=({p}, {t}) but the tap "
                         f"tables ({tables.n_phases}, {tables.t_max})")
    if min(b, hp, wp, cin, p, cout, qy, qx) <= 0:
        raise ValueError("ganax_conv needs non-empty operands")
    sy, sx = (int(s) for s in out_strides)
    if sy <= 0 or sx <= 0:
        raise ValueError(f"out_strides must be positive, got {out_strides}")
    for ph in tables.taps:
        for dy, dx in ph:
            if dy + (qy - 1) * sy >= hp or dx + (qx - 1) * sx >= wp:
                raise ValueError(
                    f"tap ({dy}, {dx}) reads past x_pad "
                    f"({hp}, {wp}) for a ({qy}, {qx}) phase plane at "
                    f"strides ({sy}, {sx})")
    if activation not in ACTIVATION_CODES:
        raise ValueError(f"unknown activation {activation!r}")
    if bias is not None and (tuple(bias.shape) != (cout,)
                             or bias.dtype != torch.float32):
        raise ValueError(f"bias must be a float32 ({cout},) vector, got "
                         f"{bias.dtype} {tuple(bias.shape)}")


def ganax_conv_plain(x_pad: torch.Tensor, w_taps: torch.Tensor,
                     tables: TapTables, out_strides: tuple[int, int],
                     qy: int, qx: int, bias: torch.Tensor | None = None,
                     activation: str = "none", leaky_slope: float = 0.2
                     ) -> torch.Tensor:
    """The kernel's function in plain PyTorch: per phase, a loop over its
    taps of f32 matmuls into an accumulator, then the epilogue.  Runs on
    any device (TF32 off on the card)."""
    _check(x_pad, w_taps, tables, out_strides, qy, qx, bias, activation)
    require_ieee_f32(x_pad)
    b, _, _, cin = x_pad.shape
    p, _, _, cout = w_taps.shape
    sy, sx = out_strides
    out = x_pad.new_empty((b, p, qy, qx, cout))
    for ph, taps in enumerate(tables.taps):
        acc = x_pad.new_zeros((b * qy * qx, cout))
        for t, (dy, dx) in enumerate(taps):
            xt = x_pad[:, dy:dy + (qy - 1) * sy + 1:sy,
                       dx:dx + (qx - 1) * sx + 1:sx, :]
            acc += xt.reshape(-1, cin) @ w_taps[ph, t]
        out[:, ph] = apply_epilogue_to_acc(
            acc, bias, activation, leaky_slope).reshape(b, qy, qx, cout)
    return out


@functools.cache
def _library():
    from repro_torch.kernels.build import load
    lib = load("ganax_conv")
    fn = lib.ganax_conv_f32
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 12 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def ganax_conv_cuda(x_pad: torch.Tensor, w_taps: torch.Tensor,
                    tables: TapTables, out_strides: tuple[int, int],
                    qy: int, qx: int, bias: torch.Tensor | None = None,
                    activation: str = "none", leaky_slope: float = 0.2
                    ) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream (no synchronise).

    Takes contiguous float32 CUDA tensors on one device and raises on
    anything else; the output is allocated here.  Each launch adds one
    to ``ganax_conv_cuda.launches``."""
    _check(x_pad, w_taps, tables, out_strides, qy, qx, bias, activation)
    dev = x_pad.device
    operands = [x_pad, w_taps, tables.n_taps, tables.tap_dy, tables.tap_dx]
    if bias is not None:
        operands.append(bias)
    for a in operands:
        if a.device != dev or not a.is_cuda:
            raise ValueError(f"ganax_conv_cuda takes tensors on one CUDA "
                             f"device, got {a.device} beside {dev}")
        if not a.is_contiguous():
            raise ValueError("ganax_conv_cuda takes contiguous tensors")
    b, hp, wp, cin = x_pad.shape
    p, t, _, cout = w_taps.shape
    out = torch.empty((b, p, qy, qx, cout), dtype=torch.float32,
                      device=dev)
    if max(x_pad.numel(), w_taps.numel(), out.numel()) > _INT32_MAX:
        raise ValueError("ganax_conv_cuda indexes with 32-bit offsets; "
                         "split the batch")
    fn = _library()
    sy, sx = (int(s) for s in out_strides)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(x_pad.data_ptr(), w_taps.data_ptr(),
                 tables.n_taps.data_ptr(), tables.tap_dy.data_ptr(),
                 tables.tap_dx.data_ptr(),
                 bias.data_ptr() if bias is not None else None,
                 out.data_ptr(), b, hp, wp, cin, p, t, cout, qy, qx, sy,
                 sx, ACTIVATION_CODES[activation], float(leaky_slope),
                 stream)
    if err != 0:
        raise RuntimeError(f"ganax_conv kernel launch failed: CUDA error "
                           f"{err}")
    ganax_conv_cuda.launches += 1
    return out


ganax_conv_cuda.launches = 0
