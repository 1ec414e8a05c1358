"""The unified GANAX conv/tconv kernels (MIMD over phases, SIMD inside one).

The port of ``repro.kernels.ganax_conv``, which holds a planar and a
volumetric kernel; so does this module.  :func:`ganax_conv_cuda` and
:func:`ganax_conv3d_cuda` launch the hand-written CUDA C++ kernels of
``csrc/ganax_conv.cu`` and ``csrc/ganax_conv3d.cu`` (the ports of
``ganax_conv_kernel`` / ``ganax_conv_pallas`` and ``ganax_conv3d_kernel``
/ ``ganax_conv3d_pallas``); :func:`ganax_conv_plain` and
:func:`ganax_conv3d_plain` compute the same functions in plain PyTorch,
on any device.

Each kernel has an instance per storage dtype (float32, bfloat16,
float16: the C entry points ``<name>_f32``, ``_bf16``, ``_f16``), picked
by the operands' dtype.  Each CUDA call takes one of three routes, which
:func:`kernel_route` picks from the geometry and the dtype's size (or
the caller names, as the tuner does: :func:`route_options` lists the
routes a geometry takes, :func:`check_route` holds a choice to them):
``"tc"`` (Cout > 8: products on the tensor cores into f32 accumulators,
the weights in the (P, Cout, K) layout of :func:`tc_weights` — at f32
exact as 3xTF32, split by :func:`tf32_split`; at bf16/f16 one product
each, which is exact in f32), ``"narrow"`` (Cout <= 8: a row-dot FFMA
kernel in f32), either of them with split-K (K summed by ranges into an
f32 scratch, then reduced in a fixed order before the epilogue) when its
output tiles cannot fill the card.  :func:`tc_route_emulation` repeats
the tc route's order of sums in plain PyTorch.

Layout contract (prepared by ``ops.py`` from the schedule), with
``S`` the spatial dims ``(Hp, Wp)`` or ``(Dp, Hp, Wp)`` and ``Q`` the
phase grid ``(Qy, Qx)`` or ``(Qz, Qy, Qx)``:

  x_pad   (B, *S, Cin)         input, uniformly padded for every phase
  w_taps  (P, T, Cin, Cout)    per-phase gathered taps, zero-padded to T
  tables  TapTables            per phase: tap count, and per tap the
                               input offset along each spatial dim
                               (≥ 0, into x_pad)
  bias    (Cout,)              optional fused-epilogue bias (f32)
  out     (B, P, *Q, Cout)     phase-major output planes, x_pad's dtype

Phase ``p``'s output ``q`` is
``act(bias + Σ_{t < n_taps[p]} x_pad[b, d + q·s, :] @ w_taps[p, t])``
with ``d`` its tap's offsets and ``s`` the output strides, per spatial
dim.  A phase with no taps still writes ``act(bias)``.  ``x_pad`` and
``w_taps`` share one storage dtype (float32, bfloat16 or float16); the
products are summed in f32, the epilogue runs on the f32 sum, and the
output is cast to the storage dtype once, as the Pallas kernels' f32
VMEM scratch and single cast at the flush do.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import require_ieee_f32

__all__ = ["TapTables", "apply_epilogue_to_acc", "ganax_conv_plain",
           "ganax_conv_cuda", "ganax_conv3d_plain", "ganax_conv3d_cuda",
           "ACTIVATION_CODES", "KernelRoute", "kernel_route",
           "route_options", "check_route", "tf32_split",
           "tc_weights", "tc_route_emulation", "plain_sums",
           "check_tma_weights", "tc_block_k", "flat_k_needed",
           "STORAGE_SUFFIX"]

# The kernels' activation argument (see ganax_conv_sm90.cuh).
ACTIVATION_CODES = {"none": 0, "relu": 1, "leaky_relu": 2, "tanh": 3}
# The kernels' route argument: tc with (tap, Cin) stages, tc with the
# flattened (tap, c) index (Cin not a multiple of a 16-byte copy), narrow.
ROUTE_CODES = {("tc", False): 0, ("tc", True): 1, ("narrow", False): 2}
# The storage dtypes of x_pad, w_taps and the output, by the suffix of
# their kernel instance's C entry point (<name>_f32, _bf16, _f16).
STORAGE_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16",
                  torch.float16: "f16"}

_INT32_MAX = 2 ** 31 - 1
# what 16-byte copies and TMA need of an address
_ALIGN = 16
# the card's SMs (an H100 SXM), which split-K aims to fill
SMS = 132
# tc: rows a block (K a stage: tc_block_k); Cout above NARROW_MAX_COUT
TC_BLOCK_M = 128
# tc: the stages whose products share a fresh accumulator, by (tile
# width, itemsize) (TcTiles::kSlab): 32 or 64 K at f32, 64 at 2 bytes
TC_SLAB_STAGES = {(64, 4): 2, (128, 4): 1, (64, 2): 1, (128, 2): 1}
NARROW_MAX_COUT = 8
# narrow: rows a block at the least, a K range's weights and offset
# table in shared memory (48 KB: the weights held as f32 whatever the
# storage dtype, widened once as the block loads them), the least K a
# split takes
NARROW_BLOCK_ROWS = 32
NARROW_SMEM_FLOATS = 12288
NARROW_MIN_SPLIT_K = 512
# tc: the fewest stages a split takes; the longest flattened (tap, c)
# index (the kernel's offset table of kFlatMax entries)
TC_MIN_SPLIT_STAGES = 8
TC_FLAT_MAX_K = 2048


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def tc_block_k(itemsize: int = 4) -> int:
    """The tc route's K a stage for elements of ``itemsize`` bytes: one
    128-byte row, the TMA box and swizzle atom (32 f32, 64 bf16/f16)."""
    return 128 // itemsize


def flat_k_needed(cin: int, itemsize: int = 4) -> bool:
    """Whether the tc route stages the flattened (tap, c) index: where a
    row's Cin channels are not a whole number of 16-byte copies (Cin %
    4 != 0 at f32, Cin % 8 != 0 at bf16/f16)."""
    return cin % (16 // itemsize) != 0


@dataclasses.dataclass(frozen=True)
class KernelRoute:
    """The route of one call: ``kind`` ``"tc"`` or ``"narrow"``;
    ``splits`` K ranges summed by the reduce kernel (1: none);
    ``flat_k``: tc stages the flattened (tap, c) index
    (:func:`flat_k_needed`);
    ``block_n``: tc's tile width; ``k_split``: the K a narrow split
    takes.  ``kind``, ``splits`` and ``block_n`` choose the route, and
    only they compare and hash; ``flat_k`` and ``k_split`` follow from
    them and the geometry (:func:`check_route` fills them in)."""

    kind: str
    splits: int = 1
    flat_k: bool = dataclasses.field(default=False, compare=False)
    block_n: int = 0
    k_split: int = dataclasses.field(default=0, compare=False)

    @property
    def name(self) -> str:
        """The key of ``launches_by_route``: ``tc``, ``tc+split_k``,
        ``narrow`` or ``narrow+split_k``."""
        return self.kind + ("+split_k" if self.splits > 1 else "")

    def describe(self) -> str:
        """``tc/64/s2`` (kind, tile width, splits) or ``narrow/s4``."""
        width = f"/{self.block_n}" if self.kind == "tc" else ""
        return f"{self.kind}{width}/s{self.splits}"

    def to_json(self) -> dict:
        """The choice alone, as plan and program files store it."""
        return {"kind": self.kind, "splits": self.splits,
                "block_n": self.block_n}

    @classmethod
    def from_json(cls, d) -> "KernelRoute":
        if not isinstance(d, dict) or set(d) != {"kind", "splits",
                                                  "block_n"}:
            raise ValueError(f"bad kernel route {d!r}")
        return cls(str(d["kind"]), int(d["splits"]),
                   block_n=int(d["block_n"]))


def kernel_route(cin: int, cout: int, rows: int, k: int,
                 phases: int = 1, itemsize: int = 4) -> KernelRoute:
    """The route of a call with ``phases`` phases of ``rows`` output rows
    (B·∏Q) and at most ``k`` = T·Cin products a row, from the geometry
    and the storage dtype's ``itemsize`` alone.  Cout <= 8 is narrow,
    the rest tc; either splits K in powers of two while its blocks would
    not fill twice (narrow) or once (tc) the card's SMs and each split
    keeps enough K; a narrow split also keeps its weights and offsets
    within shared memory."""
    if cout <= NARROW_MAX_COUT:
        units = phases * _cdiv(rows, NARROW_BLOCK_ROWS)
        splits = 1
        while ((units * splits < 2 * SMS
                and k // (2 * splits) >= NARROW_MIN_SPLIT_K)
               or _narrow_k_split(k, splits) * (cout + 1)
               > NARROW_SMEM_FLOATS):
            splits *= 2
        return KernelRoute("narrow", splits,
                           k_split=_narrow_k_split(k, splits))
    flat = flat_k_needed(cin, itemsize)
    block_n = 64 if cout <= 64 else 128
    bk = tc_block_k(itemsize)
    stages = _cdiv(k, bk) if flat else (k // cin) * _cdiv(cin, bk)
    tiles = phases * _cdiv(rows, TC_BLOCK_M) * _cdiv(cout, block_n)
    splits = 1
    while tiles * splits < SMS and stages // (2 * splits) >= \
            TC_MIN_SPLIT_STAGES:
        splits *= 2
    return KernelRoute("tc", splits, flat, block_n)


def _narrow_k_split(k: int, splits: int) -> int:
    """The K a narrow split takes: a multiple of 4 (16-byte chunks)."""
    return _cdiv(_cdiv(k, splits), 4) * 4


def route_options(cin: int, cout: int, k: int, itemsize: int = 4
                  ) -> list[KernelRoute]:
    """Every route the kernels take for a call of ``k`` = T·Cin products
    a row at Cin ``cin``, Cout ``cout`` and the storage dtype's
    ``itemsize``, whatever its rows: the routes :func:`kernel_route`
    picks among, with ``flat_k`` and ``k_split`` filled in.  Cout <= 8
    is ``narrow``: splits in powers of two from the fewest whose K range
    fits shared memory, then while each split keeps
    ``NARROW_MIN_SPLIT_K``.  The rest is ``tc``: tile width 64, and 128
    where Cout > 64; splits in powers of two while each split keeps
    ``TC_MIN_SPLIT_STAGES`` stages; none where a flattened K exceeds
    ``TC_FLAT_MAX_K``.  The csrc ``run`` returns -2 for any other
    route."""
    if cout <= NARROW_MAX_COUT:
        s = 1
        while _narrow_k_split(k, s) * (cout + 1) > NARROW_SMEM_FLOATS:
            s *= 2
        out = [KernelRoute("narrow", s, k_split=_narrow_k_split(k, s))]
        s *= 2
        while k // s >= NARROW_MIN_SPLIT_K:
            out.append(KernelRoute("narrow", s,
                                   k_split=_narrow_k_split(k, s)))
            s *= 2
        return out
    flat = flat_k_needed(cin, itemsize)
    if flat and k > TC_FLAT_MAX_K:
        return []
    bk = tc_block_k(itemsize)
    stages = _cdiv(k, bk) if flat else (k // cin) * _cdiv(cin, bk)
    splits = [1]
    while stages // (2 * splits[-1]) >= TC_MIN_SPLIT_STAGES:
        splits.append(2 * splits[-1])
    widths = (64, 128) if cout > 64 else (64,)
    return [KernelRoute("tc", s, flat, n) for n in widths for s in splits]


def check_route(route: KernelRoute, cin: int, cout: int, k: int,
                itemsize: int = 4) -> KernelRoute:
    """``route`` (its ``kind``, ``splits`` and ``block_n``) completed for
    this geometry; raises ``ValueError`` unless it is one of
    :func:`route_options`, the routes the kernels take.  The one
    validator of a chosen route: the tuner's candidates, plan and
    program files, and the wrappers' ``route=`` all pass through it."""
    for r in route_options(cin, cout, k, itemsize):
        if r == route:
            return r
    raise ValueError(
        f"no GANAX kernel takes route {route.describe()} for Cin {cin}, "
        f"Cout {cout}, K {k} at {itemsize}-byte storage; the routes it "
        f"takes: {[r.describe() for r in route_options(cin, cout, k, itemsize)]}")


def _tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: round an f32 tensor to 10 mantissa bits,
    to nearest with ties away from zero, on the int32 view (half a tf32
    ulp added to the magnitude, then the 13 low bits cleared)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """f32 ``x`` as ``hi + lo``, two tf32 values (13 zero low bits):
    ``hi`` rounds ``x``, ``lo`` rounds ``x - hi`` (exact in f32), so
    ``|x - hi - lo| <= 2**-22 |x|``.  The tc route's split of both
    operands; the kernel splits A the same way, in shared memory."""
    hi = _tf32_round(x)
    return hi, _tf32_round(x - hi)


def tc_weights(w_taps: torch.Tensor, flat_k: bool
               ) -> tuple[torch.Tensor, torch.Tensor | None, int]:
    """The tc route's B operand from ``w_taps`` (P, T, Cin, Cout): the
    weights K-major as (P, Cout, K) in ``w_taps``' dtype, and K.  K is
    (tap, Cin) with Cin zero-padded to a multiple of the dtype's
    :func:`tc_block_k`, or (``flat_k``) the flattened (tap, c) index
    zero-padded to one (so a row is a multiple of 16 bytes, as TMA
    needs).  At f32 the weights come split by :func:`tf32_split` as
    ``(hi, lo, K)``; at bf16/f16 as ``(b, None, K)``, one operand."""
    p, t, cin, cout = w_taps.shape
    bk = tc_block_k(w_taps.element_size())
    # one copy into a contiguous layout, zeros in the pad
    if flat_k:
        k = _cdiv(t * cin, bk) * bk
        b = w_taps.new_zeros((p, cout, k))
        b[..., :t * cin] = w_taps.reshape(p, t * cin, cout).transpose(1, 2)
    else:
        cin_pad = _cdiv(cin, bk) * bk
        k = t * cin_pad
        b = w_taps.new_zeros((p, cout, t, cin_pad))
        b[..., :cin] = w_taps.permute(0, 3, 1, 2)
        b = b.reshape(p, cout, k)
    if w_taps.dtype != torch.float32:
        return b, None, k
    hi, lo = tf32_split(b)
    return hi, lo, k


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
    if x_pad.dtype not in STORAGE_SUFFIX or w_taps.dtype != x_pad.dtype:
        raise TypeError(f"ganax_conv takes x_pad and w_taps of one storage "
                        f"dtype (float32, bfloat16 or float16), got "
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


def plain_sums(x_pad, w_taps, tables: TapTables, out_strides, q_sizes,
               acc_dtype: torch.dtype | None = None) -> torch.Tensor:
    """The plain version's arithmetic, unchecked: per phase, a loop over
    its taps of matmuls into an accumulator of ``acc_dtype``, (B, P, *Q,
    Cout) before the epilogue.  By default the accumulator is f32 for
    the storage dtypes (the operands widened first: a bf16 or f16
    product is exact in f32) and the operands' own dtype for wider ones
    (float64, for exactness checks).  It does not refuse TF32, and
    ``acc_dtype`` may be a storage dtype (each tap's matmul and the sum
    rounded to it), so that the controls on the card can run it with
    TF32 on or storage-dtype sums; everything else calls the checked
    plain versions."""
    if acc_dtype is None:
        acc_dtype = torch.promote_types(x_pad.dtype, torch.float32)
    b, cin = x_pad.shape[0], x_pad.shape[-1]
    p, _, _, cout = w_taps.shape
    out = x_pad.new_empty((b, p, *q_sizes, cout), dtype=acc_dtype)
    for ph, taps in enumerate(tables.taps):
        acc = x_pad.new_zeros((b * int(np.prod(q_sizes)), cout),
                              dtype=acc_dtype)
        for t, tap in enumerate(taps):
            window = tuple(slice(d, d + (q - 1) * s + 1, s) for d, q, s
                           in zip(tap, q_sizes, out_strides))
            xt = x_pad[(slice(None),) + window]
            acc += xt.reshape(-1, cin).to(acc_dtype) @ \
                w_taps[ph, t].to(acc_dtype)
        out[:, ph] = acc.reshape(b, *q_sizes, cout)
    return out


def _plain(x_pad, w_taps, tables, out_strides, q_sizes, bias, activation,
           leaky_slope) -> torch.Tensor:
    _check(x_pad, w_taps, tables, out_strides, q_sizes, bias, activation)
    require_ieee_f32(x_pad)
    return apply_epilogue_to_acc(
        plain_sums(x_pad, w_taps, tables, out_strides, q_sizes), bias,
        activation, leaky_slope).to(x_pad.dtype)


def ganax_conv_plain(x_pad: torch.Tensor, w_taps: torch.Tensor,
                     tables: TapTables, out_strides: tuple[int, int],
                     qy: int, qx: int, bias: torch.Tensor | None = None,
                     activation: str = "none", leaky_slope: float = 0.2
                     ) -> torch.Tensor:
    """The planar kernel's function in plain PyTorch: per phase, a loop
    over its taps of f32 matmuls (on the storage-dtype operands widened
    to f32) into an f32 accumulator, then the epilogue and one cast to
    the storage dtype.  Runs on any device (TF32 off on the card)."""
    return _plain(x_pad, w_taps, tables, out_strides, (qy, qx), bias,
                  activation, leaky_slope)


def ganax_conv3d_plain(x_pad: torch.Tensor, w_taps: torch.Tensor,
                       tables: TapTables, out_strides: tuple[int, int, int],
                       qz: int, qy: int, qx: int,
                       bias: torch.Tensor | None = None,
                       activation: str = "none", leaky_slope: float = 0.2
                       ) -> torch.Tensor:
    """The volumetric kernel's function in plain PyTorch: per phase, f32
    matmuls on the strided 3-D windows of its taps, then the epilogue
    and one cast to the storage dtype.  Runs on any device (TF32 off on
    the card)."""
    return _plain(x_pad, w_taps, tables, out_strides, (qz, qy, qx), bias,
                  activation, leaky_slope)


def _route_of(x_pad, w_taps, q_sizes,
              route: KernelRoute | None = None) -> KernelRoute:
    """``kernel_route``'s pick for this call, or ``route`` checked and
    completed by :func:`check_route`."""
    p, t, cin, cout = w_taps.shape
    if route is not None:
        return check_route(route, cin, cout, t * cin, x_pad.element_size())
    return kernel_route(cin, cout, x_pad.shape[0] * math.prod(q_sizes),
                        t * cin, p, x_pad.element_size())


def tc_route_emulation(x_pad: torch.Tensor, w_taps: torch.Tensor,
                       tables: TapTables, out_strides, q_sizes,
                       bias: torch.Tensor | None = None,
                       activation: str = "none", leaky_slope: float = 0.2,
                       splits: int | None = None,
                       block_n: int | None = None) -> torch.Tensor:
    """The tc route's order of sums in plain PyTorch, 2-D or 3-D, at any
    storage dtype (the CPU's counterpart of the kernel, for the tests):
    per phase, the rows' gathered K (``tc_weights``' layout, zeros where
    the kernel zero-fills) in stages of the dtype's :func:`tc_block_k`;
    for each slab of a split (``TC_SLAB_STAGES`` of the tile width and
    itemsize; ``block_n``, or ``kernel_route``'s), into a fresh f32
    sum, added to the split's f32 sum: at
    f32 the products ``a_lo·b_hi + a_hi·b_lo`` stage by stage, then ``+
    a_hi·b_hi``; at bf16/f16 one product ``a·b`` a stage, the operands
    widened to f32 (where the product is exact).  The splits
    (``kernel_route``'s unless given) are summed in order, and only then
    come the epilogue and the one cast to the storage dtype.  The CPU
    adds each stage's products in f32, where the tensor cores drop low
    bits; the order is the kernel's."""
    _check(x_pad, w_taps, tables, out_strides, q_sizes, None, activation)
    route = _route_of(x_pad, w_taps, q_sizes)
    if route.kind != "tc":
        raise ValueError(f"Cout {w_taps.shape[-1]} takes the {route.kind} "
                         f"route, not tc")
    splits = route.splits if splits is None else splits
    itemsize = x_pad.element_size()
    bk = tc_block_k(itemsize)
    b_hi, b_lo, kb = tc_weights(w_taps, route.flat_k)
    b, cin = x_pad.shape[0], x_pad.shape[-1]
    p, t_max, _, cout = w_taps.shape
    cin_pad = kb // t_max if not route.flat_k else cin
    n_stages = kb // bk
    per = _cdiv(n_stages, splits)
    rows = b * math.prod(q_sizes)
    slab = TC_SLAB_STAGES[block_n or route.block_n, itemsize]
    out = x_pad.new_empty((b, p, *q_sizes, cout))
    for ph, taps in enumerate(tables.taps):
        # the phase's A operand, (rows, kb), as the producer gathers it
        cols = []
        for tap in taps:
            window = tuple(slice(d, d + (q - 1) * s + 1, s) for d, q, s
                           in zip(tap, q_sizes, out_strides))
            xt = x_pad[(slice(None),) + window].reshape(rows, cin)
            cols.append(xt if route.flat_k
                        else F.pad(xt, (0, cin_pad - cin)))
        a = torch.cat(cols, dim=1) if cols else x_pad.new_zeros((rows, 0))
        a = F.pad(a, (0, kb - a.shape[1])).float()
        if b_lo is None:
            terms = [(a, b_hi[ph].T.float())]          # (kb, Cout)
            last = []
        else:
            a_hi, a_lo = tf32_split(a)
            bh, bl = b_hi[ph].T, b_lo[ph].T
            terms = [(a_lo, bh), (a_hi, bl)]
            last = [(a_hi, bh)]
        acc = a.new_zeros((splits, rows, cout))
        for s in range(splits):
            stages = range(s * per, min((s + 1) * per, n_stages))
            for i in range(0, len(stages), slab):
                ks = [slice(st * bk, (st + 1) * bk)
                      for st in stages[i:i + slab]]
                fresh = a.new_zeros((rows, cout))
                for k in ks:
                    for u, v in terms:
                        fresh = fresh + u[:, k] @ v[k]
                for k in ks:
                    for u, v in last:
                        fresh = fresh + u[:, k] @ v[k]
                acc[s] += fresh
        total = acc[0]
        for s in range(1, splits):
            total = total + acc[s]
        out[:, ph] = apply_epilogue_to_acc(
            total, bias, activation, leaky_slope).reshape(
                b, *q_sizes, cout).to(x_pad.dtype)
    return out


@functools.cache
def _library(name: str, nd: int, suffix: str):
    from repro_torch.kernels.build import load
    fn = getattr(load(name), f"{name}_{suffix}")
    # x, w, b_hi, b_lo, n_taps, one offset table per dim, bias, out,
    # scratch; then B, the spatial dims, Cin, P, T, Cout, the phase
    # grid, the strides, route, block_n, splits, kb, act; slope; the
    # stream
    fn.argtypes = [ctypes.c_void_p] * (nd + 8) + [ctypes.c_int] * (
        3 * nd + 10) + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _ptr(a: torch.Tensor | None):
    return a.data_ptr() if a is not None else None


def _launch_error(err: int, name: str) -> RuntimeError:
    if err == -1:
        why = "the driver has no cuTensorMapEncodeTiled"
    elif err == -2:
        why = "no kernel takes this route, tile width and Cout"
    elif err < -1000:
        operand = ("b_hi", "b_lo")[-err // 1000 - 1]
        why = f"encoding the TMA map of {operand} failed: CUresult " \
              f"{-err % 1000}"
    else:
        why = f"CUDA error {err}"
    return RuntimeError(f"{name} kernel launch failed: {why}")


def _check_aligned(name: str, a: torch.Tensor, what: str) -> None:
    """The 16-byte alignment that ``what`` needs of ``a``'s address (its
    strides are contiguous multiples of 16 bytes where it is read so)."""
    if a.data_ptr() % _ALIGN:
        raise ValueError(f"{name} reads {what}, which needs a {_ALIGN}-byte "
                         f"aligned address: {a.data_ptr():#x}")


def check_tma_weights(b: torch.Tensor) -> None:
    """Raise unless TMA can read the tc route's (P, Cout, K) weights
    ``b`` (of a storage dtype) as the kernel's tensor map does:
    contiguous, the row stride (K values) and the address multiples of
    16 bytes."""
    if b.dtype not in STORAGE_SUFFIX or b.ndim != 3 or \
            not b.is_contiguous():
        raise ValueError(f"the tc route reads contiguous (P, Cout, K) "
                         f"weights of a storage dtype by TMA, got "
                         f"{b.dtype} {tuple(b.shape)} with strides "
                         f"{b.stride()}")
    row = b.shape[2] * b.element_size()
    if row % _ALIGN:
        raise ValueError(f"the tc route reads its weights by TMA, whose "
                         f"strides are multiples of {_ALIGN} bytes: a row "
                         f"of K = {b.shape[2]} {b.dtype} values is {row}")
    _check_aligned("the tc route", b, "its weights by TMA")


def _cuda(wrapper, x_pad, w_taps, tables, out_strides, q_sizes, bias,
          activation, leaky_slope, route) -> torch.Tensor:
    """Check, route, allocate and launch one call of the kernel of
    ``wrapper`` (``<name>_cuda`` launches ``csrc/<name>.cu``'s instance
    of x_pad's dtype) on ``route`` (None: ``kernel_route``'s); count it
    there, once, under its route and under its dtype."""
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
    route = _route_of(x_pad, w_taps, q_sizes, route)
    if cin % 4 == 0:
        # 16-byte copies (tc) or 16- or 8-byte loads (narrow) of each
        # row's channels
        _check_aligned(name, x_pad, "x_pad by 16-byte copies")
    b_hi = b_lo = scratch = None
    kb = route.k_split
    if route.flat_k and t * cin > TC_FLAT_MAX_K:
        raise ValueError(f"{name} flattens (tap, c) for Cin % 4 != 0 into "
                         f"at most {TC_FLAT_MAX_K} entries, got {t} taps x "
                         f"Cin {cin}")
    if route.kind == "tc":
        b_hi, b_lo, kb = tc_weights(w_taps, route.flat_k)
        for weights in (b_hi, b_lo):
            if weights is not None:
                check_tma_weights(weights)
    out = torch.empty((b, p, *q_sizes, cout), dtype=x_pad.dtype,
                      device=dev)
    if route.splits > 1:
        scratch = torch.empty((route.splits, *out.shape), dtype=torch.float32,
                              device=dev)
    if max(a.numel() for a in (x_pad, w_taps, out, b_hi, scratch)
           if a is not None) > _INT32_MAX:
        raise ValueError(f"{name} indexes with 32-bit offsets; split the "
                         f"batch")
    fn = _library(name.removesuffix("_cuda"), len(q_sizes),
                  STORAGE_SUFFIX[x_pad.dtype])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(x_pad.data_ptr(), w_taps.data_ptr(), _ptr(b_hi),
                 _ptr(b_lo), tables.n_taps.data_ptr(),
                 *(o.data_ptr() for o in tables.offsets), _ptr(bias),
                 out.data_ptr(), _ptr(scratch), b, *spatial, cin, p, t,
                 cout, *q_sizes, *(int(s) for s in out_strides),
                 ROUTE_CODES[route.kind, route.flat_k], route.block_n,
                 route.splits, kb,
                 ACTIVATION_CODES[activation], float(leaky_slope), stream)
    if err != 0:
        raise _launch_error(err, name)
    wrapper.launches += 1
    wrapper.launches_by_route[route.name] += 1
    wrapper.launches_by_dtype[str(x_pad.dtype).removeprefix("torch.")] += 1
    wrapper.launches_by_cout[cout] += 1
    return out


def ganax_conv_cuda(x_pad: torch.Tensor, w_taps: torch.Tensor,
                    tables: TapTables, out_strides: tuple[int, int],
                    qy: int, qx: int, bias: torch.Tensor | None = None,
                    activation: str = "none", leaky_slope: float = 0.2,
                    route: KernelRoute | None = None) -> torch.Tensor:
    """Launch the planar CUDA kernel's instance of ``x_pad``'s dtype on
    the current stream (no synchronise).

    Takes contiguous CUDA tensors on one device, ``x_pad`` and
    ``w_taps`` of one storage dtype (float32, bfloat16 or float16) and
    a float32 ``bias``, ``x_pad`` at a 16-byte aligned address where
    Cin % 4 = 0, and raises on anything else; the output (in the
    storage dtype), the tc route's weights and split-K's f32 scratch
    are allocated here.  The route is :func:`kernel_route`'s, or
    ``route`` (a tuned one: :func:`check_route` raises ``ValueError`` on
    a route the kernels do not take for this geometry).  Each call
    adds one to ``ganax_conv_cuda.launches`` (a split-K call runs two
    device kernels), to ``ganax_conv_cuda.launches_by_route[route.name]``,
    ``ganax_conv_cuda.launches_by_dtype[dtype name]`` and
    ``ganax_conv_cuda.launches_by_cout[Cout]`` (a Cout-sharded layer
    launches on its rank's slice)."""
    return _cuda(ganax_conv_cuda, x_pad, w_taps, tables, out_strides,
                 (qy, qx), bias, activation, leaky_slope, route)


def ganax_conv3d_cuda(x_pad: torch.Tensor, w_taps: torch.Tensor,
                      tables: TapTables, out_strides: tuple[int, int, int],
                      qz: int, qy: int, qx: int,
                      bias: torch.Tensor | None = None,
                      activation: str = "none", leaky_slope: float = 0.2,
                      route: KernelRoute | None = None) -> torch.Tensor:
    """Launch the volumetric CUDA kernel on the current stream (no
    synchronise).  Takes what :func:`ganax_conv_cuda` takes, with a depth
    axis; each call adds one to ``ganax_conv3d_cuda.launches``,
    ``ganax_conv3d_cuda.launches_by_route[route.name]``,
    ``ganax_conv3d_cuda.launches_by_dtype[dtype name]`` and
    ``ganax_conv3d_cuda.launches_by_cout[Cout]``."""
    return _cuda(ganax_conv3d_cuda, x_pad, w_taps, tables, out_strides,
                 (qz, qy, qx), bias, activation, leaky_slope, route)


ganax_conv_cuda.launches = 0
ganax_conv3d_cuda.launches = 0
# launches by KernelRoute.name, and by the storage dtype's name
# ("float32", "bfloat16", "float16": one kernel instance each)
ganax_conv_cuda.launches_by_route = collections.Counter()
ganax_conv3d_cuda.launches_by_route = collections.Counter()
ganax_conv_cuda.launches_by_dtype = collections.Counter()
ganax_conv3d_cuda.launches_by_dtype = collections.Counter()
# launches by the Cout of the call
ganax_conv_cuda.launches_by_cout = collections.Counter()
ganax_conv3d_cuda.launches_by_cout = collections.Counter()
