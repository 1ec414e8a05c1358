"""The Hopper GANAX kernels' routes and numerics, on the CPU.

* ``kernel_route`` sends every launch geometry of a full-width DCGAN and
  3D-GAN train step (``chip_smoke.train_cases``) to its route;
* ``tf32_split`` rounds as ``cvt.rna.tf32.f32`` does and leaves at most
  2^-21 |x| over, and its three-term product meets the card's 1e-4 gate
  against a float64 product where one TF32 product does not;
* ``tc_route_emulation``, the tc route's order of sums in plain PyTorch
  (slabs of 32 or 64 K into fresh sums, the flattened (tap, c) index for
  small Cin, split-K with the epilogue after the fixed-order reduce),
  against ``ganax_conv_plain`` / ``ganax_conv3d_plain`` and against
  ``ganax_conv_pallas`` / ``ganax_conv3d_pallas`` in interpret mode.

The CUDA kernels themselves run on the card (``test_torch_cuda.py``).
Tolerance: atol = rtol = 1e-5 against the plain and Pallas kernels (both
sum in f32 in another order; the split leaves <= 2^-21 of each product);
the float64 gate is the card's 1e-4 (``chip_smoke.ATOL``).
"""

import importlib.util
import math
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ganax_conv import ganax_conv3d_pallas, ganax_conv_pallas
from repro_torch.configs.gans import GAN_MODELS
from repro_torch.core import dataflow as tdf
from repro_torch.kernels import ops
from repro_torch.kernels.ganax_conv import (TapTables, ganax_conv3d_plain,
                                            ganax_conv_plain, kernel_route,
                                            tc_route_emulation, tc_weights,
                                            tf32_split)

TOL = dict(atol=1e-5, rtol=1e-5)
GATE = dict(atol=1e-4, rtol=1e-4)


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _train_launches():
    """(label, cin, cout, rows, k, phases) of each launch of both train
    steps, at chip_smoke's batch."""
    smoke = _chip_smoke()
    out = []
    for model in ("dcgan", "3dgan"):
        for (label, _, tr, xs, ws, s, p, *_rest) in smoke.train_cases(
                model, *GAN_MODELS[model]):
            with torch.no_grad():
                o = ops.kernel_operands(torch.zeros((1, *xs[1:])),
                                        torch.zeros(ws), s, p, transposed=tr)
            phases, taps, cin, cout = o["w_taps"].shape
            q = [o[k] for k in ("qz", "qy", "qx") if k in o]
            out.append((label, cin, cout, smoke.BATCH * math.prod(q),
                        taps * cin, phases))
    return out


TRAIN_LAUNCHES = _train_launches()


@pytest.mark.parametrize("label,cin,cout,rows,k,phases", TRAIN_LAUNCHES,
                         ids=[c[0].replace(" ", "-") for c in TRAIN_LAUNCHES])
def test_kernel_route_of_each_train_launch(label, cin, cout, rows, k,
                                           phases):
    route = kernel_route(cin, cout, rows, k, phases)
    layer = label.split(" ", 1)[1]
    if layer == "d5":
        assert (route.kind, route.name) == ("narrow", "narrow+split_k")
        assert route.k_split * route.splits >= k
    elif layer in ("g4", "d1 dx"):
        assert route.name == "narrow"
    elif layer in ("d1", "g4 dx"):
        assert route.kind == "tc" and route.flat_k
    else:
        assert route.kind == "tc" and route.flat_k == (cin % 4 != 0)
    if route.kind == "tc":
        assert route.block_n == (64 if cout <= 64 else 128)


def test_kernel_route_splits_only_what_cannot_fill_the_card():
    # DCGAN d4: 64 tiles of 128 x 128 over K = 8,192
    assert kernel_route(512, 1024, 1024, 16 * 512).splits == 4
    # 3D-GAN g3: 16,384 tiles, one K range
    assert kernel_route(128, 64, 262144, 8 * 128, 8).splits == 1
    # a narrow split keeps its weights and offsets in 48 KB
    r = kernel_route(1024, 8, 1 << 20, 16 * 1024)
    assert r.k_split * 9 <= 12288 and r.k_split % 4 == 0


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32)


def test_tf32_split_rounds_as_cvt_rna_and_leaves_2_to_minus_21():
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.normal(size=4096)
                     * 2.0 ** rng.integers(-40, 40, size=4096),
                     dtype=torch.float32)
    hi, lo = tf32_split(x)
    assert bool(((_bits(hi) & 0x1FFF) == 0).all())
    assert bool(((_bits(lo) & 0x1FFF) == 0).all())
    assert bool(((x - hi - lo).abs() <= 2.0 ** -21 * x.abs()).all())
    # ties go away from zero, as cvt.rna does: 1 + 2^-11 is half a tf32
    # ulp above 1
    tie = torch.tensor([1 + 2 ** -11, -(1 + 2 ** -11), 1 + 2 ** -12],
                       dtype=torch.float32)
    assert tf32_split(tie)[0].tolist() == [1 + 2 ** -10, -(1 + 2 ** -10),
                                           1.0]


def test_three_tf32_products_meet_the_gate_and_one_does_not():
    rng = np.random.default_rng(1)
    a = torch.tensor(rng.normal(size=(64, 1024)), dtype=torch.float32)
    b = torch.tensor(rng.normal(size=(1024, 64)), dtype=torch.float32)
    exact = a.double() @ b.double()
    (ah, al), (bh, bl) = tf32_split(a), tf32_split(b)
    # the tf32 pairs multiply exactly, as on the tensor cores; the sums
    # in float64 isolate the split's own error, and in f32 add the sums'
    three = ((al.double() @ bh.double() + ah.double() @ bl.double())
             + ah.double() @ bh.double())
    three_f32 = (al @ bh + ah @ bl) + ah @ bh
    one = ah.double() @ bh.double()
    assert torch.allclose(three, exact, **GATE)
    assert torch.allclose(three_f32.double(), exact, **GATE)
    assert not torch.allclose(one, exact, **GATE)


@pytest.mark.parametrize("flat", [False, True])
def test_tc_weights_layout(flat):
    rng = np.random.default_rng(2)
    p, t, cin, cout = 2, 3, 5 if flat else 36, 9
    w = torch.tensor(rng.normal(size=(p, t, cin, cout)), dtype=torch.float32)
    hi, lo, k = tc_weights(w, flat)
    assert hi.shape == lo.shape == (p, cout, k) and k % 32 == 0
    b = hi + lo
    if flat:
        torch.testing.assert_close(
            b[:, :, :t * cin],
            w.reshape(p, t * cin, cout).transpose(1, 2), atol=0,
            rtol=2 ** -21)
        assert bool((b[:, :, t * cin:] == 0).all())
    else:
        b = b.reshape(p, cout, t, 64)
        torch.testing.assert_close(b[..., :cin], w.permute(0, 3, 1, 2),
                                   atol=0, rtol=2 ** -21)
        assert bool((b[..., cin:] == 0).all())


# (x shape, w shape, strides, paddings, transposed, activation, bias):
# Cin 1, 3 (the flattened K) and 16; 2-D and 3-D; Cout > 8 (the tc
# route; 72 takes the 128-wide tile and its one-stage slabs, the rest the
# 64-wide one and two-stage slabs); tconv (phases of their own tap
# counts) and strided conv
EMULATION_CASES = [
    ((1, 4, 4, 8), (4, 4, 8, 72), (2, 2), (1, 1), False, "relu", True),
    ((2, 6, 6, 1), (4, 4, 1, 12), (2, 2), (1, 1), False, "leaky_relu",
     True),
    ((2, 4, 4, 3), (4, 4, 3, 16), (2, 2), (1, 1), True, "relu", True),
    ((1, 5, 5, 16), (3, 3, 16, 24), (2, 2), (1, 1), True, "tanh", False),
    ((2, 8, 8, 16), (4, 4, 16, 9), (2, 2), (1, 1), False, "none", True),
    ((1, 6, 6, 6, 1), (4, 4, 4, 1, 16), (2, 2, 2), (1, 1, 1), False,
     "leaky_relu", True),
    ((1, 3, 3, 3, 3), (4, 4, 4, 3, 12), (2, 2, 2), (1, 1, 1), True, "relu",
     True),
    ((1, 3, 2, 3, 16), (4, 3, 4, 16, 10), (2, 1, 2), (1, 1, 1), True,
     "tanh", False),
]


def _prepared(xs, ws, s, p, transposed, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=xs).astype(np.float32)
    w = (0.3 * rng.normal(size=ws)).astype(np.float32)
    nd = len(xs) - 2
    geo = (xs[1:1 + nd], ws[:nd], s, p)
    if transposed:
        u = tdf.compile_uops(*geo)
        w_flat = w.reshape(-1, ws[-2], ws[-1])
        w_taps = np.where(u.valid[:, :, None, None], w_flat[u.k_idx], 0)
        out_strides, q = (1,) * nd, u.q_sizes
    else:
        u = tdf.compile_conv_uops(*geo)
        w_taps = w.reshape(1, -1, ws[-2], ws[-1])
        out_strides, q = tuple(s), u.out_sizes
    x_pad = np.pad(x, ((0, 0),) + u.pad + ((0, 0),))
    bias = rng.normal(size=ws[-1]).astype(np.float32)
    return x_pad, w_taps.astype(np.float32), u, out_strides, tuple(q), bias


@pytest.mark.parametrize("splits", [None, 3], ids=["route", "split3"])
@pytest.mark.parametrize("xs,ws,s,p,transposed,act,has_bias",
                         EMULATION_CASES)
def test_tc_route_order_matches_plain_and_pallas(xs, ws, s, p, transposed,
                                                 act, has_bias, splits):
    x_pad, w_taps, u, out_strides, q, bias = _prepared(
        xs, ws, s, p, transposed, seed=ws[-1] + len(xs))
    nd = len(q)
    tables = TapTables.from_numpy(u.n_taps, u.tap_dy, u.tap_dx,
                                  torch.device("cpu"), tap_dz=u.tap_dz)
    tb = torch.from_numpy(bias) if has_bias else None
    xt, wt = torch.from_numpy(x_pad), torch.from_numpy(w_taps)
    got = tc_route_emulation(xt, wt, tables, out_strides, q, tb, act,
                             splits=splits)
    plain = ganax_conv_plain if nd == 2 else ganax_conv3d_plain
    ref = plain(xt, wt, tables, out_strides, *q, bias=tb, activation=act)
    torch.testing.assert_close(got, ref, **TOL)
    jb = jnp.asarray(bias)[None, :] if has_bias else None
    offsets = (u.tap_dy, u.tap_dx) if nd == 2 else (u.tap_dz, u.tap_dy,
                                                    u.tap_dx)
    pallas = ganax_conv_pallas if nd == 2 else ganax_conv3d_pallas
    jref = pallas(jnp.asarray(x_pad), jnp.asarray(w_taps),
                  jnp.asarray(u.n_taps), *map(jnp.asarray, offsets),
                  out_strides, *q, block_cin=ws[-2], block_cout=ws[-1],
                  bias=jb, activation=act, leaky_slope=0.2, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(jref), **TOL)


def test_tc_route_emulation_refuses_narrow_geometries():
    x_pad, w_taps, u, out_strides, q, _ = _prepared(
        (1, 4, 4, 4), (4, 4, 4, 3), (2, 2), (1, 1), True, seed=0)
    tables = TapTables.from_numpy(u.n_taps, u.tap_dy, u.tap_dx,
                                  torch.device("cpu"))
    with pytest.raises(ValueError, match="narrow"):
        tc_route_emulation(torch.from_numpy(x_pad), torch.from_numpy(w_taps),
                           tables, out_strides, q)
