"""The PyTorch port's GANAX kernels against the JAX package's.

* ``ganax_conv_plain`` / ``ganax_conv3d_plain`` (the kernels' plain
  PyTorch versions) against ``ganax_conv_pallas`` /
  ``ganax_conv3d_pallas`` in interpret mode, on identical prepared
  inputs (the phase-major contract);
* the op level (``kernels.ops``, 2-D and 3-D) against the JAX ops in
  interpret mode and against ``F.conv_transpose{2,3}d`` /
  ``F.conv{2,3}d``;
* the plain dataflows (``core.tconv``) and the dispatch backends.

The CUDA kernels themselves are held against the plain versions on the
card by ``test_torch_cuda.py``.

Tolerance: atol = rtol = 1e-5 per op — both sides sum in f32, in another
order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.core import dataflow as jdf
from repro.core.tconv import tconv_ganax as jax_tconv_ganax
from repro.core.tconv import tconv_zero_insert as jax_tconv_zero_insert
from repro.kernels import ops as jops
from repro.kernels.ganax_conv import ganax_conv3d_pallas, ganax_conv_pallas
from repro_torch.core import dataflow as tdf
from repro_torch.core.tconv import tconv_ganax, tconv_zero_insert
from repro_torch.kernels import build, ops
from repro_torch.kernels.ganax_conv import (TapTables, ganax_conv3d_cuda,
                                            ganax_conv3d_plain,
                                            ganax_conv_cuda, ganax_conv_plain)

TOL = dict(atol=1e-5, rtol=1e-5)

# (x shape, w shape, strides, paddings, transposed, activation, bias)
KERNEL_CASES = [
    ((2, 4, 4, 8), (4, 4, 8, 16), (2, 2), (1, 1), True, "relu", True),
    ((1, 6, 6, 8), (5, 5, 8, 8), (1, 1), (2, 2), True, "tanh", True),
    ((2, 4, 4, 4), (1, 1, 4, 8), (2, 2), (0, 0), True, "leaky_relu", True),
    ((2, 8, 8, 4), (4, 4, 4, 8), (2, 2), (1, 1), False, "leaky_relu", True),
    ((2, 8, 8, 8), (4, 4, 8, 3), (2, 2), (1, 1), True, "tanh", True),
    ((1, 5, 3, 4), (3, 5, 4, 4), (3, 2), (1, 2), True, "none", False),
    ((1, 8, 8, 3), (4, 4, 3, 8), (2, 2), (1, 1), False, "relu", False),
]

# 3-D, tiny (the Pallas 3-D kernel interprets at Python speed): a k4 s2
# tconv, a k1 s2 zero-tap tconv, a SIMD strided conv3d, Cout = 1, and
# no bias
KERNEL3D_CASES = [
    ((2, 3, 3, 3, 8), (4, 4, 4, 8, 4), (2, 2, 2), (1, 1, 1), True, "relu",
     True),
    ((1, 3, 2, 3, 4), (1, 1, 1, 4, 8), (2, 2, 2), (0, 0, 0), True,
     "leaky_relu", True),
    ((2, 6, 5, 6, 4), (4, 3, 4, 4, 8), (2, 1, 2), (1, 1, 1), False,
     "leaky_relu", True),
    ((1, 4, 4, 4, 8), (4, 4, 4, 8, 1), (2, 2, 2), (1, 1, 1), True, "tanh",
     True),
    ((1, 3, 3, 2, 4), (3, 3, 2, 4, 4), (1, 2, 2), (1, 1, 0), True, "none",
     False),
]


def _rand(rng, shape, scale=1.0):
    return (scale * rng.normal(size=shape)).astype(np.float32)


def _prepared(xs, ws, s, p, transposed, seed):
    """Numpy operands of one kernel call, prepared from the port's own
    μop tables: (x_pad, w_taps, uops, out_strides, q_sizes, bias), with
    the tap tables in ``uops``."""
    rng = np.random.default_rng(seed)
    x, w = _rand(rng, xs), _rand(rng, ws, 0.3)
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
    bias = _rand(rng, (ws[-1],))
    return (x_pad, w_taps.astype(np.float32), u, out_strides, q, bias)


def _tables(u) -> TapTables:
    return TapTables.from_numpy(u.n_taps, u.tap_dy, u.tap_dx,
                                torch.device("cpu"), tap_dz=u.tap_dz)


@pytest.mark.parametrize("xs,ws,s,p,transposed,act,has_bias", KERNEL_CASES)
def test_plain_kernel_matches_pallas_interpret(xs, ws, s, p, transposed,
                                               act, has_bias):
    (x_pad, w_taps, u, out_strides, (qy, qx),
     bias) = _prepared(xs, ws, s, p, transposed, seed=len(xs) + ws[-1])
    ref = ganax_conv_pallas(
        jnp.asarray(x_pad), jnp.asarray(w_taps), jnp.asarray(u.n_taps),
        jnp.asarray(u.tap_dy), jnp.asarray(u.tap_dx), out_strides, qy, qx,
        block_cin=ws[-2], block_cout=ws[-1],
        bias=jnp.asarray(bias)[None, :] if has_bias else None,
        activation=act, leaky_slope=0.2, interpret=True)
    tables = _tables(u)
    got = ganax_conv_plain(
        torch.from_numpy(x_pad), torch.from_numpy(w_taps), tables,
        out_strides, qy, qx,
        bias=torch.from_numpy(bias) if has_bias else None,
        activation=act, leaky_slope=0.2)
    assert tuple(got.shape) == tuple(ref.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("xs,ws,s,p,transposed,act,has_bias",
                         KERNEL3D_CASES)
def test_plain_kernel3d_matches_pallas_interpret(xs, ws, s, p, transposed,
                                                 act, has_bias):
    (x_pad, w_taps, u, out_strides, (qz, qy, qx),
     bias) = _prepared(xs, ws, s, p, transposed, seed=len(xs) + ws[-1])
    ref = ganax_conv3d_pallas(
        jnp.asarray(x_pad), jnp.asarray(w_taps), jnp.asarray(u.n_taps),
        jnp.asarray(u.tap_dz), jnp.asarray(u.tap_dy), jnp.asarray(u.tap_dx),
        out_strides, qz, qy, qx, block_cin=ws[-2], block_cout=ws[-1],
        bias=jnp.asarray(bias)[None, :] if has_bias else None,
        activation=act, leaky_slope=0.2, interpret=True)
    got = ganax_conv3d_plain(
        torch.from_numpy(x_pad), torch.from_numpy(w_taps), _tables(u),
        out_strides, qz, qy, qx,
        bias=torch.from_numpy(bias) if has_bias else None,
        activation=act, leaky_slope=0.2)
    assert tuple(got.shape) == tuple(ref.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def _op_inputs(xs, ws, seed):
    rng = np.random.default_rng(seed)
    return _rand(rng, xs), _rand(rng, ws, 0.3), _rand(rng, (ws[-1],))


@pytest.mark.parametrize("xs,ws,s,p,transposed,act,has_bias",
                         KERNEL_CASES + KERNEL3D_CASES)
def test_op_matches_jax_op_and_torch(xs, ws, s, p, transposed, act,
                                     has_bias):
    x, w, b = _op_inputs(xs, ws, seed=3 * ws[-1] + xs[1])
    ep_t = tdf.Epilogue(bias=has_bias, activation=act)
    ep_j = jdf.Epilogue(bias=has_bias, activation=act)
    tb = torch.from_numpy(b) if has_bias else None
    jb = jnp.asarray(b) if has_bias else None
    top = ops.ganax_conv_transpose if transposed else ops.ganax_conv
    jop = jops.ganax_conv_transpose if transposed else jops.ganax_conv
    got = top(torch.from_numpy(x), torch.from_numpy(w), s, p, epilogue=ep_t,
              bias=tb)
    ref = jop(jnp.asarray(x), jnp.asarray(w), s, p, interpret=True,
              epilogue=ep_j, bias=jb)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    # second oracle: PyTorch's own convolution (channels first, bias
    # included), then the activation
    nd = len(s)
    xn = torch.from_numpy(x).movedim(-1, 1)
    tw = torch.from_numpy(w)
    if transposed:
        conv_t = F.conv_transpose2d if nd == 2 else F.conv_transpose3d
        y = conv_t(xn, tw.permute(nd, nd + 1, *range(nd)), tb, stride=s,
                   padding=p)
    else:
        conv_f = F.conv2d if nd == 2 else F.conv3d
        y = conv_f(xn, tw.permute(nd + 1, nd, *range(nd)), tb, stride=s,
                   padding=p)
    y = tdf.Epilogue(activation=act).apply(y.movedim(1, -1))
    np.testing.assert_allclose(got.numpy(), y.numpy(), **TOL)


# (x shape, w shape, strides, paddings) — 2-D and 3-D, kernel < stride
TCONV_CASES = [
    ((2, 4, 4, 8), (4, 4, 8, 16), (2, 2), (1, 1)),
    ((1, 5, 3, 4), (3, 5, 4, 4), (3, 2), (1, 2)),
    ((1, 4, 4, 2), (1, 1, 2, 3), (2, 2), (0, 0)),
    ((2, 6, 6, 3), (5, 5, 3, 4), (1, 1), (2, 2)),
    ((1, 3, 3, 3, 4), (4, 4, 4, 4, 8), (2, 2, 2), (1, 1, 1)),
]


@pytest.mark.parametrize("xs,ws,s,p", TCONV_CASES)
def test_plain_dataflows_match_jax(xs, ws, s, p):
    x, w, _ = _op_inputs(xs, ws, seed=xs[-1] + ws[-1])
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    jx, jw = jnp.asarray(x), jnp.asarray(w)
    np.testing.assert_allclose(tconv_ganax(tx, tw, s, p).numpy(),
                               np.asarray(jax_tconv_ganax(jx, jw, s, p)),
                               **TOL)
    np.testing.assert_allclose(tconv_zero_insert(tx, tw, s, p).numpy(),
                               np.asarray(jax_tconv_zero_insert(jx, jw, s, p)),
                               **TOL)


@pytest.mark.parametrize("backend", ["ganax", "ganax-plain", "polyphase",
                                     "zero-insert"])
@pytest.mark.parametrize("transposed", [True, False])
def test_dispatch_backends_agree(backend, transposed):
    x, w, b = _op_inputs((2, 6, 6, 4), (4, 4, 4, 8), seed=7)
    ep_t = tdf.Epilogue(bias=True, activation="leaky_relu", leaky_slope=0.1)
    ep_j = jdf.Epilogue(bias=True, activation="leaky_relu", leaky_slope=0.1)
    op = tdf.tconv if transposed else tdf.conv
    jop = jdf.tconv if transposed else jdf.conv
    got = op(torch.from_numpy(x), torch.from_numpy(w), (2, 2), (1, 1),
             backend=backend, bias=torch.from_numpy(b), epilogue=ep_t)
    ref = jop(jnp.asarray(x), jnp.asarray(w), (2, 2), (1, 1),
              policy=jdf.DataflowPolicy(backend="polyphase"),
              bias=jnp.asarray(b), epilogue=ep_j)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_kernel_backends_refuse_other_ranks():
    # the kernels implement 2-D and 3-D layers; 1-D and 4-D are refused
    x1, w1 = torch.zeros((1, 3, 4)), torch.zeros((4, 4, 8))
    x4, w4 = torch.zeros((1, 2, 2, 2, 2, 4)), torch.zeros((2,) * 4 + (4, 8))
    for backend in (None, "ganax", "ganax-plain"):
        with pytest.raises(NotImplementedError, match="2-D and 3-D"):
            tdf.tconv(x1, w1, (2,), (1,), backend=backend)
        with pytest.raises(NotImplementedError, match="2-D and 3-D"):
            tdf.conv(x4, w4, (1,) * 4, (0,) * 4, backend=backend)
    with pytest.raises(NotImplementedError, match="2-D and 3-D"):
        ops.ganax_conv_transpose(x1, w1, (2,), (1,))
    assert tdf.tconv(x1, w1, (2,), (1,),
                     backend="polyphase").shape == (1, 6, 8)
    with pytest.raises(ValueError, match="unknown dataflow backend"):
        tdf.tconv(x1, w1, (2,), (1,), backend="pallas-tpu")


def test_kernel_ops_refuse_gradients_and_other_dtypes():
    x = torch.zeros((1, 4, 4, 8), requires_grad=True)
    w = torch.zeros((4, 4, 8, 16))
    with pytest.raises(NotImplementedError, match="records no gradient"):
        ops.ganax_conv_transpose(x, w, (2, 2), (1, 1))
    with torch.no_grad():
        assert ops.ganax_conv_transpose(x, w, (2, 2), (1, 1)).shape == \
            (1, 8, 8, 16)
    # a storage dtype serves and comes out in it; x and w must share
    # one, and float64 is none
    y = ops.ganax_conv_transpose(x.detach().bfloat16(), w.bfloat16(),
                                 (2, 2), (1, 1))
    assert y.dtype == torch.bfloat16 and y.shape == (1, 8, 8, 16)
    for xd, wd in ((torch.bfloat16, torch.float32),
                   (torch.float64, torch.float64)):
        with pytest.raises(TypeError, match="storage dtype"):
            ops.ganax_conv_transpose(x.detach().to(xd), w.to(wd), (2, 2),
                                     (1, 1))


@pytest.mark.parametrize("act", ["none", "relu", "leaky_relu", "tanh"])
def test_epilogue_matches_jax(act):
    rng = np.random.default_rng(11)
    y, b = _rand(rng, (2, 3, 3, 5)), _rand(rng, (5,))
    for bias in (False, True):
        got = tdf.Epilogue(bias=bias, activation=act, leaky_slope=0.3).apply(
            torch.from_numpy(y), torch.from_numpy(b))
        ref = jdf.Epilogue(bias=bias, activation=act, leaky_slope=0.3).apply(
            jnp.asarray(y), jnp.asarray(b))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    # non-leaky specs canonicalize their slope, as the reference's
    assert tdf.Epilogue(activation="relu", leaky_slope=0.5) == \
        tdf.Epilogue(activation="relu")
    with pytest.raises(ValueError):
        tdf.Epilogue(activation="gelu")


def test_cuda_wrapper_refuses_cpu_tensors():
    (x_pad, w_taps, u, out_strides, (qy, qx),
     _) = _prepared((1, 4, 4, 8), (4, 4, 8, 16), (2, 2), (1, 1), True, 0)
    tables = _tables(u)
    with pytest.raises(ValueError, match="CUDA"):
        ganax_conv_cuda(torch.from_numpy(x_pad), torch.from_numpy(w_taps),
                        tables, out_strides, qy, qx)
    # a table that reads past the padded input is refused before launch
    short = torch.from_numpy(x_pad[:, :-1])
    with pytest.raises(ValueError, match="reads past"):
        ganax_conv_plain(short, torch.from_numpy(w_taps), tables,
                         out_strides, qy, qx)


def test_cuda3d_wrapper_refuses_cpu_tensors_and_bad_tables():
    (x_pad, w_taps, u, out_strides, q,
     _) = _prepared((1, 3, 3, 3, 4), (4, 4, 4, 4, 8), (2, 2, 2), (1, 1, 1),
                    True, 0)
    tables = _tables(u)
    assert tables.rank == 3 and len(tables.taps[0][0]) == 3
    x, w = torch.from_numpy(x_pad), torch.from_numpy(w_taps)
    with pytest.raises(ValueError, match="CUDA"):
        ganax_conv3d_cuda(x, w, tables, out_strides, *q)
    # 2-D tables for a 3-D call, and a 3-D input for the 2-D kernel
    planar = TapTables.from_numpy(u.n_taps, u.tap_dy, u.tap_dx,
                                  torch.device("cpu"))
    with pytest.raises(ValueError, match="2-D tap tables"):
        ganax_conv3d_plain(x, w, planar, out_strides, *q)
    with pytest.raises(ValueError, match="x_pad must be"):
        ganax_conv_plain(x, w, tables, out_strides[:2], *q[:2])
    with pytest.raises(ValueError, match="tap tables disagree"):
        TapTables.from_numpy(u.n_taps, u.tap_dy, u.tap_dx,
                             torch.device("cpu"), tap_dz=u.tap_dz[:, :1])


def test_tap_tables_3d_refuse_a_tap_past_x_pad_in_depth():
    (x_pad, w_taps, u, out_strides, (qz, qy, qx),
     _) = _prepared((1, 3, 3, 3, 4), (4, 4, 4, 4, 8), (2, 2, 2), (1, 1, 1),
                    True, 1)
    x, w = torch.from_numpy(x_pad), torch.from_numpy(w_taps)
    tables = _tables(u)
    assert ganax_conv3d_plain(x, w, tables, out_strides, qz, qy, qx).shape \
        == (1, 8, qz, qy, qx, 8)
    # one plane short in depth: the deepest tap's window leaves x_pad
    with pytest.raises(ValueError, match="reads past"):
        ganax_conv3d_plain(x[:, :-1].contiguous(), w, tables, out_strides,
                           qz, qy, qx)
    # a tap moved so deep that its window ends one plane past x_pad
    deep = u.tap_dz.copy()
    deep[0, 0] = x_pad.shape[1] - (qz - 1)
    moved = TapTables.from_numpy(u.n_taps, u.tap_dy, u.tap_dx,
                                 torch.device("cpu"), tap_dz=deep)
    with pytest.raises(ValueError, match="reads past"):
        ganax_conv3d_plain(x, w, moved, out_strides, qz, qy, qx)
    with pytest.raises(ValueError, match=">= 0"):
        TapTables.from_numpy(u.n_taps, u.tap_dy, u.tap_dx,
                             torch.device("cpu"), tap_dz=-1 - u.tap_dz)


def test_build_names_libraries_by_source_hash(tmp_path, monkeypatch):
    """Each library is named by its source's hash and every header's: an
    edited ``csrc/*.cuh`` renames (so rebuilds) the libraries, an
    unchanged tree keeps their names."""
    assert {"ganax_conv", "ganax_conv3d"} <= set(build.sources())
    for name in ("ganax_conv", "ganax_conv3d"):
        path = build._library_path(name)
        assert path.parent == build.BUILD_DIR
        assert path.name.startswith(f"{name}-") and path.suffix == ".so"
    with pytest.raises(ValueError, match="no kernel source"):
        build._library_path("missing_kernel")
    for f in build.CSRC.glob("ganax_conv*"):
        (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(build, "CSRC", tmp_path)
    before = {n: build._library_path(n) for n in ("ganax_conv",
                                                  "ganax_conv3d")}
    assert before == {n: build._library_path(n) for n in before}
    header = tmp_path / "ganax_conv_sm90.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: build._library_path(n) for n in before}
    assert all(after[n] != before[n] for n in before)
    assert all(after[n].name.startswith(f"{n}-") for n in before)
