"""The PyTorch port's CUDA kernels on the card, against their plain versions.

Every test here needs a CUDA card and skips without one.  The file
imports nothing of JAX, so it also runs where JAX is not installed:

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_cuda.py

Tolerance: atol = rtol = 1e-4 — f32 against f32, summed in another
order; for the flash-attention kernel in bf16, and the GANAX kernels'
bf16 and f16 instances, atol 1e-3 and rtol 2^-6 (bf16) or 2^-9 (f16):
both sides compute in f32 from the same 2-byte inputs and round the
output once, so at most one ulp (<= 2^-7 or 2^-10 of the value) apart.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import dataflow as tdf
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                 flash_attention_ffma,
                                                 flash_attention_plain,
                                                 flash_attention_wgmma,
                                                 kernel_variant)
from repro_torch.kernels.ganax_conv import (apply_epilogue_to_acc,
                                            check_tma_weights,
                                            ganax_conv3d_cuda,
                                            ganax_conv3d_plain,
                                            ganax_conv_cuda, ganax_conv_plain,
                                            plain_sums)
from repro_torch.launch.serve import reduced_config
from repro_torch.models import transformer as tr
from repro_torch.models.gan import GanConfig, init_gan
from repro_torch.quickstart import make_batch_fn
from repro_torch.serve.engine import DecodeEngine, EngineConfig, Request
from repro_torch.serve.gan import GanServer
from repro_torch.train.loop import make_gan_train_step

TOL = dict(atol=1e-4, rtol=1e-4)

pytestmark = pytest.mark.gpu

# (x shape, w shape, strides, paddings, transposed, activation, bias)
CASES = [
    ((2, 4, 4, 64), (4, 4, 64, 128), (2, 2), (1, 1), True, "relu", True),
    ((3, 6, 6, 8), (5, 5, 8, 72), (1, 1), (2, 2), True, "tanh", True),
    ((2, 4, 4, 4), (1, 1, 4, 8), (2, 2), (0, 0), True, "leaky_relu", True),
    ((2, 8, 8, 20), (4, 4, 20, 8), (2, 2), (1, 1), False, "leaky_relu", True),
    ((2, 8, 8, 33), (4, 4, 33, 3), (2, 2), (1, 1), True, "tanh", True),
    ((1, 5, 3, 4), (3, 5, 4, 4), (3, 2), (1, 2), True, "none", False),
    ((1, 9, 9, 3), (4, 4, 3, 65), (2, 2), (1, 1), False, "relu", False),
    ((5, 7, 7, 17), (3, 3, 17, 1), (3, 3), (0, 0), False, "none", True),
    # 3-D: the volumetric kernel (3D-GAN g-layers, strided conv3d, Cout = 1,
    # zero-tap phases, ragged Cin / Cout not a multiple of 16 or 64)
    ((2, 4, 4, 4, 64), (4, 4, 4, 64, 128), (2, 2, 2), (1, 1, 1), True,
     "relu", True),
    ((2, 8, 8, 8, 16), (4, 4, 4, 16, 1), (2, 2, 2), (1, 1, 1), True,
     "tanh", True),
    ((2, 8, 8, 8, 20), (4, 4, 4, 20, 72), (2, 2, 2), (1, 1, 1), False,
     "leaky_relu", True),
    ((3, 7, 5, 6, 17), (3, 2, 3, 17, 1), (2, 1, 3), (1, 0, 1), False,
     "none", True),
    ((2, 4, 3, 5, 4), (1, 1, 1, 4, 8), (2, 2, 2), (0, 0, 0), True,
     "leaky_relu", True),
    ((1, 5, 3, 4, 33), (3, 5, 2, 33, 65), (3, 2, 1), (1, 2, 0), True,
     "none", False),
]

# The geometries training adds, at batch 2 and their real widths: the
# discriminators' d1 (Cin = 3, or 1 in 3-D) and d5 (4×4, stride 1, pad
# 0, 4×4 → 1×1, Cout = 1), d5's adjoint (a stride-1 pad-0 tconv from a
# 1×1 input with Cin = 1), the pad-0 adjoints of d1 and d2 (stride-2
# tconvs whose output is 2 wider than the crop), and g4's adjoint (a conv
# reading Cin = 3, or 1 in 3-D; the d1 geometry).
TRAIN_CASES = [
    ((2, 64, 64, 3), (4, 4, 3, 128), (2, 2), (1, 1), False, "leaky_relu",
     True),
    ((2, 4, 4, 1024), (4, 4, 1024, 1), (1, 1), (0, 0), False, "none", True),
    ((2, 1, 1, 1), (4, 4, 1, 1024), (1, 1), (0, 0), True, "none", False),
    ((2, 32, 32, 128), (4, 4, 128, 3), (2, 2), (0, 0), True, "none", False),
    ((2, 16, 16, 256), (4, 4, 256, 128), (2, 2), (0, 0), True, "none",
     False),
    ((2, 64, 64, 64, 1), (4, 4, 4, 1, 64), (2, 2, 2), (1, 1, 1), False,
     "leaky_relu", True),
    ((2, 4, 4, 4, 512), (4, 4, 4, 512, 1), (1, 1, 1), (0, 0, 0), False,
     "none", True),
    ((2, 1, 1, 1, 1), (4, 4, 4, 1, 512), (1, 1, 1), (0, 0, 0), True, "none",
     False),
    ((2, 32, 32, 32, 64), (4, 4, 4, 64, 1), (2, 2, 2), (0, 0, 0), True,
     "none", False),
    ((2, 16, 16, 16, 128), (4, 4, 4, 128, 64), (2, 2, 2), (0, 0, 0), True,
     "none", False),
]

_KERNELS = {2: (ganax_conv_cuda, ganax_conv_plain),
            3: (ganax_conv3d_cuda, ganax_conv3d_plain)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel runs only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False
    return torch.device("cuda")


def _inputs(xs, ws, dev, seed=5):
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.normal(size=xs), dtype=torch.float32, device=dev)
    w = torch.tensor(0.3 * rng.normal(size=ws), dtype=torch.float32,
                     device=dev)
    b = torch.tensor(rng.normal(size=ws[-1]), dtype=torch.float32,
                     device=dev)
    return x, w, b


@pytest.mark.parametrize("xs,ws,s,p,transposed,act,has_bias",
                         CASES + TRAIN_CASES)
def test_cuda_kernel_matches_plain(dev, xs, ws, s, p, transposed, act,
                                   has_bias):
    x, w, b = _inputs(xs, ws, dev)
    operands = ops.kernel_operands(x, w, s, p, transposed=transposed)
    b = b if has_bias else None
    kernel, plain = _KERNELS[len(s)]
    before = kernel.launches
    got = kernel(**operands, bias=b, activation=act)
    assert kernel.launches == before + 1
    ref = plain(**operands, bias=b, activation=act)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref, **TOL)


@pytest.mark.parametrize("xs,ws,s,p,transposed,act,has_bias",
                         CASES + TRAIN_CASES)
def test_cuda_op_matches_plain_op(dev, xs, ws, s, p, transposed, act,
                                  has_bias):
    x, w, b = _inputs(xs, ws, dev, seed=6)
    ep = tdf.Epilogue(bias=has_bias, activation=act)
    op = tdf.tconv if transposed else tdf.conv
    b = b if has_bias else None
    got = op(x, w, s, p, bias=b, epilogue=ep)
    ref = op(x, w, s, p, bias=b, epilogue=ep, backend="ganax-plain")
    assert got.is_cuda
    torch.testing.assert_close(got, ref, **TOL)


# Each route of the Hopper kernels at real widths and batch 2: (x
# shape, w shape, strides, paddings, transposed, activation, bias, the
# route's name).  narrow: g4 and d1's dx; narrow+split_k: d5; tc with the
# flattened K: d1 (Cin 3 or 1) and d5's dx (Cin 1); tc+split_k: g1 and
# d4, which fill few tiles at batch 2; tc: a g3-like tconv (3-D: the
# 64-wide tile).
ROUTE_CASES = [
    ((2, 32, 32, 128), (4, 4, 128, 3), (2, 2), (1, 1), True, "tanh", True,
     "narrow"),
    ((2, 32, 32, 128), (4, 4, 128, 3), (2, 2), (0, 0), True, "none", False,
     "narrow"),
    ((2, 4, 4, 1024), (4, 4, 1024, 1), (1, 1), (0, 0), False, "none", True,
     "narrow+split_k"),
    ((2, 64, 64, 3), (4, 4, 3, 128), (2, 2), (1, 1), False, "leaky_relu",
     True, "tc"),
    ((2, 1, 1, 1), (4, 4, 1, 1024), (1, 1), (0, 0), True, "none", False,
     "tc"),
    ((2, 4, 4, 1024), (4, 4, 1024, 512), (2, 2), (1, 1), True, "relu", True,
     "tc+split_k"),
    ((2, 8, 8, 512), (4, 4, 512, 1024), (2, 2), (1, 1), False, "leaky_relu",
     True, "tc+split_k"),
    ((2, 64, 64, 128), (4, 4, 128, 256), (2, 2), (1, 1), True, "none",
     False, "tc"),
    ((2, 32, 32, 32, 64), (4, 4, 4, 64, 1), (2, 2, 2), (1, 1, 1), True,
     "tanh", True, "narrow"),
    ((2, 32, 32, 32, 64), (4, 4, 4, 64, 1), (2, 2, 2), (0, 0, 0), True,
     "none", False, "narrow"),
    ((2, 4, 4, 4, 512), (4, 4, 4, 512, 1), (1, 1, 1), (0, 0, 0), False,
     "none", True, "narrow+split_k"),
    ((2, 64, 64, 64, 1), (4, 4, 4, 1, 64), (2, 2, 2), (1, 1, 1), False,
     "leaky_relu", True, "tc"),
    ((2, 1, 1, 1, 1), (4, 4, 4, 1, 512), (1, 1, 1), (0, 0, 0), True, "none",
     False, "tc"),
    ((2, 4, 4, 4, 512), (4, 4, 4, 512, 256), (2, 2, 2), (1, 1, 1), True,
     "relu", True, "tc+split_k"),
    ((2, 16, 16, 16, 128), (4, 4, 4, 128, 64), (2, 2, 2), (1, 1, 1), True,
     "none", False, "tc"),
]


@pytest.mark.parametrize("xs,ws,s,p,transposed,act,has_bias,route",
                         ROUTE_CASES)
def test_each_route_matches_plain(dev, xs, ws, s, p, transposed, act,
                                  has_bias, route):
    x, w, b = _inputs(xs, ws, dev, seed=8)
    w = w * (0.3 * np.prod(ws[:-1])) ** -0.5     # unit-scale outputs
    operands = ops.kernel_operands(x, w, s, p, transposed=transposed)
    b = b if has_bias else None
    kernel, plain = _KERNELS[len(s)]
    before = dict(kernel.launches_by_route), kernel.launches
    got = kernel(**operands, bias=b, activation=act)
    torch.cuda.synchronize()
    assert kernel.launches == before[1] + 1
    assert kernel.launches_by_route[route] == before[0].get(route, 0) + 1
    ref = plain(**operands, bias=b, activation=act)
    torch.testing.assert_close(got, ref, **TOL)


@pytest.mark.parametrize("xs,ws,s,p", [
    ((2, 4, 4, 1024), (4, 4, 1024, 512), (2, 2), (1, 1)),
    ((2, 4, 4, 4, 512), (4, 4, 4, 512, 256), (2, 2, 2), (1, 1, 1)),
], ids=["dcgan-g1", "3dgan-g1"])
def test_tc_route_is_as_exact_as_plain_against_float64(dev, xs, ws, s, p):
    """A wide tc launch and the plain version against the same sums in
    float64: the kernel's mean error is within twice the plain
    version's, and its worst output uses at most half of the 1e-4
    tolerance against the exact value.  Prints both."""
    x, w, b = _inputs(xs, ws, dev, seed=9)
    w = w * (0.3 * np.prod(ws[:-1])) ** -0.5
    operands = ops.kernel_operands(x, w, s, p, transposed=True)
    kernel, plain = _KERNELS[len(s)]
    got = kernel(**operands, bias=b, activation="none")
    ref = plain(**operands, bias=b, activation="none")
    q = tuple(operands[k] for k in ("qz", "qy", "qx") if k in operands)
    exact = apply_epilogue_to_acc(
        plain_sums(operands["x_pad"].double(), operands["w_taps"].double(),
                   operands["tables"], operands["out_strides"], q),
        b.double(), "none", 0.2)
    err, ref_err = (got.double() - exact).abs(), (ref.double() - exact).abs()
    share = (err / (TOL["atol"] + TOL["rtol"] * exact.abs())).max().item()
    print(f"mean |error| against float64: kernel {err.mean().item():.3e}, "
          f"plain {ref_err.mean().item():.3e}; the kernel's worst output at "
          f"{share:.4f} of the tolerance")
    assert err.mean().item() <= 2 * ref_err.mean().item()
    assert share <= 0.5


# The bf16 and f16 instances on each route, at real widths and batch 2
# (x shape, w shape, strides, paddings, transposed, activation, bias, the
# route at 2 bytes): tc (a g3-like tconv); tc with the flattened K at Cin
# 3 (DCGAN d1), 1 (3D-GAN d1) and 4 (flat at 2 bytes only); tc+split_k
# (g1, d4, 3D-GAN g1); odd tails in rows (105) and Cout (72) with Cin 40
# (a stage of 64 channels partly zero-filled); narrow (g4, 3D-GAN g4, Cin
# 17 with 2-byte loads); narrow+split_k (d5, 3D-GAN d5).
LOW_ROUTE_CASES = [
    ((2, 64, 64, 128), (4, 4, 128, 256), (2, 2), (1, 1), True, "relu", True,
     "tc"),
    ((2, 64, 64, 3), (4, 4, 3, 128), (2, 2), (1, 1), False, "leaky_relu",
     True, "tc"),
    ((2, 64, 64, 64, 1), (4, 4, 4, 1, 64), (2, 2, 2), (1, 1, 1), False,
     "leaky_relu", True, "tc"),
    ((2, 16, 16, 4), (3, 3, 4, 32), (1, 1), (1, 1), False, "none", False,
     "tc"),
    ((2, 4, 4, 1024), (4, 4, 1024, 512), (2, 2), (1, 1), True, "relu", True,
     "tc+split_k"),
    ((2, 8, 8, 512), (4, 4, 512, 1024), (2, 2), (1, 1), False, "leaky_relu",
     True, "tc+split_k"),
    ((2, 4, 4, 4, 512), (4, 4, 4, 512, 256), (2, 2, 2), (1, 1, 1), True,
     "relu", True, "tc+split_k"),
    ((3, 7, 5, 40), (3, 3, 40, 72), (1, 1), (1, 1), False, "tanh", True,
     "tc"),
    ((2, 32, 32, 128), (4, 4, 128, 3), (2, 2), (1, 1), True, "tanh", True,
     "narrow"),
    ((2, 32, 32, 32, 64), (4, 4, 4, 64, 1), (2, 2, 2), (1, 1, 1), True,
     "tanh", True, "narrow"),
    ((5, 7, 7, 17), (3, 3, 17, 1), (3, 3), (0, 0), False, "none", True,
     "narrow"),
    ((2, 4, 4, 1024), (4, 4, 1024, 1), (1, 1), (0, 0), False, "none", True,
     "narrow+split_k"),
    ((2, 4, 4, 4, 512), (4, 4, 4, 512, 1), (1, 1, 1), (0, 0, 0), False,
     "none", True, "narrow+split_k"),
]
# two storage ulps (chip_smoke.py's STORAGE_TOL)
TWO_ULPS = {torch.bfloat16: dict(atol=1e-3, rtol=2 ** -6),
            torch.float16: dict(atol=1e-3, rtol=2 ** -9)}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "f16"])
@pytest.mark.parametrize("xs,ws,s,p,transposed,act,has_bias,route",
                         LOW_ROUTE_CASES)
def test_storage_dtype_instance_matches_plain(dev, xs, ws, s, p, transposed,
                                              act, has_bias, route, dtype):
    """The bf16 / f16 instance of each route against the plain version at
    the same dtype (f32 sums of exact products, one cast): within two
    storage ulps; the output comes in the storage dtype, and the launch
    is counted under its route and dtype."""
    x, w, b = _inputs(xs, ws, dev, seed=10)
    w = w * (0.3 * np.prod(ws[:-1])) ** -0.5     # unit-scale outputs
    operands = ops.kernel_operands(x.to(dtype), w.to(dtype), s, p,
                                   transposed=transposed)
    b = b if has_bias else None
    kernel, plain = _KERNELS[len(s)]
    name = str(dtype).removeprefix("torch.")
    before = (kernel.launches, kernel.launches_by_route[route],
              kernel.launches_by_dtype[name])
    got = kernel(**operands, bias=b, activation=act)
    torch.cuda.synchronize()
    assert (kernel.launches, kernel.launches_by_route[route],
            kernel.launches_by_dtype[name]) == tuple(n + 1 for n in before)
    ref = plain(**operands, bias=b, activation=act)
    assert got.dtype == ref.dtype == dtype
    torch.testing.assert_close(got.float(), ref.float(), **TWO_ULPS[dtype])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "f16"])
def test_storage_dtype_instance_refuses_misaligned_operands(dev, dtype):
    """At 2 bytes as at f32: x_pad 2 bytes off a 16-byte boundary, tc
    weights whose row of K = 36 values is 72 bytes, and mixed dtypes
    raise before any launch, and nothing falls back."""
    x, w, _ = _inputs((1, 4, 4, 64), (4, 4, 64, 128), dev)
    operands = ops.kernel_operands(x.to(dtype), w.to(dtype), (2, 2), (1, 1),
                                   transposed=True)
    xp = operands["x_pad"]
    flat = torch.zeros(xp.numel() + 1, device=dev, dtype=dtype)
    shifted = flat[1:].view(xp.shape)
    shifted.copy_(xp)
    before = ganax_conv_cuda.launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        ganax_conv_cuda(**dict(operands, x_pad=shifted))
    with pytest.raises(TypeError, match="storage dtype"):
        ganax_conv_cuda(**dict(operands, w_taps=operands["w_taps"].float()))
    assert ganax_conv_cuda.launches == before
    with pytest.raises(ValueError, match="72"):
        check_tma_weights(torch.zeros((1, 8, 36), device=dev, dtype=dtype))
    with pytest.raises(ValueError, match="16-byte aligned"):
        check_tma_weights(torch.zeros(8 * 64 + 1, device=dev, dtype=dtype)
                          [1:].view(1, 8, 64))


@pytest.mark.parametrize("dtype", ["bf16", "f16"])
def test_quantized_program_on_the_card(dev, dtype):
    """An int8 export served with g_params=None on the card: its weights
    dequantize to the CPU's bits, GanServer serves through the kernel's
    instance of the program's dtype, and GanEngine's stream equals the
    server's bit for bit."""
    from repro_torch.program import Program, ProgramSpec
    from repro_torch.quant import dequantize_params, quantize_program
    from repro_torch.serve.gan_engine import GanEngine
    cfg = GanConfig("dcgan", channel_scale=1 / 32, dtype=dtype)
    g, _ = init_gan(cfg, torch.Generator().manual_seed(0), "cpu")
    spec = quantize_program(ProgramSpec.build(cfg, 4, "generator"), g)
    prog = Program(spec, device=dev, differentiable=False)
    cpu = dequantize_params(spec.quantized_params, spec.dtype)
    for k, v in prog.params.items():
        assert v.is_cuda and v.dtype == cpu[k].dtype
        assert torch.equal(v.cpu(), cpu[k])
    base = GanConfig("dcgan", channel_scale=1 / 32)
    before = ganax_conv_cuda.launches_by_dtype[spec.dtype]
    ref = GanServer(base, None, batch_size=4, program=prog,
                    device=dev).generate(14)
    assert ref.is_cuda and str(ref.dtype) == f"torch.{spec.dtype}"
    assert ganax_conv_cuda.launches_by_dtype[spec.dtype] - before == 16
    with GanEngine(base, None, buckets=(4,), program=prog,
                   device=dev) as engine:
        got = torch.cat([f.result(30) for f in
                         [engine.submit(n) for n in (3, 6, 5)]])
    assert torch.equal(got, ref.cpu())


@pytest.mark.parametrize("dtype,flag", [
    (torch.bfloat16, "allow_bf16_reduced_precision_reduction"),
    (torch.float16, "allow_fp16_reduced_precision_reduction")],
    ids=["bf16", "f16"])
def test_reduced_precision_sums_are_refused_on_the_card(dev, dtype, flag):
    from repro_torch.device import require_f32_accumulation
    t = torch.zeros(4, dtype=dtype, device=dev)
    matmul = torch.backends.cuda.matmul
    setattr(matmul, flag, True)
    try:
        with pytest.raises(RuntimeError, match=flag):
            require_f32_accumulation(t)
    finally:
        setattr(matmul, flag, False)
    require_f32_accumulation(t)


def test_cuda_wrapper_refuses_addresses_and_strides_tma_cannot_read(dev):
    """x_pad 4 bytes off a 16-byte boundary (its rows are read by 16-byte
    copies) raises before any launch; so do tc weights whose row of K =
    35 floats (140 bytes) or whose address TMA cannot take."""
    x, w, _ = _inputs((1, 4, 4, 64), (4, 4, 64, 128), dev)
    operands = ops.kernel_operands(x, w, (2, 2), (1, 1), transposed=True)
    xp = operands["x_pad"]
    flat = torch.zeros(xp.numel() + 1, device=dev)
    shifted = flat[1:].view(xp.shape)
    shifted.copy_(xp)
    before = ganax_conv_cuda.launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        ganax_conv_cuda(**dict(operands, x_pad=shifted))
    assert ganax_conv_cuda.launches == before
    with pytest.raises(ValueError, match="140"):
        check_tma_weights(torch.zeros((1, 8, 35), device=dev))
    with pytest.raises(ValueError, match="16-byte aligned"):
        check_tma_weights(torch.zeros(8 * 32 + 1, device=dev)[1:]
                          .view(1, 8, 32))


def test_cuda_wrapper_refuses_what_the_kernel_does_not_take(dev):
    x, w, _ = _inputs((1, 4, 4, 8), (4, 4, 8, 16), dev)
    operands = ops.kernel_operands(x, w, (2, 2), (1, 1), transposed=True)
    with pytest.raises(ValueError, match="contiguous"):
        ganax_conv_cuda(**dict(operands, x_pad=operands["x_pad"]
                               .transpose(1, 2)))
    with pytest.raises(ValueError, match="CUDA device"):
        ganax_conv_cuda(**dict(operands, w_taps=operands["w_taps"].cpu()))
    with pytest.raises(TypeError, match="float32"):
        ganax_conv_cuda(**dict(operands, x_pad=operands["x_pad"].double()))
    x3, w3, _ = _inputs((1, 3, 3, 3, 4), (4, 4, 4, 4, 8), dev)
    ops3 = ops.kernel_operands(x3, w3, (2, 2, 2), (1, 1, 1), transposed=True)
    with pytest.raises(ValueError, match="contiguous"):
        ganax_conv3d_cuda(**dict(ops3, x_pad=ops3["x_pad"].transpose(1, 3)))
    with pytest.raises(ValueError, match="CUDA device"):
        ganax_conv3d_cuda(**dict(ops3, x_pad=ops3["x_pad"].cpu()))
    x1 = torch.zeros((1, 3, 4), device=dev)
    w1 = torch.zeros((4, 4, 8), device=dev)
    with pytest.raises(NotImplementedError, match="2-D and 3-D"):
        tdf.tconv(x1, w1, (2,), (1,))


def test_server_on_the_card_launches_the_kernel(dev):
    cfg = GanConfig("dcgan", channel_scale=1 / 32)
    g, _ = init_gan(cfg, torch.Generator().manual_seed(0), dev)
    server = GanServer(cfg, g, batch_size=4, seed=0, device=dev)
    before = ganax_conv_cuda.launches
    img = server.generate(6)
    torch.cuda.synchronize()
    assert img.is_cuda and tuple(img.shape) == (6, 64, 64, 3)
    assert ganax_conv_cuda.launches - before == 4 * server.batches_served
    ref = GanServer(dataclasses.replace(cfg, backend="ganax-plain"), g,
                    batch_size=4, seed=0, device=dev).generate(6)
    torch.testing.assert_close(img, ref, **TOL)


def test_3dgan_server_on_the_card_launches_the_3d_kernel(dev):
    cfg = GanConfig("3dgan", channel_scale=1 / 32)
    g, _ = init_gan(cfg, torch.Generator().manual_seed(0), dev)
    server = GanServer(cfg, g, batch_size=2, seed=0, device=dev)
    before = ganax_conv3d_cuda.launches
    vol = server.generate(3)
    torch.cuda.synchronize()
    assert vol.is_cuda and tuple(vol.shape) == (3, 64, 64, 64, 1)
    assert ganax_conv3d_cuda.launches - before == 4 * server.batches_served
    ref = GanServer(dataclasses.replace(cfg, backend="ganax-plain"), g,
                    batch_size=2, seed=0, device=dev).generate(3)
    torch.testing.assert_close(vol, ref, **TOL)


@pytest.mark.parametrize("depth", [1, 2])
def test_engine_on_the_card_matches_the_server(dev, depth):
    """GanEngine on the card: its copy stream delivers CPU samples equal,
    bit for bit, to GanServer.generate's, every batch through the
    kernel; the façade's generate stays on the card."""
    from repro_torch.serve.gan_engine import GanEngine
    cfg = GanConfig("dcgan", channel_scale=1 / 32)
    g, _ = init_gan(cfg, torch.Generator().manual_seed(0), dev)
    ref = GanServer(cfg, g, batch_size=4, seed=0, device=dev).generate(14)
    engine = GanEngine(cfg, g, buckets=(4,), seed=0, device=dev,
                       pipeline_depth=depth)
    before = ganax_conv_cuda.launches
    futures = [engine.submit(n) for n in (3, 6, 5)]
    got = torch.cat([f.result(30) for f in futures])
    engine.close(timeout=30)
    assert got.device.type == "cpu" and torch.equal(got, ref.cpu())
    assert ganax_conv_cuda.launches - before == 4 * engine.batches_served
    server = GanServer(cfg, g, batch_size=4, seed=0, device=dev)
    parts = [server.generate(3), server.submit(6).result(30),
             server.generate(5)]
    server.close(timeout=30)
    assert parts[0].is_cuda and parts[2].is_cuda
    assert torch.equal(torch.cat([t.cpu() for t in parts]), ref.cpu())


@pytest.mark.parametrize("xs,ws,s,p,transposed,act,has_bias",
                         CASES[:5] + CASES[8:11] + TRAIN_CASES)
def test_cuda_backward_matches_plain_on_a_side_stream(
        dev, xs, ws, s, p, transposed, act, has_bias):
    """``backward()`` through the kernel, on a side stream with no
    explicit synchronize (autograd runs the backward on its own thread,
    where the launch must find the forward's stream), against the plain
    version's backward of the same forward output.  ``dx`` launches the
    kernel of the input's rank once.  The plain forward is held to the
    kernel's on its own: ReLU and LeakyReLU change slope at 0, so an
    output within a few ulps of 0 may take the other slope in an
    independent plain forward and move its cotangent by O(1)."""
    x, w, b = _inputs(xs, ws, dev, seed=7)
    nd = len(s)
    ep = tdf.Epilogue(bias=has_bias, activation=act)
    op = tdf.tconv if transposed else tdf.conv
    kernel, _ = _KERNELS[nd]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        xg, wg, bg = (t.clone().requires_grad_() for t in (x, w, b))
        before = kernel.launches
        y = op(xg, wg, s, p, bias=bg if has_bias else None, epilogue=ep)
        g = torch.randn(y.shape, device=dev,
                        generator=torch.Generator(dev).manual_seed(3))
        (y * g).sum().backward()
        assert kernel.launches - before == 2        # forward and dx
        y_plain = op(x, w, s, p, bias=b if has_bias else None,
                     epilogue=ep, backend="ganax-plain")
        torch.testing.assert_close(y.detach(), y_plain, **TOL)
        plain = tdf.BACKENDS["ganax-plain"]
        g_pre = g * ep.grad_from_output(y.detach())
        if transposed:
            dx = plain.conv(g_pre, w.transpose(-1, -2), s, p, tdf.Epilogue(),
                            None)
            dw = tdf._tconv_wgrad(x, g_pre, ws[:nd], s, p)
        else:
            dx = tdf._conv_dx(plain, s, p, x, w, g_pre)
            dw = tdf._conv_wgrad(x, g_pre, ws[:nd], s, p)
        assert kernel.launches - before == 2
        torch.testing.assert_close(xg.grad, dx, **TOL, msg="dx")
        torch.testing.assert_close(wg.grad, dw, **TOL, msg="dw")
        if has_bias:
            torch.testing.assert_close(
                bg.grad, g_pre.sum(dim=tuple(range(nd + 1))), **TOL,
                msg="db")


@pytest.mark.parametrize("model", ["dcgan", "3dgan"])
def test_cuda_train_step_matches_plain(dev, model):
    """One adversarial step at 1/32 width on the card: 40 launches of the
    model's kernel (D step: 4 + 5 + 5 forward, 4 + 4 dx; G step: 4 + 5
    forward, 5 + 4 dx), and the losses and parameters of the same step
    through ``ganax-plain``."""
    cfg = GanConfig(model, channel_scale=1 / 32)
    g, d = init_gan(cfg, torch.Generator().manual_seed(0), dev)
    batch = make_batch_fn(cfg, 2, dev)(0)
    kernel = ganax_conv_cuda if model == "dcgan" else ganax_conv3d_cuda
    states = {}
    for backend in (None, "ganax-plain"):
        step, (gen, disc) = make_gan_train_step(
            dataclasses.replace(cfg, backend=backend), 2,
            {k: v.clone() for k, v in g.items()},
            {k: v.clone() for k, v in d.items()}, g_lr=0.05, device=dev)
        before = ganax_conv_cuda.launches + ganax_conv3d_cuda.launches
        state, metrics = step((gen.params, disc.params), batch)
        launched = (ganax_conv_cuda.launches + ganax_conv3d_cuda.launches
                    - before)
        assert launched == (40 if backend is None else 0)
        states[backend] = (state, metrics)
    assert kernel.launches > 0
    (state, metrics), (ref_state, ref_metrics) = states.values()
    for k in metrics:
        torch.testing.assert_close(metrics[k], ref_metrics[k], **TOL)
    for ours, theirs in zip(state, ref_state):
        for k in theirs:
            torch.testing.assert_close(ours[k], theirs[k], **TOL, msg=k)


FLASH_TOL = {torch.float32: TOL,
             torch.bfloat16: dict(atol=1e-3, rtol=2 ** -6)}


def _flash_inputs(b, s, t, h, hd, dtype, dev, seed=9):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=gen).to(dev, dtype)
            for shape in ((b, s, h, hd), (b, t, h, hd), (b, t, h, hd))]


# (B, S, T, H, hd, causal): ragged S and T (not multiples of the 64-row
# q tile or the kv tile), causal and full, at hd 64 and Gemma's 256; then,
# for the wgmma kernel in bf16, Qwen's hd 128 and more of hd 256 with S
# and T not multiples of its 128-row q tile or its 64-row kv tile, kv
# tails shorter than one TMA box (T = 133, 197, 69), a kv length shorter
# than one box (T = 5), and S > T; then the same for its hd-64 instance
# (128-row kv tiles): S not a multiple of 128 with a kv tail of 44 rows,
# B = 2 full with a tail of 5, S > T with T shorter than one box, a kv
# length of 5, and Hymba-1.5B's longest served prompt (25 heads of 64);
# then its hd-80 instance (64-row kv tiles, two v panels the second of
# which holds 16 real columns), each with 4 or more heads so that a store
# past column 79 lands in the next head's columns: S not a multiple of 128
# full, a kv tail of 6 rows (T = 70) with S > T, T shorter than one box
# (T = 40), B = 2 causal and full with a tail of 5, and HuBERT-XLarge's
# longest utterance (16 heads of 80, full)
FLASH_CASES = [
    (1, 77, 77, 3, 64, True),
    (2, 45, 130, 2, 64, False),
    (1, 200, 150, 2, 64, True),
    (1, 100, 100, 2, 256, True),
    (2, 33, 70, 2, 256, False),
    (1, 130, 130, 1, 256, True),
    (1, 77, 77, 2, 128, True),
    (2, 150, 133, 2, 128, False),
    (1, 300, 300, 3, 128, True),
    (1, 133, 133, 2, 256, True),
    (2, 70, 197, 2, 256, False),
    (1, 300, 69, 2, 256, True),
    (2, 5, 5, 3, 256, True),
    (1, 300, 300, 3, 64, True),
    (2, 150, 133, 2, 64, False),
    (1, 200, 70, 2, 64, True),
    (2, 5, 5, 3, 64, True),
    (1, 3814, 3814, 25, 64, True),
    (1, 300, 300, 4, 80, False),
    (1, 130, 70, 5, 80, True),
    (1, 200, 40, 4, 80, False),
    (2, 150, 133, 4, 80, True),
    (2, 150, 133, 4, 80, False),
    (1, 1500, 1500, 16, 80, False),
]

_VARIANT_WRAPPERS = {"wgmma": flash_attention_wgmma,
                     "ffma": flash_attention_ffma}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("b,s,t,h,hd,causal", FLASH_CASES)
def test_flash_kernel_matches_plain(dev, b, s, t, h, hd, causal, dtype):
    q, k, v = _flash_inputs(b, s, t, h, hd, dtype, dev)
    before = flash_attention_cuda.launches
    by_variant = {n: w.launches for n, w in _VARIANT_WRAPPERS.items()}
    got = flash_attention_cuda(q, k, v, causal=causal)
    assert flash_attention_cuda.launches == before + 1
    variant = kernel_variant(dtype, hd)
    assert variant == ("wgmma" if dtype == torch.bfloat16 and hd >= 64
                       else "ffma")
    for n, w in _VARIANT_WRAPPERS.items():
        assert w.launches == by_variant[n] + (n == variant)
    ref = flash_attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    for head in range(h):
        torch.testing.assert_close(got[:, :, head].float(),
                                   ref[:, :, head].float(),
                                   **FLASH_TOL[dtype],
                                   msg=lambda m: f"head {head}: {m}")


def test_flash_kernel_on_a_side_stream_reads_strided_views(dev):
    """q, k and v as head-major tensors viewed as (B, S, H, hd), the
    launch on a side stream with no synchronize before it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        gen = torch.Generator(dev).manual_seed(2)
        q, k, v = (torch.randn((2, 4, 150, 64), device=dev, generator=gen,
                               dtype=torch.bfloat16).transpose(1, 2)
                   for _ in range(3))
        assert not q.is_contiguous()
        got = flash_attention_cuda(q, k, v, causal=True)
        ref = flash_attention_plain(q, k, v, causal=True)
    side.synchronize()
    torch.testing.assert_close(got.float(), ref.float(),
                               **FLASH_TOL[torch.bfloat16])


@pytest.mark.parametrize("hd", [128, 256])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_flash_wgmma_reads_head_major_views(dev, hd, causal):
    """The TMA path: q, k, v as head-major (B, H, S, hd) tensors viewed as
    (B, S, H, hd), ragged S and T, read by their strides with no copy."""
    gen = torch.Generator(dev).manual_seed(hd)
    q = torch.randn((2, 4, 333, hd), device=dev, generator=gen,
                    dtype=torch.bfloat16).transpose(1, 2)
    k, v = (torch.randn((2, 4, 197, hd), device=dev, generator=gen,
                        dtype=torch.bfloat16).transpose(1, 2)
            for _ in range(2))
    assert not q.is_contiguous() and q.stride(2) == 333 * hd
    before = flash_attention_wgmma.launches
    got = flash_attention_cuda(q, k, v, causal=causal)
    assert flash_attention_wgmma.launches == before + 1
    ref = flash_attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), ref.float(),
                               **FLASH_TOL[torch.bfloat16])


def _attention_f64(q, k, v):
    """Causal attention of the same (bf16) inputs in float64, not rounded:
    the exact value that both the kernel and its plain version round."""
    qd, kd, vd = q.double(), k.double(), v.double()
    sc = torch.einsum("bqhd,bkhd->bhqk", qd, kd) * q.shape[3] ** -0.5
    keep = torch.ones(q.shape[1], k.shape[1], dtype=torch.bool,
                      device=q.device).tril()
    sc = sc.masked_fill(~keep, float("-inf"))
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(sc, -1), vd)


@pytest.mark.parametrize("hd", [128, 256])
def test_flash_wgmma_is_as_exact_as_plain_at_large_scores(dev, hd):
    """q and k 16x, v 8x a unit normal: scores in the hundreds and outputs
    up to ~30, as a Gemma-7B layer's own q, k, v.  There a few outputs are
    ill-conditioned (near-tied p's of large, cancelling v's), and the
    plain version's f32 scores put them up to 2e-3 off the exact value,
    so the kernel cannot be held to two ulps of the plain version (on
    the card 2 of 358,400 outputs at hd 128 are not, and the exact value
    rounded to bf16 is not either at one).  It is held to the exact
    value instead: each output within FLASH_TOL of being as close to it
    as the plain version's, and no larger a mean error."""
    gen = torch.Generator().manual_seed(hd + 1)
    q, k, v = (torch.randn((1, 700, 4, hd), generator=gen) * scale
               for scale in (16, 16, 8))
    q, k, v = (a.to(dev, torch.bfloat16) for a in (q, k, v))
    got = flash_attention_cuda(q, k, v, causal=True).double()
    ref = flash_attention_plain(q, k, v, causal=True).double()
    exact = _attention_f64(q, k, v)
    err, ref_err = (got - exact).abs(), (ref - exact).abs()
    tol = FLASH_TOL[torch.bfloat16]
    assert bool((err <= ref_err + tol["atol"]
                 + tol["rtol"] * exact.abs()).all())
    assert err.mean().item() <= ref_err.mean().item() * (1 + 1e-2)


def test_flash_wgmma_refuses_strides_tma_cannot_read(dev):
    """A head stride of 260 bf16 (520 bytes, not a multiple of 16) and a
    start 8 bytes off a 16-byte boundary raise before any launch."""
    base = torch.zeros((1, 8, 2, 260), device=dev, dtype=torch.bfloat16)
    q = base[..., :256]
    k = torch.zeros((1, 8, 2, 256), device=dev, dtype=torch.bfloat16)
    flat = torch.zeros(8 * 2 * 256 + 4, device=dev, dtype=torch.bfloat16)
    shifted = flat[4:].view(1, 8, 2, 256)
    before = (flash_attention_cuda.launches, flash_attention_wgmma.launches)
    with pytest.raises(ValueError, match="q's head stride is 520 bytes"):
        flash_attention_cuda(q, k, k)
    with pytest.raises(ValueError, match="16-byte aligned address: v"):
        flash_attention_cuda(k, k, shifted)
    assert (flash_attention_cuda.launches,
            flash_attention_wgmma.launches) == before


def test_flash_wrapper_refuses_what_the_kernel_does_not_take(dev):
    q = torch.zeros((1, 8, 2, 48), device=dev)
    with pytest.raises(ValueError, match="head dims"):
        flash_attention_cuda(q, q, q)
    q = torch.zeros((1, 8, 2, 64), device=dev)
    with pytest.raises(ValueError, match="contiguous head dim"):
        flash_attention_cuda(q, q, q.transpose(1, 3).contiguous()
                             .transpose(1, 3))
    with pytest.raises(ValueError, match="CUDA device"):
        flash_attention_cuda(q, q.cpu(), q)


def test_engine_on_the_card_launches_the_flash_kernel(dev):
    """Tiny Gemma in f32: one kernel launch per layer per prefill, and
    the same greedy tokens as the engine with naive attention."""
    cfg = dataclasses.replace(reduced_config("gemma-7b", "tiny"),
                              dtype="float32")
    params = tr.init(cfg, torch.Generator(dev).manual_seed(0))
    prompts = [[int(t) for t in torch.randint(0, cfg.vocab, (n,),
                generator=torch.Generator().manual_seed(n))]
               for n in (70, 5, 131)]
    tokens = {}
    for impl in ("flash", "naive"):
        engine = DecodeEngine(cfg, params, EngineConfig(
            n_slots=2, max_len=160, max_new=5), tr.RunFlags(attn_impl=impl),
            device=dev)
        reqs = [Request(rid=i, prompt=p) for i, p in enumerate(prompts)]
        before = flash_attention_cuda.launches
        engine.run(reqs)
        launched = flash_attention_cuda.launches - before
        assert launched == (cfg.n_layers * len(prompts)
                            if impl == "flash" else 0)
        tokens[impl] = [r.generated for r in reqs]
    assert tokens["flash"] == tokens["naive"]


# In f32 both sides sit at f32's rounding floor (a few ulps of 2^-24),
# where their ratio is noise: on an H100 the FFMA case's dv read 5.4e-7
# against the plain version's 2.6e-7.  1e-6 is about eight f32 ulps.
F32_FLOOR = 1e-6


def _attention_grads(fn, q, k, v, do, dtype=None):
    ins = [t.detach().to(dtype or t.dtype).requires_grad_() for t in (q, k, v)]
    out = fn(*ins)
    return torch.autograd.grad(out, ins, do.to(out.dtype))


@pytest.mark.parametrize("dtype,hd,s", [(torch.bfloat16, 256, 2048),
                                        (torch.float32, 64, 512)],
                         ids=["wgmma", "ffma"])
def test_flash_function_gradients_on_the_card(dev, dtype, hd, s):
    """The differentiable flash attention on the card (the forward through
    the kernel, the backward a plain recompute) against float64
    attention's gradients: dq, dk, dv each at most twice the gap of
    autograd through the kernel's plain version (the yardstick; the
    recompute rounds p to v's dtype for p·v as the reference does, the
    plain version keeps it f32: 1.43x its gap in bf16 on the CPU), plus
    ``F32_FLOOR``."""
    from repro_torch.kernels.flash_attention import FlashAttentionFn
    gen = torch.Generator().manual_seed(3)
    q, k, v, do = (torch.randn((1, s, 2, hd), generator=gen).to(dev, dtype)
                   for _ in range(4))
    exact = _attention_grads(lambda a, b, c: _attention_f64(a, b, c), q, k, v,
                             do, torch.float64)
    before = (flash_attention_cuda.launches,
              _VARIANT_WRAPPERS[kernel_variant(dtype, hd)].launches)
    got = _attention_grads(lambda a, b, c: FlashAttentionFn.apply(
        a, b, c, True, flash_attention_cuda), q, k, v, do)
    assert (flash_attention_cuda.launches,
            _VARIANT_WRAPPERS[kernel_variant(dtype, hd)].launches) == \
        (before[0] + 1, before[1] + 1)
    plain = _attention_grads(flash_attention_plain, q, k, v, do)
    for name, g, p, e in zip("qkv", got, plain, exact):
        assert g.dtype == dtype and bool(torch.isfinite(g).all())
        gap = float((g.double() - e).norm() / e.norm())
        yardstick = float((p.double() - e).norm() / e.norm())
        assert gap <= 2 * yardstick + F32_FLOOR, (name, gap, yardstick)


def test_gemma_train_step_on_the_card_launches_only_flash(dev):
    """Two full-width Gemma-7B layers (f32 masters, bf16 compute, remat):
    one step of 1x512 tokens launches the wgmma kernel twice a layer
    (the forward and its recompute) and nothing else, with a finite
    loss, and updates the state in place."""
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import SyntheticLM, make_batch_fn
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_state import (init_train_state,
                                               make_train_step)
    cfg = dataclasses.replace(get_config("gemma-7b"), n_layers=2)
    state = init_train_state(cfg, torch.Generator(dev).manual_seed(0))
    step = make_train_step(cfg, AdamWConfig(warmup_steps=1),
                           tr.RunFlags(attn_impl="flash", remat=True))
    batch = make_batch_fn(SyntheticLM(cfg, 1, 512), device=dev)(0)
    wrappers = (flash_attention_cuda, flash_attention_wgmma,
                flash_attention_ffma, ganax_conv_cuda, ganax_conv3d_cuda)
    before = [w.launches for w in wrappers]
    embed = state["params"]["embed"]
    out, m = step(state, batch)
    torch.cuda.synchronize()
    assert [w.launches - b for w, b in zip(wrappers, before)] == \
        [4, 4, 0, 0, 0]
    assert out is state and out["params"]["embed"] is embed
    assert int(state["step"]) == 1 and bool(torch.isfinite(m["loss"]))
    del state, out
    torch.cuda.empty_cache()


def test_train_loop_keeps_its_replay_copy_in_pinned_host_memory(dev,
                                                                  tmp_path):
    """A loop over a state on the card holds its step-0 copy in pinned
    host memory: no second copy of the state on the device."""
    from repro_torch.train.loop import LoopConfig, TrainLoop
    state = {"w": torch.ones((1024, 1024), device=dev)}

    def step(st, batch):
        st["w"].add_(1.0)
        return st, {"loss": st["w"].sum()}
    loop = TrainLoop(LoopConfig(total_steps=2, ckpt_dir=str(tmp_path),
                                ckpt_every=100, log_every=100),
                     step, lambda i: {}, state, log_fn=lambda s: None)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    loop.run()
    added = torch.cuda.max_memory_allocated(dev) - base
    copy = loop._initial_state["w"]
    assert copy.device.type == "cpu" and copy.is_pinned()
    assert bool((copy == 1).all()) and bool((state["w"] == 3).all())
    # the step's scalar sums are all the run adds on the card (a device
    # copy of the state would be 4 MiB)
    assert added < 1 << 20, added


# The tuner's candidate routes (repro_torch.tune.candidates) on the card:
# (x shape, w shape, strides, paddings, transposed) with several tc tile
# widths and splits, a flattened K, narrow splits, 2-D and 3-D
TUNE_CASES = [
    ((8, 8, 8, 256), (4, 4, 256, 128), (2, 2), (1, 1), True),
    ((4, 32, 32, 3), (4, 4, 3, 72), (2, 2), (1, 1), False),
    ((8, 4, 4, 512), (4, 4, 512, 1), (1, 1), (0, 0), False),
    ((8, 16, 16, 128), (4, 4, 128, 3), (2, 2), (1, 1), True),
    ((2, 4, 4, 4, 256), (4, 4, 4, 256, 128), (2, 2, 2), (1, 1, 1), True),
    ((2, 8, 8, 8, 64), (4, 4, 4, 64, 1), (2, 2, 2), (1, 1, 1), True),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("xs,ws,s,p,transposed", TUNE_CASES)
def test_every_candidate_route_matches_plain(dev, xs, ws, s, p, transposed,
                                             dtype):
    """Each ganax candidate the tuner enumerates for the geometry runs on
    its route (counted under it) and agrees with the plain version: at
    1e-4 in f32, two storage ulps in bf16."""
    from repro_torch.tune import PlanKey, enumerate_candidates
    key = PlanKey("tconv" if transposed else "conv", xs[0], xs[1:-1],
                  ws[:-2], s, p, ws[-2], ws[-1],
                  dtype=str(dtype).removeprefix("torch."),
                  platform="sm_90")
    routes = [c.route for c in enumerate_candidates(key)
              if c.backend == "ganax"]
    assert routes
    x, w, b = _inputs(xs, ws, dev, seed=12)
    w = w * (0.3 * np.prod(ws[:-1])) ** -0.5
    operands = ops.kernel_operands(x.to(dtype), w.to(dtype), s, p,
                                   transposed=transposed)
    kernel, plain = _KERNELS[len(s)]
    ref = plain(**operands, bias=b, activation="relu")
    tol = TOL if dtype == torch.float32 else TWO_ULPS[dtype]
    for route in routes:
        before = kernel.launches_by_route[route.name]
        got = kernel(**operands, bias=b, activation="relu", route=route)
        torch.cuda.synchronize()
        assert kernel.launches_by_route[route.name] == before + 1
        torch.testing.assert_close(got.float(), ref.float(), **tol,
                                   msg=route.describe())


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("model", ["dcgan", "3dgan"])
def test_low_precision_train_step_on_the_card(dev, model, dtype):
    """One mixed-precision step at 1/32 width: 40 launches, all of the
    storage dtype's instance; parameters stay f32; and the step's
    updates, against the f32 step through ganax-plain, are as accurate
    as the same step's through ganax-plain at that dtype (over the whole
    tree, within 5%: ``chip_smoke.py``'s gradient gate).  The kernel and
    the plain version round the same f32 sums once, but not elementwise:
    at f16 the generator's cotangents reach f16's subnormals (the
    reference scales no loss either), where one flipped last bit moves a
    small tensor's update by percents."""
    cfg = GanConfig(model, channel_scale=1 / 32)
    g, d = init_gan(cfg, torch.Generator().manual_seed(0), dev)
    batch = make_batch_fn(cfg, 2, dev)(0)
    kernel = ganax_conv_cuda if model == "dcgan" else ganax_conv3d_cuda
    updates = {}
    for backend, dt in ((None, dtype), ("ganax-plain", dtype),
                        ("ganax-plain", "float32")):
        step, (gen, disc) = make_gan_train_step(
            dataclasses.replace(cfg, backend=backend, dtype=dt), 2,
            {k: v.clone() for k, v in g.items()},
            {k: v.clone() for k, v in d.items()}, g_lr=0.05, device=dev)
        before = kernel.launches_by_dtype[dtype]
        state, metrics = step((gen.params, disc.params), batch)
        torch.cuda.synchronize()
        assert kernel.launches_by_dtype[dtype] - before == \
            (40 if backend is None else 0)
        assert all(bool(torch.isfinite(metrics[k])) for k in metrics)
        assert all(v.dtype == torch.float32 for part in state
                   for v in part.values())
        updates[backend, dt] = {k: v.detach() - ref[k] for part, ref in
                                zip(state, (g, d)) for k, v in part.items()}
    ours, plain, f32 = updates.values()

    def dist(u):
        return sum(float((u[k] - f32[k]).square().sum()) for k in f32) ** 0.5
    assert dist(ours) <= 1.05 * dist(plain), (dist(ours), dist(plain))


def test_tuned_program_on_the_card(dev, tmp_path):
    """Tune a 1/16-width DCGAN generator's plans on the card: no failed
    candidate, every layer on the kernel, a second planner on the plan file measures nothing, and
    the auto program serves the heuristic program's images at 1e-4."""
    from repro_torch.program import Program
    from repro_torch.tune import Planner
    cfg = GanConfig("dcgan", channel_scale=1 / 16)
    planner = Planner(tmp_path / "plans.json", repeats=2)
    auto = Program.build(cfg, 8, policy=tdf.DataflowPolicy("auto"),
                         planner=planner, measure=True, device=dev,
                         differentiable=False)
    assert planner.failures == 0 and planner.measurements > 0
    assert all(le.source == "tuned" and le.backend == "ganax"
               for le in auto.spec.layers)
    warm = Planner(tmp_path / "plans.json")
    again = Program.build(cfg, 8, policy=tdf.DataflowPolicy("auto"),
                          planner=warm, measure=True, device=dev,
                          differentiable=False)
    assert warm.measurements == 0 and again.spec == auto.spec
    heuristic = Program.build(cfg, 8, device=dev, differentiable=False)
    g, _ = init_gan(cfg, torch.Generator().manual_seed(0), dev)
    z = torch.randn((8, cfg.z_dim), device=dev)
    torch.testing.assert_close(auto.apply(g, z), heuristic.apply(g, z),
                               **TOL)


def test_cout_sharded_forward_on_two_gloo_ranks_sharing_the_card(dev,
                                                                 tmp_path):
    """The full-width DCGAN generator at mesh (1, 2) on two gloo ranks
    that share the card: each rank's output equals the one-device
    program's at 1e-4, and each launched g1 (Cout 512, ``"cout"`` under
    the default threshold) on its 256-channel slice only."""
    from repro_torch.launch.mesh import spawn
    from repro_torch.program import Program
    from repro_torch.sharding import parity
    from repro_torch.kernels import build
    build.build(("ganax_conv",))     # the ranks load it, never compile
    cfg = GanConfig("dcgan")
    g, _ = init_gan(cfg, torch.Generator().manual_seed(0), "cpu")
    z = torch.randn((16, cfg.z_dim), generator=torch.Generator()
                    .manual_seed(1))
    cases = [dict(name="fwd", kind="forward", model="dcgan", mesh=(1, 2),
                  batch=16, params=g, x=z)]
    torch.save(cases, tmp_path / "cases.pt")
    spawn(parity.run, 2, str(tmp_path / "cases.pt"), str(tmp_path), "cuda",
          backend="gloo", device="cuda")
    ref = Program.build(cfg, 16, device=dev, differentiable=False,
                        mesh=None).apply({k: v.to(dev) for k, v in g.items()},
                                         z.to(dev))
    for r in range(2):
        res = torch.load(tmp_path / f"rank{r}.pt", weights_only=True)["fwd"]
        assert res["shardings"][0] == "cout" and res["mesh"] == "1x2"
        torch.testing.assert_close(res["out"].to(dev), ref, **TOL)
        couts = res["launches"]["ganax_conv"]["cout"]
        assert 512 not in couts and couts[256] == 2, couts   # g1 and g2


# -- the soft-cap, sliding-window attention and Gemma3 on the card ---------

# (dtype, B, S, T, H, hd, causal, q/k scale, soft-cap): both kernels,
# each at a cap that bites (scale 1 at cap 1; scores of std 100 at 5)
SOFTCAP_CASES = [
    (torch.bfloat16, 1, 1000, 1000, 8, 256, True, 1.0, 1.0),
    (torch.bfloat16, 1, 1000, 1000, 8, 256, True, 10.0, 5.0),
    (torch.bfloat16, 2, 150, 133, 2, 128, False, 1.0, 1.0),
    (torch.float32, 1, 300, 300, 4, 256, True, 1.0, 1.0),
    (torch.float32, 1, 300, 300, 4, 256, True, 10.0, 5.0),
    (torch.bfloat16, 2, 150, 97, 3, 64, True, 1.0, 1.0),
]


@pytest.mark.parametrize("dtype,b,s,t,h,hd,causal,scale,cap",
                         SOFTCAP_CASES)
def test_flash_soft_cap_kernels_match_plain(dev, dtype, b, s, t, h, hd,
                                            causal, scale, cap):
    """The soft-cap instance of the kernel the wrapper picks against its
    plain version at the same cap, within FLASH_TOL; the kernel without
    the cap fails that gate (the cap bites)."""
    q, k, v = _flash_inputs(b, s, t, h, hd, dtype, dev, seed=s + hd)
    q, k = q * scale, k * scale
    variant = kernel_variant(dtype, hd)
    before = _VARIANT_WRAPPERS[variant].launches
    got = flash_attention_cuda(q, k, v, causal=causal, softcap=cap)
    assert _VARIANT_WRAPPERS[variant].launches == before + 1
    ref = flash_attention_plain(q, k, v, causal=causal, softcap=cap)
    torch.testing.assert_close(got.float(), ref.float(), **FLASH_TOL[dtype])
    uncapped = flash_attention_cuda(q, k, v, causal=causal)
    assert not torch.allclose(uncapped.float(), ref.float(),
                              **FLASH_TOL[dtype])


@pytest.mark.parametrize("dtype,hd", [(torch.bfloat16, 256),
                                      (torch.float32, 64)],
                         ids=["wgmma", "ffma"])
def test_flash_function_soft_cap_gradients_on_the_card(dev, dtype, hd):
    """``FlashAttentionFn`` at a soft-cap of 1 on the card (the forward
    through the kernel's soft-cap instance, the backward a recompute
    through the ``tanh``) against float64 autograd of soft-capped
    attention: dq, dk, dv each at most twice the gap of autograd through
    the plain version, plus ``F32_FLOOR``."""
    from repro_torch.kernels.flash_attention import FlashAttentionFn

    def capped_f64(a, b, c):
        sc = torch.einsum("bqhd,bkhd->bhqk", a, b) * a.shape[3] ** -0.5
        sc = torch.tanh(sc)
        keep = torch.ones(a.shape[1], b.shape[1], dtype=torch.bool,
                          device=a.device).tril()
        sc = sc.masked_fill(~keep, float("-inf"))
        return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(sc, -1), c)
    gen = torch.Generator().manual_seed(4)
    q, k, v, do = (torch.randn((1, 512, 2, hd), generator=gen).to(dev, dtype)
                   for _ in range(4))
    exact = _attention_grads(capped_f64, q, k, v, do, torch.float64)
    before = _VARIANT_WRAPPERS[kernel_variant(dtype, hd)].launches
    got = _attention_grads(lambda a, b, c: FlashAttentionFn.apply(
        a, b, c, True, flash_attention_cuda, 1.0), q, k, v, do)
    assert _VARIANT_WRAPPERS[kernel_variant(dtype, hd)].launches == \
        before + 1
    plain = _attention_grads(lambda a, b, c: flash_attention_plain(
        a, b, c, softcap=1.0), q, k, v, do)
    for name, g, p, e in zip("qkv", got, plain, exact):
        assert g.dtype == dtype and bool(torch.isfinite(g).all())
        gap = float((g.double() - e).norm() / e.norm())
        yardstick = float((p.double() - e).norm() / e.norm())
        assert gap <= 2 * yardstick + F32_FLOOR, (name, gap, yardstick)


def _flash_bits_tool():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parent.parent / "tools" / "flash_bits.py"
    spec = importlib.util.spec_from_file_location("flash_bits", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# SHA-256 of each output of tools/flash_bits.py's CASES through the
# kernels as they were before the soft-cap existed: the commit before
# it, run by that script on an NVIDIA H100 80GB HBM3 (700 W; torch
# 2.11.0, CUDA 12.8), beside this tree, which printed the same six
PRE_SOFTCAP_DIGESTS = {
    "wgmma hd256 causal":
        "187c618c2f7517f50ccc00a28a47dc6a542f3d07c1947ff0d1951f7626dec736",
    "wgmma hd128 full ragged":
        "6c79fc54971ea22774ec04f013e00047970b80cbb895dc604b8409892aec1d05",
    "wgmma hd256 big scores":
        "023fc03f5fa9a95096fed9b147d172c6119856373df5eef32f8bbda09246eb66",
    "ffma f32 hd256 causal":
        "06a38274b14a4f48a58902c0607245bf969ae01500da22e8c212295b29f01dcc",
    "ffma bf16 hd64 full ragged":
        "c21f3c61fd9c84cab0ecec5b95848896a2573a023e1fa7f7210eb71fe796bdf1",
    "ffma f32 hd32 causal":
        "4a8939ed1e97a84c24644f391f62145f365ac58803125a2df7fde4b85328491b",
}


def test_flash_kernels_at_soft_cap_0_keep_their_bits(dev):
    """With the soft-cap a template flag, the instances at 0 are the
    code that was there before: their outputs equal, bit for bit, the
    ones the kernels gave before the change (tools/flash_bits.py), on
    the cases the script had then (the FFMA bf16 hd-64 one through
    ``flash_attention_ffma``, as the variant table then sent it there;
    the wgmma hd-64 case, added with that instance, is not pinned)."""
    got = _flash_bits_tool().digests(dev)
    assert {k: got[k] for k in PRE_SOFTCAP_DIGESTS} == PRE_SOFTCAP_DIGESTS
    assert not got["wgmma hd64"].startswith("refused")
    assert not got["wgmma hd80"].startswith("refused")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_swa_attention_on_the_card_matches_the_cpu(dev, dtype):
    """The plain sliding-window attention (block-local, w 128, 4 q heads
    over 2 kv heads of 256, 1000 tokens: a padded tail) on the card
    against the same function on the CPU: f32 within 2e-5, bf16 within
    2^-8 of the output's norm (p is rounded to bf16 on each side after
    a softmax summed in another order)."""
    from repro_torch.models.attention import swa_attention
    gen = torch.Generator().manual_seed(6)
    q = torch.randn((1, 1000, 4, 256), generator=gen).to(dtype)
    k, v = (torch.randn((1, 1000, 2, 256), generator=gen).to(dtype)
            for _ in range(2))
    pos = torch.arange(1000)[None]
    ref = swa_attention(q, k, v, pos, pos, window=128)
    got = swa_attention(q.to(dev), k.to(dev), v.to(dev), pos.to(dev),
                        pos.to(dev), window=128).cpu()
    assert got.dtype == dtype
    if dtype == torch.float32:
        torch.testing.assert_close(got, ref, atol=2e-5, rtol=2e-5)
    else:
        rel = float((got.float() - ref.float()).norm() / ref.float().norm())
        assert rel <= 2 ** -8, rel


def test_gemma3_engine_on_the_card_launches_flash_on_global_layers(dev):
    """Tiny Gemma3 in f32 (6 layers under its (5, 1) pattern: one
    global): one kernel launch per global layer per prefill, none for
    the local ones, and the same greedy tokens as the naive engine."""
    cfg = dataclasses.replace(reduced_config("gemma3-4b", "tiny"),
                              n_layers=6, dtype="float32")
    params = tr.init(cfg, torch.Generator(dev).manual_seed(0))
    prompts = [[int(t) for t in torch.randint(0, cfg.vocab, (n,),
                generator=torch.Generator().manual_seed(n))]
               for n in (70, 300, 131)]
    tokens = {}
    for impl in ("flash", "naive"):
        engine = DecodeEngine(cfg, params, EngineConfig(
            n_slots=2, max_len=320, max_new=5), tr.RunFlags(attn_impl=impl),
            device=dev)
        reqs = [Request(rid=i, prompt=p) for i, p in enumerate(prompts)]
        before = flash_attention_cuda.launches
        engine.run(reqs)
        launched = flash_attention_cuda.launches - before
        assert launched == (len(prompts) if impl == "flash" else 0)
        tokens[impl] = [r.generated for r in reqs]
    assert tokens["flash"] == tokens["naive"]


# -- the split head dims of MLA, and MiniCPM3 on the card -------------------

# (B, S, T, H, causal, soft-cap): ragged S and T against the kv tiles
# (64 rows at (48, 32), 128 for the wgmma instance at bf16 (96, 64), 32
# for the FFMA kernel's (96, 64)) and the q tiles (64 rows, 128 for the
# wgmma instance), causal and full, with the soft-cap off and at a cap
# that bites
SPLIT_CASES = [
    (1, 77, 77, 3, True, 0.0),
    (2, 45, 130, 2, False, 0.0),
    (1, 200, 150, 2, True, 0.0),
    (2, 133, 97, 2, False, 1.0),
    (1, 300, 300, 4, True, 1.0),
]


def _split_inputs(b, s, t, h, dk, dv, dtype, dev, seed=11):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=gen).to(dev, dtype)
            for shape in ((b, s, h, dk), (b, t, h, dk), (b, t, h, dv))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("dk,dv", [(96, 64), (48, 32)])
@pytest.mark.parametrize("b,s,t,h,causal,cap", SPLIT_CASES)
def test_flash_split_head_dims_match_plain(dev, b, s, t, h, causal, cap, dk,
                                           dv, dtype):
    """The split instances (q, k of ``dk``, v of ``dv``: the wgmma
    kernel's at bf16 (96, 64), the FFMA kernel's elsewhere) against their
    plain version within FLASH_TOL, output ``(B, S, H, dv)``, one launch
    counted on the kernel that ``kernel_variant`` names and on its
    geometry, none on the other; the kernel scaled by ``dv**-0.5`` in
    place of ``dk**-0.5`` (q scaled by ``(dk / dv)**0.5``) fails that
    gate."""
    q, k, v = _split_inputs(b, s, t, h, dk, dv, dtype, dev, seed=s + dk)
    variant = kernel_variant(dtype, dk, dv)
    by_geometry = (flash_attention_wgmma if variant == "wgmma"
                   else flash_attention_ffma).launches_by_geometry

    def counts():
        return (flash_attention_ffma.launches, flash_attention_wgmma.launches,
                by_geometry.get((dtype, dk, dv), 0))
    before = counts()
    got = flash_attention_cuda(q, k, v, causal=causal, softcap=cap)
    assert counts() == (before[0] + (variant == "ffma"),
                        before[1] + (variant == "wgmma"), before[2] + 1)
    ref = flash_attention_plain(q, k, v, causal=causal, softcap=cap)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (b, s, h, dv)
    torch.testing.assert_close(got.float(), ref.float(), **FLASH_TOL[dtype])
    wrong = flash_attention_cuda(q * (dk / dv) ** 0.5, k, v, causal=causal,
                                 softcap=cap)
    assert not torch.allclose(wrong.float(), ref.float(), **FLASH_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_function_gradients_at_split_head_dims(dev, dtype):
    """``FlashAttentionFn`` at (96, 64) on the card (the forward through
    the split instance: the wgmma kernel's in bf16, the FFMA kernel's in
    f32; the backward a recompute) against float64 attention's
    gradients: dq, dk, dv each at most twice the gap of autograd through
    the plain version, plus ``F32_FLOOR``."""
    from repro_torch.kernels.flash_attention import FlashAttentionFn

    def f64(a, b, c):
        sc = torch.einsum("bqhd,bkhd->bhqk", a, b) * a.shape[3] ** -0.5
        keep = torch.ones(a.shape[1], b.shape[1], dtype=torch.bool,
                          device=a.device).tril()
        sc = sc.masked_fill(~keep, float("-inf"))
        return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(sc, -1), c)
    q, k, v = _split_inputs(1, 512, 512, 4, 96, 64, dtype, dev)
    do = torch.randn((1, 512, 4, 64), generator=torch.Generator()
                     .manual_seed(3)).to(dev, dtype)
    exact = _attention_grads(f64, q, k, v, do, torch.float64)
    launcher = (flash_attention_wgmma if kernel_variant(dtype, 96, 64)
                == "wgmma" else flash_attention_ffma)
    before = launcher.launches_by_geometry.get((dtype, 96, 64), 0)
    got = _attention_grads(lambda a, b, c: FlashAttentionFn.apply(
        a, b, c, True, flash_attention_cuda), q, k, v, do)
    assert launcher.launches_by_geometry[(dtype, 96, 64)] == before + 1
    plain = _attention_grads(lambda a, b, c: flash_attention_plain(a, b, c),
                             q, k, v, do)
    for name, g, p, e in zip("qkv", got, plain, exact):
        assert g.shape == e.shape and bool(torch.isfinite(g).all())
        gap = float((g.double() - e).norm() / e.norm())
        yardstick = float((p.double() - e).norm() / e.norm())
        assert gap <= 2 * yardstick + F32_FLOOR, (name, gap, yardstick)


@pytest.mark.parametrize("b,s,h", [(1, 1000, 40), (2, 333, 3)])
def test_flash_wgmma_split_instance_reads_mla_views(dev, b, s, h):
    """The wgmma (96, 64) instance on q and k from ``torch.cat`` and v =
    ``kv[..., 64:]`` of an expanded (B, S, H, 128) kv, as ``mla_apply``
    makes them: v is a view into kv's storage, read without a copy (the
    call allocates its output and nothing more) and one launch counted
    at (bf16, 96, 64); the output matches the plain version within
    FLASH_TOL."""
    gen = torch.Generator().manual_seed(s)

    def rand(*shape):
        return torch.randn(shape, generator=gen).to(dev, torch.bfloat16)
    kv = rand(b, s, h, 128)
    q = torch.cat([rand(b, s, h, 64), rand(b, s, h, 32)], dim=-1)
    k = torch.cat([kv[..., :64], rand(b, s, 1, 32).expand(b, s, h, 32)],
                  dim=-1)
    v = kv[..., 64:]
    assert not v.is_contiguous() and v.stride(2) == 128
    assert v.untyped_storage().data_ptr() == kv.untyped_storage().data_ptr()
    geometry = (torch.bfloat16, 96, 64)
    before = flash_attention_wgmma.launches_by_geometry.get(geometry, 0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    got = flash_attention_cuda(q, k, v)
    torch.cuda.synchronize()
    grew = torch.cuda.max_memory_allocated(dev) - base
    out_bytes = got.numel() * got.element_size()
    assert flash_attention_wgmma.launches_by_geometry[geometry] == before + 1
    assert grew < out_bytes + v.numel() * v.element_size(), (grew, out_bytes)
    ref = flash_attention_plain(q, k, v)
    torch.cuda.synchronize()
    assert got.shape == (b, s, h, 64)
    torch.testing.assert_close(got.float(), ref.float(),
                               **FLASH_TOL[torch.bfloat16])


@pytest.mark.parametrize("b,s,t,h,causal,cap", SPLIT_CASES)
def test_flash_ffma_bf16_split_instance_called_directly_matches_plain(
        dev, b, s, t, h, causal, cap):
    """The FFMA kernel's bf16 (96, 64) instance, which the variant table
    no longer routes to but ``flash_attention_ffma`` launches when called
    directly (the yardstick of the wgmma instance): within FLASH_TOL of
    the plain version, one launch counted on its geometry, none on the
    wgmma kernel."""
    q, k, v = _split_inputs(b, s, t, h, 96, 64, torch.bfloat16, dev,
                            seed=s + 7)
    geometry = (torch.bfloat16, 96, 64)
    by_geometry = flash_attention_ffma.launches_by_geometry

    def counts():
        return flash_attention_wgmma.launches, by_geometry.get(geometry, 0)
    before = counts()
    got = flash_attention_ffma(q, k, v, causal=causal, softcap=cap)
    assert counts() == (before[0], before[1] + 1)
    ref = flash_attention_plain(q, k, v, causal=causal, softcap=cap)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == (b, s, h, 64)
    torch.testing.assert_close(got.float(), ref.float(),
                               **FLASH_TOL[torch.bfloat16])


@pytest.mark.parametrize("b,s,t,h,causal,cap", [
    (1, 77, 77, 3, True, 0.0),
    (2, 150, 133, 2, False, 0.0),
    (1, 200, 70, 2, True, 1.0),
    (1, 3814, 3814, 25, True, 0.0),
])
def test_flash_ffma_bf16_hd64_instance_called_directly_matches_plain(
        dev, b, s, t, h, causal, cap):
    """The FFMA kernel's bf16 hd-64 instance, which the variant table no
    longer routes to but ``flash_attention_ffma`` launches when called
    directly (the yardstick of the wgmma hd-64 instance): within
    FLASH_TOL of the plain version, one launch counted on its geometry,
    none on the wgmma kernel."""
    q, k, v = _flash_inputs(b, s, t, h, 64, torch.bfloat16, dev, seed=s + 5)
    geometry = (torch.bfloat16, 64, 64)
    by_geometry = flash_attention_ffma.launches_by_geometry

    def counts():
        return flash_attention_wgmma.launches, by_geometry.get(geometry, 0)
    before = counts()
    got = flash_attention_ffma(q, k, v, causal=causal, softcap=cap)
    assert counts() == (before[0], before[1] + 1)
    ref = flash_attention_plain(q, k, v, causal=causal, softcap=cap)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == (b, s, h, 64)
    torch.testing.assert_close(got.float(), ref.float(),
                               **FLASH_TOL[torch.bfloat16])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("b,s,t,h,causal", [
    (1, 300, 300, 4, False),
    (2, 150, 133, 4, True),
    (1, 2048, 2048, 16, False),
])
def test_flash_ffma_hd80_instances_called_directly_match_plain(
        dev, b, s, t, h, causal, dtype):
    """The FFMA kernel's hd-80 instances called through
    ``flash_attention_ffma``: f32, the kernel of the f32 checks (which
    the variant table sends there too), and bf16, the yardstick of the
    wgmma hd-80 instance (the table sends bf16 hd 80 to the wgmma
    kernel): within FLASH_TOL of the plain version on every head, one
    launch counted on the geometry, none on the wgmma kernel."""
    q, k, v = _flash_inputs(b, s, t, h, 80, dtype, dev, seed=s + 80)
    geometry = (dtype, 80, 80)
    by_geometry = flash_attention_ffma.launches_by_geometry

    def counts():
        return flash_attention_wgmma.launches, by_geometry.get(geometry, 0)
    before = counts()
    got = flash_attention_ffma(q, k, v, causal=causal)
    assert counts() == (before[0], before[1] + 1)
    ref = flash_attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (b, s, h, 80)
    for head in range(h):
        torch.testing.assert_close(got[:, :, head].float(),
                                   ref[:, :, head].float(),
                                   **FLASH_TOL[dtype],
                                   msg=lambda m: f"head {head}: {m}")


def test_minicpm3_engine_on_the_card_launches_the_split_instance(dev):
    """Tiny MiniCPM3 in f32 (2 MLA layers, q·k 48 against v 32): one
    launch of the (48, 32) instance per layer per prefill, and the same
    greedy tokens as the naive engine (the absorbed decode on both)."""
    cfg = dataclasses.replace(reduced_config("minicpm3-4b", "tiny"),
                              dtype="float32")
    params = tr.init(cfg, torch.Generator(dev).manual_seed(0))
    prompts = [[int(t) for t in torch.randint(0, cfg.vocab, (n,),
                generator=torch.Generator().manual_seed(n))]
               for n in (70, 300, 131)]
    geometry = (torch.float32, 48, 32)
    tokens = {}
    for impl in ("flash", "naive"):
        engine = DecodeEngine(cfg, params, EngineConfig(
            n_slots=2, max_len=320, max_new=5), tr.RunFlags(attn_impl=impl),
            device=dev)
        reqs = [Request(rid=i, prompt=p) for i, p in enumerate(prompts)]
        before = flash_attention_ffma.launches_by_geometry.get(geometry, 0)
        engine.run(reqs)
        launched = flash_attention_ffma.launches_by_geometry.get(
            geometry, 0) - before
        assert launched == (cfg.n_layers * len(prompts) if impl == "flash"
                            else 0)
        tokens[impl] = [r.generated for r in reqs]
    assert tokens["flash"] == tokens["naive"]
