"""The port's quantization (``repro_torch.quant``) and its bf16/f16 storage
against the reference's (``repro.quant``), on the CPU.

Each test feeds the same numpy inputs, made from a seed, to both
packages.

* (a) ``precision`` and ``tolerance`` equal the reference's: aliases, the
  error cases, both gate tables.
* (b) ``quantize_params`` writes the reference's JSON bit for bit for
  every Table-I model's parameters, and ``dequantize_params`` gives the
  reference's bits at f32, bf16 and f16; v3 files cross between the
  packages in both directions.
* (c) The op sweep of the reference's ``tests/test_quant.py`` (kind ×
  rank × stride 1-3) through the port's kernel route (its plain version
  on the CPU) at bf16/f16: against the reference's ``pallas-interpret``
  at two storage ulps, and against the port's own f32 under
  ``op_tolerance(dtype, "fwd")``.
* (d) All six generators at the calibration configuration
  (``channel_scale=0.0625``, batch 2), bf16 and f16, within
  ``model_tolerance(name, dtype)["output_atol"]`` of the port's f32
  output and of the reference's same-dtype output; int8 programs the same
  way under the ``"int8"`` gate.
* (e) ``tc_route_emulation`` at bf16/f16 (one product a stage, 64 K a
  fresh sum, the flattened K for Cin % 8 != 0, split-K) against the
  plain version, and the routes and tc weights of the 2-byte instances.
* (f) ``GanServer`` / ``GanEngine`` with ``g_params=None`` adopt a
  quantized program's dtype and raise ``ValueError`` without one; the
  discriminator's logits stay f32; the backward of a bf16 forward
  reaches the f32 parameters (ROADMAP item 9b, mixed-precision training;
  its parity tests are in ``tests/test_torch_mixed_train.py``).

Two storage ulps: |a - b| <= atol + rtol |b| with rtol 2^-6 (bf16) or
2^-9 (f16), twice the ulp of the bottom of a binade, and atol 1e-3 for
outputs near 0 (the GPU gate of ``chip_smoke.py``'s quant phase).  Two
f32 sums of the same exact products, rounded once each, differ by at
most one ulp; a sum kept in the storage dtype does not
(``test_storage_dtype_sums_fail_the_two_ulp_gate``).
"""

import dataclasses
import functools
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.dataflow import DataflowPolicy as JPolicy
from repro.core.dataflow import conv as jconv
from repro.core.dataflow import tconv as jtconv
from repro.models import gan as jgan
from repro.program import Program as JProgram
from repro.program import ProgramSpec as JSpec
from repro.quant import precision as jprecision
from repro.quant import tolerance as jtolerance
from repro.quant import weights as jweights
from repro_torch import quant
from repro_torch.convert import params_from_jax
from repro_torch.core import dataflow as tdf
from repro_torch.kernels import ops
from repro_torch.kernels.ganax_conv import (apply_epilogue_to_acc,
                                            flat_k_needed, ganax_conv3d_plain,
                                            ganax_conv_plain, kernel_route,
                                            plain_sums, tc_block_k,
                                            tc_route_emulation, tc_weights)
from repro_torch.models import gan as tgan
from repro_torch.program import Program, ProgramSpec
from repro_torch.quant import tolerance as ttolerance
from repro_torch.quant import weights as tweights

MODELS = ["3dgan", "artgan", "dcgan", "discogan", "gpgan", "magan"]
DTYPES = ("bfloat16", "float16")
TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16,
               "float16": torch.float16}
# two storage ulps (atol, rtol)
TWO_ULPS = {"bfloat16": (1e-3, 2 ** -6), "float16": (1e-3, 2 ** -9)}
SCALE = 0.0625     # the calibration configuration of repro.quant.tolerance


def _two_ulp_share(got: torch.Tensor, ref: torch.Tensor, dtype: str
                   ) -> float:
    """The worst output's share of the two-ulp tolerance (<= 1 passes)."""
    atol, rtol = TWO_ULPS[dtype]
    got, ref = got.double(), ref.double()
    return ((got - ref).abs() / (atol + rtol * ref.abs())).max().item()


def _bits(a) -> np.ndarray:
    """The raw bits of a torch tensor or a (JAX / numpy) array."""
    if isinstance(a, torch.Tensor):
        view = {2: torch.int16, 4: torch.int32}[a.element_size()]
        return a.contiguous().view(view).numpy()
    a = np.asarray(a)
    return a.view({2: np.int16, 4: np.int32}[a.dtype.itemsize])


# ---------------------------------------------------------------------------
# (a) precision and tolerance.
# ---------------------------------------------------------------------------

ALIASES = ["bf16", "bfloat16", "f16", "fp16", "half", "float16", "f32",
           "fp32", "float32", " BF16 "]


@pytest.mark.parametrize("alias", ALIASES)
def test_canonical_dtype_matches_the_reference(alias):
    assert quant.canonical_dtype(alias) == jprecision.canonical_dtype(alias)
    name = quant.canonical_dtype(alias)
    assert quant.storage_dtype(alias) == TORCH_DTYPE[name]
    assert quant.storage_itemsize(alias) == \
        jprecision.storage_itemsize(alias)
    assert quant.canonical_dtype(TORCH_DTYPE[name]) == name


@pytest.mark.parametrize("bad", ["float64", "int8", "complex64", "nope"])
def test_unsupported_storage_dtype_raises_as_the_reference(bad):
    for fn in (quant.canonical_dtype, jprecision.canonical_dtype):
        with pytest.raises(ValueError, match="storage dtype"):
            fn(bad)
    with pytest.raises(ValueError, match="storage dtype"):
        quant.canonical_dtype(torch.float64)
    with pytest.raises(ValueError, match="storage dtype"):
        tgan.GanConfig("dcgan", dtype=bad)


def test_precision_spec_matches_the_reference():
    for storage in ("bf16", "f16", "float32"):
        ours, theirs = quant.Precision(storage), jprecision.Precision(storage)
        assert (ours.storage, ours.itemsize, ours.is_f32, ours.describe()) \
            == (theirs.storage, theirs.itemsize, theirs.is_f32,
                theirs.describe())
        assert ours.accum_dtype == torch.float32
        assert ours == quant.Precision(ours.storage)
    assert quant.SUPPORTED_STORAGE_DTYPES == \
        jprecision.SUPPORTED_STORAGE_DTYPES
    assert quant.__all__ == __import__("repro.quant").quant.__all__


def test_tolerance_tables_equal_the_reference():
    assert ttolerance.MODEL_TOLERANCES == jtolerance.MODEL_TOLERANCES
    assert ttolerance.OP_TOLERANCES == jtolerance.OP_TOLERANCES
    for name in MODELS:
        for dtype in ("bfloat16", "float16", "int8"):
            assert quant.model_tolerance(name, dtype) == \
                jtolerance.model_tolerance(name, dtype)
    for dtype in DTYPES:
        for what in ("fwd", "grad_rel"):
            assert quant.op_tolerance(dtype, what) == \
                jtolerance.op_tolerance(dtype, what)
    with pytest.raises(KeyError):
        quant.model_tolerance("dcgan", "float64")


# ---------------------------------------------------------------------------
# (b) int8 weights, bit for bit.
# ---------------------------------------------------------------------------

@functools.cache
def _reference_params(name: str, scale: float = SCALE):
    """The reference's seed-0 parameters of both networks, as numpy."""
    cfg = jgan.GanConfig(name, channel_scale=scale)
    g, d = jgan.init_gan(cfg, jax.random.PRNGKey(0))
    return ({k: np.asarray(v) for k, v in g.items()},
            {k: np.asarray(v) for k, v in d.items()})


@pytest.mark.parametrize("name", MODELS)
def test_quantized_params_are_the_references_bits(name):
    for params in _reference_params(name):
        tparams = {k: torch.tensor(v) for k, v in params.items()}
        blob = quant.quantize_params(tparams)
        ref = jweights.quantize_params(
            {k: jnp.asarray(v) for k, v in params.items()})
        assert blob == ref
        for k, v in params.items():
            if v.ndim >= 2:
                q, s = quant.quantize_weight(tparams[k])
                jq, js = jweights.quantize_weight(jnp.asarray(v))
                np.testing.assert_array_equal(q, jq)
                np.testing.assert_array_equal(_bits(s), _bits(js))
        for dtype in ("float32", "bfloat16", "float16"):
            ours = quant.dequantize_params(blob, dtype)
            theirs = jweights.dequantize_params(ref, dtype)
            assert set(ours) == set(theirs)
            for k in ours:
                want = TORCH_DTYPE[dtype] if params[k].ndim >= 2 \
                    else torch.float32
                assert ours[k].dtype == want
                np.testing.assert_array_equal(_bits(ours[k]),
                                              _bits(theirs[k]))


def test_validate_quantized_rejects_what_the_reference_rejects():
    g, _ = _reference_params("dcgan")
    blob = json.loads(json.dumps(quant.quantize_params(
        {k: torch.tensor(v) for k, v in g.items()})))
    tweights.validate_quantized(blob)
    bad_scheme = dict(blob, scheme="int4-groupwise")
    truncated = json.loads(json.dumps(blob))
    first = next(k for k, v in truncated["params"].items()
                 if v["kind"] == "int8")
    truncated["params"][first]["values"]["data"] = "AAAA"
    wrong_kind = json.loads(json.dumps(blob))
    wrong_kind["params"][first]["kind"] = "int4"
    for bad in (bad_scheme, truncated, wrong_kind, {"scheme": "x"}, None):
        for validate in (tweights.validate_quantized,
                         jweights.validate_quantized):
            with pytest.raises(ValueError):
                validate(bad)
    with pytest.raises(ValueError, match="rank"):
        quant.quantize_weight(torch.zeros(7))
    q, s = quant.quantize_weight(torch.zeros((3, 3, 2, 4)))
    assert np.all(s == 1.0) and np.all(q == 0)


def test_quantize_program_wants_covering_params():
    cfg = tgan.GanConfig("dcgan", channel_scale=SCALE)
    g, _ = tgan.init_gan(cfg, torch.Generator().manual_seed(0), "cpu")
    spec = ProgramSpec.build(cfg, 2, "generator")
    with pytest.raises(ValueError, match="t0_w"):
        quant.quantize_program(spec, {k: v for k, v in g.items()
                                      if k != "t0_w"})


def test_reference_v3_file_serves_in_the_port(tmp_path):
    """An int8 export of the reference (bf16, seed-0 weights) loads in
    the port with its payload and dtype, dequantizes to the reference's
    bits, and serves through GanServer with g_params=None."""
    from repro.quant import quantize_program as jquantize_program
    from repro_torch.serve.gan import GanServer
    cfg = jgan.GanConfig("dcgan", channel_scale=SCALE, dtype="bf16")
    g, _ = jgan.init_gan(cfg, jax.random.PRNGKey(0))
    path = tmp_path / "ref.json"
    jspec = jquantize_program(JSpec.build(cfg, 2, "generator"), g)
    jspec.save(path)
    spec = ProgramSpec.load(path)
    assert spec.dtype == "bfloat16"
    assert spec.quantized_params == jspec.quantized_params
    prog = Program(spec, device="cpu")
    theirs = JProgram(JSpec.load(path)).params
    for k, v in prog.params.items():
        np.testing.assert_array_equal(_bits(v), _bits(theirs[k]))
    srv = GanServer(tgan.GanConfig("dcgan", channel_scale=SCALE), None,
                    batch_size=2, program=prog, device="cpu")
    assert srv.cfg.dtype == "bfloat16"
    img = srv.generate(3)
    assert img.shape == (3, 64, 64, 3) and img.dtype == torch.bfloat16
    assert srv.samples_buffered == 1


def test_port_v3_file_loads_in_the_reference(tmp_path):
    """The port's int8 export passes the reference's validate_quantized
    and loads as a repro.program.ProgramSpec with the same payload and
    dtype (built on a backend both packages name alike)."""
    cfg = tgan.GanConfig("dcgan", channel_scale=SCALE, dtype="bf16",
                         backend="polyphase")
    g, _ = tgan.init_gan(cfg, torch.Generator().manual_seed(0), "cpu")
    spec = quant.quantize_program(ProgramSpec.build(cfg, 2, "generator"), g)
    path = tmp_path / "port.json"
    spec.save(path)
    doc = json.loads(path.read_text())
    assert doc["version"] == 3 and doc["dtype"] == "bfloat16"
    jweights.validate_quantized(doc["quantized_params"])
    jspec = JSpec.load(path)
    assert jspec.dtype == "bfloat16"
    assert jspec.quantized_params == spec.quantized_params
    assert ProgramSpec.load(path) == spec
    ours = Program(spec, device="cpu").params
    theirs = JProgram(jspec).params
    for k, v in ours.items():
        np.testing.assert_array_equal(_bits(v), _bits(theirs[k]))
    assert "quant=int8" in repr(Program(spec, device="cpu"))
    assert "quant=int8" in spec.describe()


# ---------------------------------------------------------------------------
# (c) the op sweep at bf16/f16.
# ---------------------------------------------------------------------------

# (kind, nd) -> stride-parametrized small geometry (tests/test_quant.py)
GEOMS = {
    ("tconv", 2): lambda s: ((1, 4, 4, 4), (3, 3, 4, 4), (s, s), (1, 1)),
    ("tconv", 3): lambda s: ((1, 2, 3, 2, 2), (3, 3, 3, 2, 3),
                             (s, s, s), (1, 1, 1)),
    ("conv", 2): lambda s: ((1, 7, 7, 4), (3, 3, 4, 4), (s, s), (1, 1)),
    ("conv", 3): lambda s: ((1, 5, 5, 5, 2), (3, 3, 3, 2, 2),
                            (s, s, s), (1, 1, 1)),
}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("stride", [1, 2, 3])
@pytest.mark.parametrize("kind,nd", sorted(GEOMS))
def test_op_sweep_low_precision(kind, nd, stride, dtype):
    xs, ws, strides, pads = GEOMS[kind, nd](stride)
    rng = np.random.default_rng(0)
    x = rng.normal(size=xs).astype(np.float32)
    w = rng.normal(size=ws).astype(np.float32)
    td = TORCH_DTYPE[dtype]
    op = tdf.tconv if kind == "tconv" else tdf.conv
    jop = jtconv if kind == "tconv" else jconv
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    got = op(xt.to(td), wt.to(td), strides, pads)
    assert got.dtype == td
    jd = jnp.dtype(jprecision.storage_dtype(dtype))
    ref = jop(jnp.asarray(x).astype(jd), jnp.asarray(w).astype(jd), strides,
              pads, policy=JPolicy(backend="pallas-interpret"))
    ref = torch.tensor(np.asarray(ref.astype(jnp.float32)))
    assert _two_ulp_share(got, ref, dtype) <= 1
    y32 = op(xt, wt, strides, pads)
    rtol, atol = quant.op_tolerance(dtype, "fwd")
    np.testing.assert_allclose(got.float().numpy(), y32.numpy(), rtol=rtol,
                               atol=atol)
    # the oracle backends contract in f32 and cast back, as the
    # reference's preferred_element_type does
    for backend in ("polyphase", "zero-insert"):
        other = op(xt.to(td), wt.to(td), strides, pads, backend=backend)
        assert other.dtype == td
        assert _two_ulp_share(other, ref, dtype) <= 1


def test_bias_and_activation_run_in_f32_before_one_cast():
    rng = np.random.default_rng(3)
    x = torch.tensor(rng.normal(size=(2, 4, 4, 8)), dtype=torch.bfloat16)
    w = torch.tensor(rng.normal(size=(4, 4, 8, 16)) * 0.1,
                     dtype=torch.bfloat16)
    b = torch.tensor(rng.normal(size=16), dtype=torch.float32)
    ep = tdf.Epilogue(bias=True, activation="tanh")
    got = tdf.tconv(x, w, (2, 2), (1, 1), bias=b, epilogue=ep)
    # the same sums in float64, the epilogue in f32, one cast
    sums = tdf.tconv(x.double(), w.double(), (2, 2), (1, 1),
                     backend="polyphase")
    want = torch.tanh(sums.float() + b).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert _two_ulp_share(got, want, "bfloat16") <= 0.5
    # Epilogue.apply computes in f32 and casts back
    y = torch.tensor(rng.normal(size=(3, 16)), dtype=torch.float16)
    out = ep.apply(y, b)
    assert out.dtype == torch.float16
    assert torch.equal(out, torch.tanh(y.float() + b).half())


# ---------------------------------------------------------------------------
# (d) every generator within the reference's gates.
# ---------------------------------------------------------------------------

@functools.cache
def _reference_outputs(name: str):
    """The reference's generator outputs at f32, bf16, f16 and int8 (the
    int8 program at f32 storage) on its seed-0 weights and PRNGKey(1)
    latents, as in its tests/test_quant.py, with the inputs."""
    g, _ = _reference_params(name)
    cfg = jgan.GanConfig(name, channel_scale=SCALE)
    z = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (2, cfg.z_dim),
                                     jnp.float32))
    jg = {k: jnp.asarray(v) for k, v in g.items()}
    out = {}
    for dtype in ("float32",) + DTYPES:
        prog = JProgram.build(dataclasses.replace(cfg, dtype=dtype), 2,
                              "generator")
        out[dtype] = np.asarray(prog.forward(jg, z).astype(jnp.float32))
    from repro.quant import quantize_program as jquantize_program
    spec = jquantize_program(JSpec.build(cfg, 2, "generator"), jg)
    prog = JProgram(spec)
    out["int8"] = np.asarray(prog.forward(prog.params, z))
    return g, z, out


@functools.cache
def _port_output(name: str, dtype: str):
    g, z, _ = _reference_outputs(name)
    cfg = tgan.GanConfig(name, channel_scale=SCALE, dtype=dtype)
    params = params_from_jax(g, cfg, "cpu")
    prog = Program.build(cfg, 2, "generator", device="cpu",
                         differentiable=False)
    y = prog.apply(params, torch.tensor(z))
    assert y.dtype == TORCH_DTYPE[dtype]
    assert all(le.backend == "ganax" for le in prog.spec.layers)
    return y.float().numpy()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", MODELS)
def test_model_low_precision_gates(name, dtype):
    _, _, ref = _reference_outputs(name)
    gate = quant.model_tolerance(name, dtype)["output_atol"]
    y = _port_output(name, dtype)
    y32 = _port_output(name, "float32")
    drift = float(np.max(np.abs(y - y32)))
    assert drift < gate, (drift, gate)
    against = float(np.max(np.abs(y - ref[dtype])))
    assert against < gate, (against, gate)


@pytest.mark.parametrize("name", MODELS)
def test_int8_forward_gate_every_model(name):
    g, z, ref = _reference_outputs(name)
    cfg = tgan.GanConfig(name, channel_scale=SCALE)
    params = params_from_jax(g, cfg, "cpu")
    spec = quant.quantize_program(ProgramSpec.build(cfg, 2, "generator"),
                                  params)
    loaded = ProgramSpec.from_json(json.loads(json.dumps(spec.to_json())))
    prog = Program(loaded, device="cpu", differentiable=False)
    assert prog.quantized
    y = prog.apply(prog.params, torch.tensor(z))
    gate = quant.model_tolerance(name, "int8")["output_atol"]
    y32 = _port_output(name, "float32")
    assert float(np.max(np.abs(y.numpy() - y32))) < gate
    assert float(np.max(np.abs(y.numpy() - ref["int8"]))) < gate
    # a serving artifact: bit-stable across replays
    assert torch.equal(prog.apply(prog.params, torch.tensor(z)), y)


# ---------------------------------------------------------------------------
# (e) the 2-byte tc route on the CPU.
# ---------------------------------------------------------------------------

def test_routes_of_the_2_byte_instances():
    # a 16-byte copy is 8 channels: Cin 4 flattens at 2 bytes, not at f32
    assert flat_k_needed(4, 4) is False and flat_k_needed(4, 2) is True
    assert flat_k_needed(8, 2) is False and flat_k_needed(3, 4) is True
    assert (tc_block_k(4), tc_block_k(2)) == (32, 64)
    # DCGAN d1 (Cin 3) and 3D-GAN d1 (Cin 1) take the flattened K
    for cin, k in ((3, 16 * 3), (1, 64)):
        r = kernel_route(cin, 128, 64 * 32 * 32, k, 1, itemsize=2)
        assert r.kind == "tc" and r.flat_k
    # a stage holds 64 K at 2 bytes: DCGAN d4 splits over 128 stages
    r32 = kernel_route(512, 1024, 1024, 16 * 512)
    r16 = kernel_route(512, 1024, 1024, 16 * 512, itemsize=2)
    assert (r32.splits, r16.splits) == (4, 4)
    # narrow is the same at every dtype
    assert kernel_route(128, 3, 1 << 16, 512, 4, itemsize=2) == \
        kernel_route(128, 3, 1 << 16, 512, 4)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("flat", [False, True])
def test_tc_weights_at_2_bytes(flat, dtype):
    rng = np.random.default_rng(2)
    cin = 3 if flat else 16
    w = torch.tensor(rng.normal(size=(4, 4, cin, 24)),
                     dtype=TORCH_DTYPE[dtype])
    b, lo, k = tc_weights(w, flat)
    assert lo is None and b.dtype == w.dtype and b.is_contiguous()
    assert k % 64 == 0 and (k * 2) % 16 == 0
    if flat:
        want = w.reshape(4, 4 * cin, 24).transpose(1, 2)
        assert torch.equal(b[..., :4 * cin], want)
        assert not b[..., 4 * cin:].any()
    else:
        assert k == 4 * 64
        got = b.reshape(4, 24, 4, 64)
        assert torch.equal(got[..., :cin], w.permute(0, 3, 1, 2))
        assert not got[..., cin:].any()


# (x shape, w shape, strides, paddings, transposed, splits): 2-D and 3-D,
# Cin 1, 3, 8 (flattened K at 2 bytes: 1, 3; not 8), 16, 96 (a ragged
# second stage), split-K over three ranges
EMULATION_CASES = [
    ((2, 5, 5, 16), (4, 4, 16, 24), (2, 2), (1, 1), True, None),
    ((2, 9, 9, 3), (4, 4, 3, 16), (2, 2), (1, 1), False, None),
    ((2, 6, 6, 8), (3, 3, 8, 72), (1, 1), (1, 1), False, None),
    ((2, 4, 4, 96), (4, 4, 96, 40), (2, 2), (1, 1), True, 3),
    ((1, 6, 6, 6, 1), (4, 4, 4, 1, 16), (2, 2, 2), (1, 1, 1), False, None),
    ((1, 3, 3, 3, 16), (4, 4, 4, 16, 12), (2, 2, 2), (1, 1, 1), True, 3),
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("xs,ws,s,p,transposed,splits", EMULATION_CASES)
def test_tc_emulation_at_2_bytes_matches_plain(xs, ws, s, p, transposed,
                                               splits, dtype):
    rng = np.random.default_rng(7)
    td = TORCH_DTYPE[dtype]
    x = torch.tensor(rng.normal(size=xs), dtype=td)
    w = torch.tensor(rng.normal(size=ws) / math.sqrt(np.prod(ws[:-1])),
                     dtype=td)
    b = torch.tensor(0.1 * rng.normal(size=ws[-1]), dtype=torch.float32)
    with torch.no_grad():
        operands = ops.kernel_operands(x, w, s, p, transposed=transposed)
    q = tuple(operands[k] for k in ("qz", "qy", "qx") if k in operands)
    plain = ganax_conv_plain if len(q) == 2 else ganax_conv3d_plain
    got = tc_route_emulation(operands["x_pad"], operands["w_taps"],
                             operands["tables"], operands["out_strides"], q,
                             b, "leaky_relu", 0.2, splits=splits)
    ref = plain(**operands, bias=b, activation="leaky_relu")
    assert got.dtype == ref.dtype == td
    assert _two_ulp_share(got, ref, dtype) <= 1
    # both sum in f32: almost every output is the same value
    assert (got != ref).float().mean().item() < 0.01


@pytest.mark.parametrize("dtype", DTYPES)
def test_storage_dtype_sums_fail_the_two_ulp_gate(dtype):
    """The control of chip_smoke.py's quant phase on the CPU: the plain
    arithmetic with each tap's matmul and the sum kept in the storage
    dtype misses the two-ulp gate on a wide layer (DCGAN g1's geometry
    at batch 2), where the f32 sums meet it against float64."""
    rng = np.random.default_rng(5)
    td = TORCH_DTYPE[dtype]
    x = torch.tensor(rng.normal(size=(2, 4, 4, 1024)), dtype=td)
    w = torch.tensor(rng.normal(size=(4, 4, 1024, 512)) / math.sqrt(
        4 * 4 * 1024 * 0.3), dtype=td)
    with torch.no_grad():
        o = ops.kernel_operands(x, w, (2, 2), (1, 1), transposed=True)
    q = (o["qy"], o["qx"])
    args = (o["x_pad"], o["w_taps"], o["tables"], o["out_strides"], q)
    exact = plain_sums(*(a.double() for a in args[:2]), *args[2:])
    f32 = apply_epilogue_to_acc(plain_sums(*args), None, "none", 0.2)
    low = plain_sums(*args, acc_dtype=td)
    assert low.dtype == td and f32.dtype == torch.float32
    assert _two_ulp_share(f32.to(td), exact, dtype) <= 1
    assert _two_ulp_share(low, exact, dtype) > 1


# ---------------------------------------------------------------------------
# (f) servers, the discriminator, training.
# ---------------------------------------------------------------------------

def _quantized_program(dtype="bf16"):
    cfg = tgan.GanConfig("dcgan", channel_scale=SCALE, dtype=dtype)
    g, _ = tgan.init_gan(cfg, torch.Generator().manual_seed(0), "cpu")
    spec = quant.quantize_program(ProgramSpec.build(cfg, 4, "generator"), g)
    return Program(ProgramSpec.from_json(json.loads(json.dumps(
        spec.to_json()))), device="cpu")


@pytest.mark.parametrize("dtype", ["bf16", "f16"])
def test_server_and_engine_adopt_a_quantized_programs_dtype(dtype):
    from repro_torch.serve.gan import GanServer
    from repro_torch.serve.gan_engine import GanEngine
    prog = _quantized_program(dtype)
    want = TORCH_DTYPE[quant.canonical_dtype(dtype)]
    base = tgan.GanConfig("dcgan", channel_scale=SCALE)
    srv = GanServer(base, None, batch_size=4, program=prog, device="cpu")
    assert srv.cfg.dtype == prog.spec.dtype
    direct = srv.generate(6)
    assert direct.dtype == want and direct.shape == (6, 64, 64, 3)
    with GanEngine(base, None, buckets=(4,), program=prog,
                   device="cpu") as eng:
        assert eng.cfg.dtype == prog.spec.dtype
        out = eng.submit(6).result(timeout=30)
    assert out.dtype == want
    # the same program and seed: the engine's stream is the server's
    assert torch.equal(out, direct)
    # an explicit dtype wins over the program's, and then must match it
    with pytest.raises(ValueError, match="precision drift"):
        GanServer(base, None, batch_size=4, program=prog, dtype="f32",
                  device="cpu")


def test_g_params_none_needs_a_quantized_program():
    from repro_torch.serve.gan import GanServer
    from repro_torch.serve.gan_engine import GanEngine
    cfg = tgan.GanConfig("dcgan", channel_scale=SCALE, dtype="bf16")
    plain = Program.build(cfg, 2, "generator", device="cpu")
    for program in (None, plain):
        with pytest.raises(ValueError, match="quantized"):
            GanServer(cfg, None, batch_size=2, program=program,
                      device="cpu")
        with pytest.raises(ValueError, match="quantized"):
            GanEngine(cfg, None, buckets=(2,), program=program,
                      device="cpu")


@pytest.mark.parametrize("dtype", DTYPES)
def test_discriminator_logits_stay_f32(dtype):
    cfg = tgan.GanConfig("dcgan", channel_scale=SCALE, dtype=dtype)
    _, d = tgan.init_gan(cfg, torch.Generator().manual_seed(0), "cpu")
    img = torch.tensor(np.random.default_rng(2).uniform(
        -1, 1, size=(2, 64, 64, 3)), dtype=torch.float32)
    prog = Program.build(cfg, 2, "discriminator", device="cpu",
                         differentiable=False)
    logits = prog.apply(d, img)
    assert logits.dtype == torch.float32 and logits.shape == (2,)
    # against the reference's bf16/f16 discriminator on the same inputs
    jcfg = jgan.GanConfig("dcgan", channel_scale=SCALE, dtype=dtype,
                          backend="pallas-interpret")
    ref = JProgram.build(jcfg, 2, "discriminator").forward(
        {k: jnp.asarray(v.numpy()) for k, v in d.items()},
        jnp.asarray(img.numpy()))
    assert ref.dtype == jnp.float32
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref),
                               rtol=2 ** -6, atol=1e-3)


def test_training_at_low_precision_raises_naming_item_9b():
    """Item 9b is ported: a bf16 train step builds, and the backward of a
    bf16 forward through the kernel's autograd Function reaches the f32
    parameters (``dx`` at bf16, ``dw`` cast back through the casts at
    use) — no longer a raise."""
    from repro_torch.train.loop import make_gan_train_step
    cfg = tgan.GanConfig("dcgan", channel_scale=SCALE, dtype="bf16")
    g, d = tgan.init_gan(cfg, torch.Generator().manual_seed(0), "cpu")
    _, (gen, _) = make_gan_train_step(cfg, 2, g, d, device="cpu")
    z = torch.tensor(np.random.default_rng(1).normal(
        size=(2, cfg.z_dim)), dtype=torch.float32)
    y = gen(z)
    assert y.dtype == torch.bfloat16 and y.requires_grad
    y.float().square().sum().backward()
    grads = {k: p.grad for k, p in gen.params.items()}
    assert all(v is not None and v.dtype == torch.float32
               and bool(torch.isfinite(v).all()) for v in grads.values())
    assert all(float(v.abs().max()) > 0 for k, v in grads.items()
               if k.endswith("_w"))
