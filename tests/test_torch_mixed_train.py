"""Mixed-precision GAN training in the port (bf16/f16 storage, f32 sums,
f32 parameters) against the JAX package.

* The backward of ``repro_torch.core.dataflow.tconv/conv`` at bf16 and
  f16 (the kernel's autograd Function through ``ganax-plain``: ``dx``
  through the kernel at the storage dtype, ``dw`` as f32 sums of
  storage-dtype products cast once, ``db`` in f32) against ``jax.grad``
  of the reference's custom VJP under ``pallas-interpret`` at the same
  dtype, on the same numpy inputs, for tconv and conv, 2-D and 3-D:
  within one storage ulp in relative L2 (both round the same f32 sums
  once), and both within the reference's per-op ``grad_rel`` of the f32
  gradients (``repro.quant.tolerance.OP_TOLERANCES``).
* The networks of ``make_gan_train_step`` at bf16/f16 against the f32
  ones at the reference's calibration configuration (channel scale
  0.0625, batch 2), by the reference's protocol for ``grad_rel``
  (``tests/test_quant.py``: the generator's parameter gradients of
  ``sum(y²)``, relative L2 over the tree), for DCGAN and 3D-GAN.
* The port's ``test_mixed_precision_train_step_keeps_f32_state``: a
  bf16/f16 step keeps parameters, gradients and checkpoints f32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dataflow as jdf
from repro.quant import op_tolerance as j_op_tolerance
from repro_torch.core import dataflow as tdf
from repro_torch.models import gan as tgan
from repro_torch.quant import model_tolerance, op_tolerance
from repro_torch.train import checkpoint as tckpt
from repro_torch.train.loop import (discriminator_grads, generator_grads,
                                    make_gan_train_step)

DTYPES = {"bfloat16": (jnp.bfloat16, torch.bfloat16, 2 ** -8),
          "float16": (jnp.float16, torch.float16, 2 ** -11)}
# (kind, nd) -> (x shape, w shape, strides, paddings): stride 2, the
# training layers' stride, 2-D and 3-D (the reference's op sweep shapes)
GEOMS = {
    ("tconv", 2): ((1, 4, 4, 4), (3, 3, 4, 4), (2, 2), (1, 1)),
    ("tconv", 3): ((1, 2, 3, 2, 2), (3, 3, 3, 2, 3), (2, 2, 2), (1, 1, 1)),
    ("conv", 2): ((1, 7, 7, 4), (3, 3, 4, 4), (2, 2), (1, 1)),
    ("conv", 3): ((1, 5, 5, 5, 2), (3, 3, 3, 2, 2), (2, 2, 2), (1, 1, 1)),
}
CALIBRATION = (0.0625, 2)


def _rel(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_op_tolerances_are_the_reference_s():
    for name in DTYPES:
        assert op_tolerance(name, "grad_rel") == \
            j_op_tolerance(name, "grad_rel")


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("kind,nd", sorted(GEOMS))
def test_low_precision_vjp_matches_reference(kind, nd, dtype):
    xs, ws, s, p = GEOMS[kind, nd]
    jd, td, ulp = DTYPES[dtype]
    rng = np.random.default_rng(0)
    x = rng.normal(size=xs).astype(np.float32)
    w = rng.normal(size=ws).astype(np.float32)
    b = (0.3 * rng.normal(size=ws[-1])).astype(np.float32)
    jep = jdf.Epilogue(bias=True, activation="leaky_relu")
    policy = jdf.DataflowPolicy(backend="pallas-interpret")
    jop = jdf.tconv if kind == "tconv" else jdf.conv

    def loss(x, w, b, d):
        y = jop(x.astype(d), w.astype(d), s, p, policy=policy, bias=b,
                epilogue=jep)
        return jnp.sum(y.astype(jnp.float32) ** 2)

    args = (jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    ref32 = jax.grad(loss, argnums=(0, 1, 2))(*args, jnp.float32)
    ref = jax.grad(loss, argnums=(0, 1, 2))(*args, jd)

    leaves = [torch.tensor(a, requires_grad=True) for a in (x, w, b)]
    xt, wt, bt = leaves
    top = tdf.tconv if kind == "tconv" else tdf.conv
    y = top(xt.to(td), wt.to(td), s, p, backend="ganax-plain", bias=bt,
            epilogue=tdf.Epilogue(bias=True, activation="leaky_relu"))
    assert y.dtype == td
    got = torch.autograd.grad(y.float().square().sum(), leaves)
    gate = op_tolerance(dtype, "grad_rel")
    for name, g, r, r32 in zip(("dx", "dw", "db"), got, ref, ref32):
        assert g.dtype == torch.float32, name
        assert _rel(g, r) <= ulp, (name, _rel(g, r))
        assert _rel(g, r32) < gate, (name, _rel(g, r32))


def _calibration_grads(model, dtype):
    """The generator's parameter gradients of sum(y²) through the
    networks ``make_gan_train_step`` builds, at the calibration
    configuration, on seed-0 parameters and numpy latents."""
    scale, batch = CALIBRATION
    cfg = tgan.GanConfig(model, channel_scale=scale, dtype=dtype)
    g, d = tgan.init_gan(cfg, torch.Generator().manual_seed(0), "cpu")
    _, (gen, _) = make_gan_train_step(cfg, batch, g, d, device="cpu")
    z = torch.tensor(np.random.default_rng(1).normal(
        size=(batch, cfg.z_dim)), dtype=torch.float32)
    y = gen(z)
    params = gen.params
    grads = torch.autograd.grad(y.float().square().sum(),
                                list(params.values()))
    return y, dict(zip(params, grads))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("model", ["dcgan", "3dgan"])
def test_train_networks_within_the_reference_gate(model, dtype):
    y32, g32 = _calibration_grads(model, "float32")
    y, g = _calibration_grads(model, dtype)
    assert y.dtype == DTYPES[dtype][1]
    assert all(v.dtype == torch.float32 for v in g.values())
    gate = model_tolerance(model, dtype)
    drift = (y.float() - y32).abs().max().item()
    assert drift < gate["output_atol"], drift
    num = sum(float((g[k].double() - g32[k].double()).square().sum())
              for k in g)
    den = sum(float(v.double().square().sum()) for v in g32.values())
    rel = (num / den) ** 0.5
    assert rel < gate["grad_rel"], (rel, gate)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_mixed_precision_train_step_keeps_f32_state(dtype, tmp_path):
    """A bf16/f16 adversarial step: parameters, gradients and the
    checkpoint stay f32, the losses are finite, every parameter
    moves."""
    scale, batch = CALIBRATION
    cfg = tgan.GanConfig("dcgan", channel_scale=scale, dtype=dtype)
    g, d = tgan.init_gan(cfg, torch.Generator().manual_seed(0), "cpu")
    step, (gen, disc) = make_gan_train_step(cfg, batch, g, d, g_lr=0.05,
                                            device="cpu")
    rng = np.random.default_rng(2)
    first = cfg.layers[1][0]
    data = {"z": torch.tensor(rng.normal(size=(batch, cfg.z_dim)),
                              dtype=torch.float32),
            "real": torch.tensor(rng.uniform(
                -1, 1, size=(batch, *first.in_spatial, first.cin)),
                dtype=torch.float32)}
    _, d_grads = discriminator_grads(gen, disc, data["z"], data["real"])
    _, g_grads = generator_grads(gen, disc, data["z"])
    assert all(v.dtype == torch.float32 and bool(torch.isfinite(v).all())
               for v in (*d_grads.values(), *g_grads.values()))
    state = (gen.params, disc.params)
    before = tckpt.tree_map(lambda t: t.detach().clone(), state)
    state, metrics = step(state, data)
    assert all(np.isfinite(float(metrics[k])) for k in ("g_loss", "d_loss"))
    for new, old in zip(tckpt.tree_leaves(state), tckpt.tree_leaves(before)):
        assert new.dtype == torch.float32
        assert not torch.equal(new, old)
    tckpt.save(state, str(tmp_path), 1)
    restored = tckpt.restore(state, str(tmp_path), 1)
    assert all(v.dtype == torch.float32 for v in tckpt.tree_leaves(restored))
