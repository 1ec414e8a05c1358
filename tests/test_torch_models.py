"""The PyTorch port's GAN models against the JAX package's.

Every Table-I generator (the five 2-D ones and 3D-GAN), given the JAX
package's parameters and the same numpy latents, computes the
reference's image or volume on the CPU (atol = rtol = 1e-4 through a
whole generator: f32 on both sides, summed in another order).  Configs,
specs and the init follow the reference.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import gan as jgan
from repro.models.common import init_params
from repro_torch.convert import params_from_jax
from repro_torch.core import dataflow as tdf
from repro_torch.models import gan as tgan

SCALE = 1 / 32
GENERATORS = ["3dgan", "artgan", "dcgan", "discogan", "gpgan", "magan"]
CPU = torch.device("cpu")


def _generator_params(name, rng):
    """Generator parameters of the JAX package, as numpy.  DCGAN's come
    from the reference's own initializer (the generator half of its
    ``init_gan``); the other models draw numpy values of the reference's
    spec shapes (JAX's initializer compiles once per shape, which costs
    seconds per model on a CPU)."""
    jcfg = jgan.GanConfig(name, channel_scale=SCALE)
    if name == "dcgan":
        g = init_params(jax.random.PRNGKey(0), jgan.generator_specs(jcfg))
        g = {k: np.asarray(v) for k, v in g.items()}
    else:
        g = {k: ((s.scale or 1.0) * rng.normal(size=s.shape)).astype(
                 np.float32)
             for k, s in jgan.generator_specs(jcfg).items()}
    # non-zero biases, so the fused bias add is exercised too
    for k in g:
        if k.endswith("_b"):
            g[k] = (0.05 * rng.normal(size=g[k].shape)).astype(np.float32)
    return g


@pytest.mark.parametrize("name", GENERATORS)
def test_generator_matches_reference(name):
    jcfg = jgan.GanConfig(name, channel_scale=SCALE)
    tcfg = tgan.GanConfig(name, channel_scale=SCALE)
    rng = np.random.default_rng(0)
    g_np = _generator_params(name, rng)
    z = rng.normal(size=(2, jcfg.z_dim)).astype(np.float32)
    ref = jgan.generator_apply({k: jnp.asarray(v) for k, v in g_np.items()},
                               jnp.asarray(z), jcfg)
    gen = tgan.Generator(tcfg, params_from_jax(g_np, tcfg, CPU), CPU)
    with torch.inference_mode():
        got = gen(torch.from_numpy(z))
    assert tuple(got.shape) == tuple(ref.shape)
    assert got.abs().max() > 1e-3      # not a vacuous match
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("name", sorted(tgan.GAN_MODELS))
@pytest.mark.parametrize("scale", [1.0, SCALE, 0.1])
def test_config_layers_and_specs_match_reference(name, scale):
    jcfg = jgan.GanConfig(name, channel_scale=scale)
    tcfg = tgan.GanConfig(name, channel_scale=scale)
    for ours, theirs in zip(tcfg.layers, jcfg.layers):
        assert [dataclasses.asdict(l) for l in ours] == \
            [dataclasses.asdict(l) for l in theirs]
    for t_specs, j_specs in ((tgan.generator_specs(tcfg),
                              jgan.generator_specs(jcfg)),
                             (tgan.discriminator_specs(tcfg),
                              jgan.discriminator_specs(jcfg))):
        assert sorted(t_specs) == sorted(j_specs)
        for k, s in j_specs.items():
            assert (t_specs[k].shape, t_specs[k].axes, t_specs[k].init,
                    t_specs[k].scale) == (s.shape, s.axes, s.init, s.scale)
    g_layers, d_layers = tcfg.layers
    for ours, theirs in ((tgan.generator_epilogues(g_layers),
                          jgan.generator_epilogues(jcfg.layers[0])),
                         (tgan.discriminator_epilogues(d_layers),
                          jgan.discriminator_epilogues(jcfg.layers[1]))):
        assert [(e.bias, e.activation, e.leaky_slope) for e in ours] == \
            [(e.bias, e.activation, e.leaky_slope) for e in theirs]


@pytest.mark.parametrize("dtype", ["bfloat16", "bf16", "float16",
                                   "float64"])
def test_non_f32_dtype_raises(dtype):
    """bf16/f16 storage and their aliases canonicalize as the reference's
    GanConfig does; a dtype that is no storage dtype raises ValueError
    in both packages."""
    if dtype == "float64":
        with pytest.raises(ValueError, match="storage dtype"):
            tgan.GanConfig("dcgan", dtype=dtype)
        with pytest.raises(ValueError, match="storage dtype"):
            jgan.GanConfig("dcgan", dtype=dtype)
    else:
        assert tgan.GanConfig("dcgan", dtype=dtype).dtype == \
            jgan.GanConfig("dcgan", dtype=dtype).dtype != "float32"
    assert tgan.GanConfig("dcgan", dtype="f32").dtype == "float32"


def test_3dgan_on_the_card_raises(monkeypatch):
    """3D-GAN was refused on the kernel route until the 3-D kernel was
    ported; now it runs that route (on the CPU: the plain version of the
    3-D kernel) and equals the polyphase oracle.  Without a card, asking
    for one still raises."""
    cfg = tgan.GanConfig("3dgan", channel_scale=SCALE)
    g, _ = tgan.init_gan(cfg, torch.Generator().manual_seed(0), CPU)
    for name, t in g.items():      # non-zero biases exercise the epilogue
        if name.endswith("_b"):
            g[name] = 0.05 * torch.randn(t.shape,
                                         generator=torch.Generator()
                                         .manual_seed(len(name)))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tgan.Generator(cfg, g, device="cuda")
    z = torch.from_numpy(np.random.default_rng(2).normal(size=(2, 100))
                         .astype(np.float32))
    with torch.inference_mode():
        outs = {backend: tgan.Generator(
                    dataclasses.replace(cfg, backend=backend), g,
                    device="cpu")(z)
                for backend in (None, "ganax-plain", "polyphase")}
    assert tuple(outs[None].shape) == (2, 64, 64, 64, 1)
    assert outs[None].abs().max() > 1e-3
    torch.testing.assert_close(outs[None], outs["ganax-plain"], rtol=0,
                               atol=0)
    torch.testing.assert_close(outs[None], outs["polyphase"], atol=1e-4,
                               rtol=1e-4)


def test_init_gan_follows_the_specs():
    cfg = tgan.GanConfig("dcgan", channel_scale=SCALE)
    g1, d1 = tgan.init_gan(cfg, torch.Generator().manual_seed(3), CPU)
    g2, _ = tgan.init_gan(cfg, torch.Generator().manual_seed(3), CPU)
    tgan.check_params(g1, tgan.generator_specs(cfg))
    tgan.check_params(d1, tgan.discriminator_specs(cfg))
    specs = tgan.generator_specs(cfg)
    for k, v in g1.items():
        assert v.dtype == torch.float32 and v.device == CPU
        assert torch.equal(v, g2[k])
        if specs[k].init == "zeros":
            assert not v.any()
        else:   # truncated normal in [-2, 2] times the spec's scale
            assert v.abs().max() <= 2 * specs[k].scale + 1e-6
            assert v.std() > 0.3 * specs[k].scale


def test_dispatch_rejects_bias_epilogue_mismatch():
    x, w = torch.zeros(1, 4, 4, 8), torch.zeros(4, 4, 8, 16)
    with pytest.raises(ValueError, match="no bias"):
        tdf.tconv(x, w, (2, 2), (1, 1), epilogue=tdf.Epilogue(bias=True))
    with pytest.raises(ValueError, match="bias must have shape"):
        tdf.tconv(x, w, (2, 2), (1, 1), bias=torch.zeros(3))
