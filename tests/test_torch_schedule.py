"""The PyTorch port's schedule, μop tables and model table against the
JAX package's: the port keeps its own numpy copies, and these hold them
equal for every layer geometry of all six Table-I models (2-D and 3-D)."""

import dataclasses

import numpy as np
import pytest

from repro.configs.gans import GAN_MODELS as JAX_GAN_MODELS
from repro.core import dataflow as jdf
from repro.core.scheduler import make_schedule as jax_make_schedule
from repro_torch.configs.gans import GAN_MODELS
from repro_torch.core import dataflow as tdf
from repro_torch.core.scheduler import make_schedule

LAYERS = [(model, role, i)
          for model, (g, d) in sorted(JAX_GAN_MODELS.items())
          for role, layers in (("g", g), ("d", d))
          for i in range(len(layers))]


def _layer(models, model, role, i):
    g, d = models[model]
    return (g if role == "g" else d)[i]


def _geometry(layer):
    return (tuple(layer.in_spatial), tuple(layer.kernel),
            tuple(layer.strides), tuple(layer.paddings))


def _assert_tables_equal(got, ref, fields):
    for f in fields:
        a, b = getattr(got, f), getattr(ref, f)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            assert a == b, f


@pytest.mark.parametrize("model,role,i", LAYERS)
def test_uop_tables_match_reference(model, role, i):
    layer = _layer(JAX_GAN_MODELS, model, role, i)
    geo = _geometry(layer)
    three_d = len(layer.kernel) == 3
    if layer.transposed:
        got, ref = tdf.compile_uops(*geo), jdf.compile_uops(*geo)
        _assert_tables_equal(
            got, ref, ["n_taps", "tap_dy", "tap_dx", "k_idx", "valid", "pad",
                       "q_sizes"] + (["tap_dz"] if three_d else []))
        assert got.schedule.phase_order == ref.schedule.phase_order
        assert got.schedule.out_sizes == ref.schedule.out_sizes
    else:
        got, ref = tdf.compile_conv_uops(*geo), jdf.compile_conv_uops(*geo)
        _assert_tables_equal(
            got, ref, ["out_sizes", "n_taps", "tap_dy", "tap_dx", "pad"]
            + (["tap_dz"] if three_d else []))
    if not three_d:
        assert got.tap_dz is None and ref.tap_dz is None


@pytest.mark.parametrize("model", sorted(JAX_GAN_MODELS))
def test_gan_models_match_reference(model):
    assert sorted(GAN_MODELS) == sorted(JAX_GAN_MODELS)
    for ours, theirs in zip(GAN_MODELS[model], JAX_GAN_MODELS[model]):
        assert len(ours) == len(theirs)
        for a, b in zip(ours, theirs):
            assert dataclasses.asdict(a) == dataclasses.asdict(b)


@pytest.mark.parametrize("geo", [
    ((4, 4), (4, 4), (2, 2), (1, 1)),
    ((5, 3), (3, 5), (3, 2), (1, 2)),
    ((4, 4), (1, 1), (2, 2), (0, 0)),
    ((3, 3, 3), (4, 4, 4), (2, 2, 2), (1, 1, 1)),
    ((7,), (5,), (3,), (2,)),
])
def test_schedule_matches_reference(geo):
    got, ref = make_schedule(*geo), jax_make_schedule(*geo)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert got.phase_order == ref.phase_order
    assert got.uniform_padding() == ref.uniform_padding()
    assert got.consequential_macs(3, 5, 2) == ref.consequential_macs(3, 5, 2)
    tg, tr = got.tap_tables(), ref.tap_tables()
    assert sorted(tg) == sorted(tr)
    for k in tr:
        np.testing.assert_array_equal(tg[k], tr[k], err_msg=k)


def test_compile_uops_is_cached_and_frozen():
    geo = ((8, 8), (4, 4), (2, 2), (1, 1))
    u = tdf.compile_uops(*geo)
    assert tdf.compile_uops(*geo) is u
    with pytest.raises(ValueError):
        u.n_taps[0] = 0
    # 1-D geometries carry a schedule but no kernel tables
    assert tdf.compile_uops((7,), (5,), (3,), (2,)).n_taps is None
    with pytest.raises(ValueError, match="2-D/3-D"):
        tdf.compile_conv_uops((7,), (3,), (1,), (1,))
