"""The paper's own models in the port against the JAX package's, on the
CPU: the analytical cycle/energy model (``repro_torch.core.analytical``),
the Table-I layer lists (``configs.gans.gan_layers``), the μop ISA machine
(``repro_torch.core.uop``) and the figure reproductions
(``repro_torch.paper_figs`` against ``benchmarks/paper_figs.py``).  Each
is a numpy copy with the reference's arithmetic in the same order, so
reports, rows, outputs and statistics are held equal exactly.

Also here: ``chip_smoke.py``'s ``paper`` phase rehearsed with the
kernel's plain version (the μop machine against ``ganax_conv_transpose``
at the card's 1e-4, the planted dropped ``mac`` that must fail it, the
kernel's products against the consequential MACs of every Table-I tconv
layer), and the public names the port added for parity with the
reference (``generator_apply``, ``discriminator_apply``, the backend
registry, ``tconv_output_shape``, ``kernel_supported``).
"""

import contextlib
import dataclasses
import importlib.util
import io
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import paper_figs as ref_figs
from repro.configs import gans as ref_gans
from repro.core import analytical as ref_an
from repro.core import dataflow as ref_df
from repro.core import scheduler as ref_sched
from repro.core import tconv as ref_tconv
from repro.core import uop as ref_uop
from repro.kernels import ops as ref_ops
from repro.models import gan as ref_gan
from repro_torch import paper_figs
from repro_torch.configs import gans
from repro_torch.core import analytical as an
from repro_torch.core import dataflow as df
from repro_torch.core import scheduler as sched_mod
from repro_torch.core import tconv as ttconv
from repro_torch.core import uop
from repro_torch.kernels import ops
from repro_torch.models import gan as tgan
from repro_torch.tune import candidates
from repro_torch.tune.planner import PlanKey

CPU = torch.device("cpu")
# tests/test_uop.py's machine cases: (H, W, k, s, p, PVs, PEs a PV)
UOP_CASES = [
    (4, 4, 5, 2, 2, 4, 4),
    (4, 4, 4, 2, 1, 2, 3),
    (5, 3, 3, 3, 1, 4, 2),
    (6, 6, 3, 1, 1, 4, 4),
    (8, 8, 2, 2, 0, 4, 4),
]
LAYERS = [(model, role, i)
          for model, (g, d) in sorted(gans.GAN_MODELS.items())
          for role, layers in (("generator", g), ("discriminator", d))
          for i in range(len(layers))]
TCONV_LAYERS = [(model, i) for model, (g, _) in sorted(gans.GAN_MODELS.items())
                for i, l in enumerate(g) if l.transposed]
FIGURES = ("fig1_inconsequential", "fig8_speedup_energy", "fig9_breakdown",
           "fig10_energy_units", "fig11_utilization")


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SMOKE = _chip_smoke()


def _ref_layer(layer: an.ConvLayer) -> ref_an.ConvLayer:
    return ref_an.ConvLayer(**dataclasses.asdict(layer))


def _quiet(fn):
    """``fn()``'s result and what it printed."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn()
    return out, buf.getvalue()


# -- the analytical model ----------------------------------------------------

@pytest.mark.parametrize("model,role,i", LAYERS,
                         ids=[f"{m}-{r}-{i}" for m, r, i in LAYERS])
def test_analyze_layer_matches_the_reference(model, role, i):
    g, d = gans.GAN_MODELS[model]
    layer = (g if role == "generator" else d)[i]
    got, want = an.analyze_layer(layer), ref_an.analyze_layer(
        _ref_layer(layer))
    for f in ("total_macs", "consequential_macs", "cycles_baseline",
              "cycles_ganax", "energy_baseline_pj", "energy_ganax_pj",
              "util_baseline", "util_ganax", "speedup", "energy_reduction",
              "inconsequential_fraction"):
        assert getattr(got, f) == getattr(want, f), f
    assert dataclasses.asdict(got.layer) == dataclasses.asdict(want.layer)


@pytest.mark.parametrize("model", sorted(gans.GAN_MODELS))
def test_model_report_matches_the_reference(model):
    g, d = gans.gan_layers(model)
    got = an.analyze_model(model, g, d)
    want = ref_an.analyze_model(model, [_ref_layer(l) for l in g],
                                [_ref_layer(l) for l in d])
    for f in ("gen_speedup", "gen_energy_reduction",
              "gen_inconsequential_fraction"):
        assert getattr(got, f) == getattr(want, f), f
    for which in ("baseline", "ganax"):
        assert got.utilization(which) == want.utilization(which)
        assert got.energy_breakdown(which) == want.energy_breakdown(which)
        assert got.runtime_split(which) == want.runtime_split(which)


def test_model_configs_and_conv_layer_methods_match_the_reference():
    assert dataclasses.asdict(an.EnergyTable()) == \
        dataclasses.asdict(ref_an.EnergyTable())
    assert dataclasses.asdict(an.AcceleratorConfig()) == \
        dataclasses.asdict(ref_an.AcceleratorConfig())
    assert an.AcceleratorConfig().n_pes == 256
    acc = an.AcceleratorConfig(n_pvs=4, pes_per_pv=8)
    racc = ref_an.AcceleratorConfig(n_pvs=4, pes_per_pv=8)
    layer = gans.GAN_MODELS["dcgan"][0][1]
    for a, b in ((an.analyze_layer(layer, acc),
                  ref_an.analyze_layer(_ref_layer(layer), racc)),):
        assert (a.cycles_ganax, a.energy_ganax_pj) == \
            (b.cycles_ganax, b.energy_ganax_pj)
    conv = an.ConvLayer("c", (64, 64), (4, 4), (2, 2), (1, 1), 3, 8,
                        transposed=False)
    assert conv.conv_out_spatial() == _ref_layer(conv).conv_out_spatial() \
        == (32, 32)
    with pytest.raises(ValueError, match="transposed"):
        conv.schedule()
    for model, i in TCONV_LAYERS:
        layer = gans.GAN_MODELS[model][0][i]
        assert layer.schedule() == sched_mod.make_schedule(
            layer.in_spatial, layer.kernel, layer.strides, layer.paddings)
        ref = _ref_layer(layer).schedule()
        assert layer.schedule().out_sizes == ref.out_sizes
        assert layer.schedule().consequential_macs(2, 3, 4) == \
            ref.consequential_macs(2, 3, 4)


@pytest.mark.parametrize("model", sorted(gans.GAN_MODELS))
def test_gan_layers_matches_the_reference(model):
    got, want = gans.gan_layers(model), ref_gans.gan_layers(model)
    for mine, theirs in zip(got, want, strict=True):
        assert [dataclasses.asdict(l) for l in mine] == \
            [dataclasses.asdict(l) for l in theirs]


# -- the figures -------------------------------------------------------------

@pytest.mark.parametrize("fig", FIGURES)
def test_figure_rows_and_tables_match_the_reference(fig):
    got, printed = _quiet(getattr(paper_figs, fig))
    want, ref_printed = _quiet(getattr(ref_figs, fig))
    assert got == want
    assert printed == ref_printed


def test_run_all_rows_match_the_reference():
    got, printed = _quiet(paper_figs.run_all)
    want, _ = _quiet(ref_figs.run_all)
    assert got == want and len(got) == SMOKE.PAPER_ROWS
    values = dict((n, v) for n, v, _ in got)
    assert round(values["fig8/speedup/mean"], 2) == 3.16
    assert round(values["fig8/energy/mean"], 2) == 2.93
    assert round(values["fig8/speedup/3dgan"], 2) == 7.02
    assert round(values["fig11/machine_16x16_k4s2"], 2) == 0.55
    # the header says what the numbers are
    assert printed.startswith(paper_figs.HEADER)
    assert "no chip measured" in paper_figs.HEADER


# -- the μop machine -----------------------------------------------------------

def test_index_generator_semantics():
    g = uop.StridedIndexGenerator()
    for reg, v in (("addr", 2), ("step", 3), ("end", 11), ("repeat", 2),
                   ("offset", 100)):
        g.configure(reg, v)
    g.start()
    assert [g.emit() for _ in range(6)] == [102, 105, 108, 100, 103, 106]
    g2 = uop.StridedIndexGenerator()
    for reg, v in (("repeat", 1), ("end", 2), ("step", 1)):
        g2.configure(reg, v)
    g2.start()
    g2.emit()
    g2.emit()
    assert not g2.running
    with pytest.raises(RuntimeError):
        g2.emit()
    with pytest.raises(ValueError, match="unknown config register"):
        g2.configure("stride", 1)


@pytest.mark.parametrize("regs", [
    dict(addr=2, step=3, end=11, repeat=2, offset=100),
    dict(addr=7, step=-2, end=9, repeat=3, offset=5),
    dict(addr=0, step=0, end=4, repeat=1, offset=-3),
    dict(addr=1, step=5, end=5, repeat=4, offset=0)])
def test_index_generator_matches_the_reference(regs):
    mine, theirs = uop.StridedIndexGenerator(), ref_uop.StridedIndexGenerator()
    for reg, v in regs.items():
        mine.configure(reg, v)
        theirs.configure(reg, v)
    mine.start()
    theirs.start()
    seq, ref = [], []
    for _ in range(40):
        if not theirs.running:
            break
        ref.append(theirs.emit())
        seq.append(mine.emit())
    assert seq == ref and mine.running == theirs.running


@pytest.mark.parametrize("mimd", [True, False], ids=["mimd", "lockstep"])
@pytest.mark.parametrize("h,w_,k,s,p,npv,npe", UOP_CASES)
def test_machine_matches_the_reference_bit_for_bit(h, w_, k, s, p, npv, npe,
                                                  mimd):
    rng = np.random.default_rng(h * 100 + k * 10 + s)
    x = rng.normal(size=(h, w_))
    w = rng.normal(size=(k, k))
    sched = sched_mod.make_schedule((h, w_), (k, k), (s, s), (p, p))
    out, stats = uop.run_tconv_on_machine(x, w, sched, n_pvs=npv,
                                          pes_per_pv=npe, mimd=mimd)
    ref_out, ref_stats = ref_uop.run_tconv_on_machine(
        x, w, ref_sched.make_schedule((h, w_), (k, k), (s, s), (p, p)),
        n_pvs=npv, pes_per_pv=npe, mimd=mimd)
    assert out.dtype == np.float64 and np.array_equal(out, ref_out)
    assert stats == ref_stats
    assert stats["macs"] == sched.consequential_macs(1, 1)
    dense = ttconv.tconv_ganax(torch.from_numpy(x[None, :, :, None]),
                               torch.from_numpy(w[:, :, None, None]),
                               (s, s), (p, p))
    np.testing.assert_allclose(out, dense[0, :, :, 0].numpy(), atol=1e-6,
                               rtol=1e-6)


def test_compiled_programs_match_the_reference():
    """The static translation itself: μop for μop, every per-PE
    immediate, and the reorganized row order."""
    for h, w_, k, s, p, npv, npe in UOP_CASES:
        sched = sched_mod.make_schedule((h, w_), (k, k), (s, s), (p, p))
        wq = sum(xd.out_size for xd in sched.dims[1])
        wp = w_ + sum(sched.uniform_padding()[1])
        progs, rows = uop.compile_tconv_program(sched, npv, npe, wq, wp)
        ref_progs, ref_rows = ref_uop.compile_tconv_program(
            ref_sched.make_schedule((h, w_), (k, k), (s, s), (p, p)), npv,
            npe, wq, wp)
        assert rows == ref_rows

        def flat(ps):
            return [[(u.kind.value, u.gen, u.reg, u.imms) for u in q.uops]
                    for q in ps]
        assert flat(progs) == flat(ref_progs)


def test_machine_beats_the_conventional_dataflow():
    """The same machine on the explicitly zero-inserted input (all taps)
    runs the zero-inserted dataflow's MACs and the same function."""
    rng = np.random.default_rng(0)
    h, k, s, p = 8, 4, 2, 1
    x = rng.normal(size=(h, h))
    w = rng.normal(size=(k, k))
    sched = sched_mod.make_schedule((h, h), (k, k), (s, s), (p, p))
    out, ganax = uop.run_tconv_on_machine(x, w, sched)
    xe = ttconv.zero_insert(torch.from_numpy(x[None, :, :, None]),
                            (s, s))[0, :, :, 0].numpy()
    base_sched = sched_mod.make_schedule(xe.shape, (k, k), (1, 1), (p, p))
    out_base, base = uop.run_tconv_on_machine(xe, w, base_sched)
    assert base["macs"] == sched.zero_inserted_macs(1, 1)
    assert base["macs"] / ganax["macs"] > 2.0
    np.testing.assert_allclose(out_base, out, atol=1e-9)
    assert 0.0 < ganax["utilization"] <= 1.0


# -- chip_smoke.py's paper phase, with the kernel's plain version ------------

@pytest.mark.parametrize("case", SMOKE.machine_cases(),
                         ids=lambda c: c[0].replace(" ", "_"))
def test_paper_phase_machine_against_the_kernel(case):
    r = SMOKE.machine_vs_kernel(case, CPU, plain=True)
    assert r["ok"] and r["finite"], r["err"]
    assert r["macs"] == r["consequential"]
    # the planted dropped mac μop fails the same gate
    assert not r["fault_ok"] and r["fault_err"] > 100 * SMOKE.ATOL


def test_paper_phase_covers_every_table1_geometry():
    cases = SMOKE.machine_cases()
    assert len(cases) == 13
    table1 = {(c[1], c[3], c[4], c[5]) for c in cases[len(SMOKE.UOP_CASES):]}
    assert table1 == {(n, 4, 2, 1) for n in (2, 4, 8, 16, 32)} | \
        {(n, 5, 1, 2) for n in (8, 16, 64)}
    assert all(c[6:] == SMOKE.PAPER_ARRAY for c in cases[5:])


@pytest.mark.parametrize("model,i", TCONV_LAYERS,
                         ids=[f"{m}-{i}" for m, i in TCONV_LAYERS])
def test_kernel_products_equal_consequential_macs(model, i):
    layer = gans.GAN_MODELS[model][0][i]
    products, conseq = SMOKE.kernel_products(layer, CPU)
    assert products == conseq == _ref_layer(layer).schedule() \
        .consequential_macs(layer.cin, layer.cout)


# -- public names added for parity -------------------------------------------

def _np_params(specs, rng):
    return {k: ((s.scale or 1.0) * rng.normal(size=s.shape)
                if s.init == "normal" else 0.05 * rng.normal(size=s.shape)
                ).astype(np.float32)
            for k, s in sorted(specs.items())}


@pytest.mark.parametrize("role", ["generator", "discriminator"])
def test_functional_apply_matches_the_reference(role):
    jcfg = ref_gan.GanConfig("dcgan", channel_scale=1 / 32)
    cfg = tgan.GanConfig("dcgan", channel_scale=1 / 32)
    rng = np.random.default_rng(5)
    if role == "generator":
        params = _np_params(ref_gan.generator_specs(jcfg), rng)
        x = rng.normal(size=(2, jcfg.z_dim)).astype(np.float32)
        ref_fn, fn = ref_gan.generator_apply, tgan.generator_apply
    else:
        params = _np_params(ref_gan.discriminator_specs(jcfg), rng)
        first = jcfg.layers[1][0]
        x = rng.uniform(-1, 1, size=(2, *first.in_spatial, first.cin)) \
            .astype(np.float32)
        ref_fn, fn = ref_gan.discriminator_apply, tgan.discriminator_apply
    want = np.asarray(ref_fn({k: jnp.asarray(v) for k, v in params.items()},
                             jnp.asarray(x), jcfg))
    tparams = {k: torch.tensor(v) for k, v in params.items()}
    got = fn(tparams, torch.tensor(x), cfg)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-4,
                               rtol=1e-4)
    # one cached program per (config, policy, role, batch, device)
    before = tgan._cached_program.cache_info().hits
    fn(tparams, torch.tensor(x), cfg)
    assert tgan._cached_program.cache_info().hits == before + 1
    # a differentiable program (autograd records it against the bound
    # network's parameters)
    assert got.requires_grad


@pytest.mark.parametrize("nd", [0, 1, 2, 3, 4])
def test_kernel_rank_gates_match_the_reference(nd):
    assert df.pallas_kernel_supported(nd) == \
        ref_df.pallas_kernel_supported(nd)
    assert ops.kernel_supported(nd) == ref_ops.kernel_supported(nd)
    for ref_name in ref_df.available_backends():
        assert df.backend_supports(df.port_backend(ref_name), nd) == \
            ref_df.backend_supports(ref_name, nd), ref_name
    assert not df.backend_supports("no-such-backend", nd)


def test_registered_backend_is_seen_everywhere():
    """A backend registered in each package (a 2-D-only dataflow, the
    polyphase oracle underneath) is listed, validated by the policy,
    dispatched to, gated by rank, and enumerated by the tuner."""
    calls = []

    def port_tconv(x, w, strides, paddings, epilogue, bias, route=None):
        calls.append("tconv")
        return df.BACKENDS["polyphase"].tconv(x, w, strides, paddings,
                                             epilogue, bias)

    def port_conv(x, w, strides, paddings, epilogue, bias, route=None):
        calls.append("conv")
        return df.BACKENDS["polyphase"].conv(x, w, strides, paddings,
                                            epilogue, bias)
    only_2d = lambda nd: nd == 2   # noqa: E731
    df.register_backend(df.Backend("custom-2d", port_tconv, port_conv,
                                   supports=only_2d))
    ref_df.register_backend(ref_df.Backend(
        "custom-2d", ref_df._BACKENDS["polyphase"].tconv,
        ref_df._BACKENDS["polyphase"].conv, supports=only_2d))
    try:
        assert "custom-2d" in df.available_backends()
        assert "custom-2d" in ref_df.available_backends()
        pol = df.DataflowPolicy(backend="custom-2d")
        assert pol.resolve(2) == "custom-2d"
        for nd in (1, 2, 3):
            assert df.backend_supports("custom-2d", nd) == \
                ref_df.backend_supports("custom-2d", nd) == (nd == 2)
        with pytest.raises(ValueError, match="does not support 3-D"):
            pol.resolve(3)
        with pytest.raises(ValueError, match="does not support 3-D"):
            ref_df.DataflowPolicy(backend="custom-2d").resolve(3)
        rng = np.random.default_rng(3)
        x = torch.tensor(rng.normal(size=(1, 4, 4, 2)).astype(np.float32))
        w = torch.tensor(rng.normal(size=(4, 4, 2, 3)).astype(np.float32))
        got = df.tconv(x, w, (2, 2), (1, 1), backend="custom-2d")
        want = df.tconv(x, w, (2, 2), (1, 1), backend="polyphase")
        assert calls == ["tconv"] and torch.equal(got, want)
        key = PlanKey(kind="tconv", batch=1, in_spatial=(4, 4),
                      kernel=(4, 4), strides=(2, 2), paddings=(1, 1),
                      cin=2, cout=3)
        key3 = dataclasses.replace(key, in_spatial=(4, 4, 4),
                                   kernel=(4, 4, 4), strides=(2, 2, 2),
                                   paddings=(1, 1, 1))
        assert [c.backend for c in candidates.enumerate_candidates(
            key, backends=("polyphase", "custom-2d"))] == \
            ["polyphase", "custom-2d"]
        assert [c.backend for c in candidates.enumerate_candidates(
            key3, backends=("polyphase", "custom-2d"))] == ["polyphase"]
    finally:
        del df.BACKENDS["custom-2d"]
        del ref_df._BACKENDS["custom-2d"]


@pytest.mark.parametrize("x_shape,w_shape,strides,paddings", [
    ((2, 4, 4, 8), (4, 4, 8, 3), (2, 2), (1, 1)),
    ((1, 5, 3, 2), (3, 3, 2, 4), (3, 3), (1, 1)),
    ((3, 8, 8, 1), (5, 5, 1, 6), (1, 1), (2, 2)),
    ((1, 4, 4, 4, 2), (4, 4, 4, 2, 1), (2, 2, 2), (1, 1, 1)),
    ((2, 7, 3), (3, 3, 5), (2,), (0,))])
def test_tconv_output_shape_matches_the_reference(x_shape, w_shape, strides,
                                                  paddings):
    got = ttconv.tconv_output_shape(x_shape, w_shape, strides, paddings)
    assert got == ref_tconv.tconv_output_shape(x_shape, w_shape, strides,
                                               paddings)
    if len(x_shape) in (4, 5):
        x = torch.zeros(x_shape)
        w = torch.zeros(w_shape)
        assert tuple(ttconv.tconv_ganax(x, w, strides, paddings).shape) \
            == got
