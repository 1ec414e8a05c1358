"""The PyTorch port's programs (``repro_torch.program``) against the
reference's (``repro.program``).

* Resolution: for every Table-I model, both roles and every policy row
  of the backend mapping (``repro_torch.core.dataflow``'s docstring),
  the port's ``resolve_execution`` equals the reference's, mapped
  (backend, provenance, and the mesh layout at model axes 1, 2 and 4).
  The reference's heuristic is taken on its accelerator, where it
  picks the kernel.  ``blocks_valid`` agrees on a grid of blocks.
* Specs: equal geometry signatures; the reference's saved files (v3,
  tuned blocks, a 2x2 mesh) and v1/v2 documents load in the port with
  mapped backends; stale or corrupt files degrade to fresh resolution.
* Numbers: ``Program.apply`` through ``ganax`` (its plain version on
  the CPU) and ``polyphase`` equals the reference's ``Program.apply``
  under ``pallas-interpret`` at 1e-4, on the same numpy inputs and
  parameters, for the generator and the discriminator of every model.
* The CLI round trip, and what raises until its ROADMAP item lands.
"""

import json

import jax
import numpy as np
import pytest
import torch

from repro.core import dataflow as jdf
from repro.models import gan as jgan
from repro.program import Program as JProgram
from repro.program import ProgramSpec as JSpec
from repro.tune import Plan, Planner
from repro.tune.zoo import layer_plan_keys
from repro_torch.convert import params_from_jax
from repro_torch.core import dataflow as tdf
from repro_torch.models import gan as tgan
from repro_torch.program import (Program, ProgramSpec, build_bucket_programs,
                                 load_or_build)
from repro_torch.program.__main__ import main as cli_main

MODELS = ["3dgan", "artgan", "dcgan", "discogan", "gpgan", "magan"]
ROLES = ("generator", "discriminator")
SCALE = 1 / 32
TOL = dict(atol=1e-4, rtol=1e-4)
# (backend, interpret) rows of the mapping table, as the reference's
# policy and the port's take them
POLICY_ROWS = [(None, None), ("pallas", None), ("pallas-tpu", None),
               ("pallas-interpret", None), (None, True), (None, False),
               ("pallas", True), ("polyphase", None), ("zero-insert", None)]


def _mapped(name: str) -> str:
    return {"pallas-tpu": "ganax",
            "pallas-interpret": "ganax-plain"}.get(name, name)


def _layers(cfg, role):
    g, d = cfg.layers
    return g if role == "generator" else d


@pytest.mark.parametrize("role", ROLES)
@pytest.mark.parametrize("name", MODELS)
def test_resolution_matches_the_reference(name, role, monkeypatch):
    monkeypatch.setattr(jdf, "_on_tpu", lambda: True)
    layers = _layers(jgan.GanConfig(name), role)
    for backend, interpret in POLICY_ROWS:
        jpol = jdf.DataflowPolicy(backend=backend, interpret=interpret)
        tpol = tdf.DataflowPolicy(backend=backend, interpret=interpret)
        for l in layers:
            kind = "tconv" if l.transposed else "conv"
            geo = (kind, l.in_spatial, l.kernel, l.strides, l.paddings,
                   l.cin, l.cout)
            for mesh_model in (1, 2, 4):
                ref = jdf.resolve_execution(jpol, *geo,
                                            mesh_model=mesh_model)
                got = tdf.resolve_execution(tpol, *geo,
                                            mesh_model=mesh_model)
                assert (got.backend, got.source, got.sharding,
                        got.blocks) == (_mapped(ref.backend), ref.source,
                                        ref.sharding, ref.blocks), \
                    (backend, interpret, l.name, mesh_model)


def test_resolution_edge_rows_match():
    """Contradictions raise in both; other ranks fall back or raise."""
    for backend, interpret in (("polyphase", True), ("pallas-tpu", True),
                               ("pallas-interpret", False)):
        with pytest.raises(ValueError, match="contradicts"):
            jdf.DataflowPolicy(backend=backend,
                               interpret=interpret).resolve(2)
        with pytest.raises(ValueError, match="contradicts"):
            tdf.DataflowPolicy(backend=backend,
                               interpret=interpret).resolve(2)
    for backend in (None, "pallas"):
        assert tdf.DataflowPolicy(backend).resolve(1) == "polyphase"
    with pytest.raises(NotImplementedError, match="2-D and 3-D"):
        tdf.DataflowPolicy("ganax").resolve(1)
    with pytest.raises(ValueError, match="unknown dataflow backend"):
        tdf.DataflowPolicy("systolic-array-9000")
    for name in ("dcgan", "3dgan"):
        for role in ROLES:
            l = _layers(jgan.GanConfig(name), role)[0]
            for mm in (2, 4):
                for min_bytes in (0, 1 << 20, None):
                    assert tdf.choose_layer_sharding(
                        l.kernel, l.cin, l.cout, mm, min_bytes=min_bytes) \
                        == jdf.choose_layer_sharding(
                            l.kernel, l.cin, l.cout, mm, min_bytes=min_bytes)


@pytest.mark.parametrize("name", ["dcgan", "3dgan", "magan"])
def test_blocks_valid_matches_the_reference(name):
    cfg = jgan.GanConfig(name, channel_scale=1 / 16)
    for role in ROLES:
        for l in _layers(cfg, role):
            kind = "tconv" if l.transposed else "conv"
            geo = (kind, l.in_spatial, l.kernel, l.strides, l.paddings,
                   l.cin, l.cout)
            lead = [(q,) for q in (1, 2, 3, 4, 8)] if len(l.kernel) == 2 \
                else [(z, y) for z in (1, 2, 4) for y in (1, 2, 3)]
            for q in lead:
                for bc in ((1, 1), (2, 3), (l.cin, l.cout),
                           (l.cin, 2 * l.cout)):
                    blocks = q + bc
                    assert tdf.blocks_valid(*geo, blocks) == \
                        jdf.blocks_valid(*geo, blocks), (l.name, blocks)
            assert not tdf.blocks_valid(*geo, (1, 1))      # wrong arity


@pytest.mark.parametrize("name", MODELS)
def test_geometry_signature_matches_the_reference(name):
    for scale in (1.0, SCALE):
        for role in ROLES:
            ref = JSpec.build(jgan.GanConfig(name, channel_scale=scale), 4,
                              role)
            got = ProgramSpec.build(tgan.GanConfig(name, channel_scale=scale),
                                    4, role)
            assert got.geometry_signature() == ref.geometry_signature()
            assert [le.w_param for le in got.layers] == \
                [le.w_param for le in ref.layers]
            assert [le.b_param for le in got.layers] == \
                [le.b_param for le in ref.layers]


def _tuned_reference_spec(cfg):
    """A reference spec tuned to ``pallas-interpret`` with explicit
    blocks on the first generator layer."""
    planner = Planner()
    g_layers, _ = cfg.layers
    keys = layer_plan_keys(g_layers, batch=2,
                           epilogues=jgan.generator_epilogues(g_layers))
    first = g_layers[0]
    for i, (_, key) in enumerate(keys):
        planner.put(key, Plan(backend="pallas-interpret",
                              blocks=(2, first.cin, first.cout) if i == 0
                              else None, measured_us=7.0))
    return JSpec.build(cfg, 2, "generator",
                       policy=jdf.DataflowPolicy(backend="auto"),
                       planner=planner)


def _reference_files(tmp_path):
    """(label, path, reference spec) of files the reference wrote."""
    cfg = jgan.GanConfig("dcgan", channel_scale=SCALE)
    specs = {
        "pallas-interpret": JSpec.build(
            cfg, 2, "generator",
            policy=jdf.DataflowPolicy(backend="pallas-interpret")),
        "polyphase": JSpec.build(
            cfg, 2, "discriminator",
            policy=jdf.DataflowPolicy(backend="polyphase")),
        "tuned": _tuned_reference_spec(cfg),
        "mesh": JSpec.build(jgan.GanConfig("3dgan", channel_scale=SCALE),
                            4, "generator", mesh=(2, 2),
                            cout_shard_min_bytes=0),
    }
    out = []
    for label, spec in specs.items():
        path = tmp_path / f"{label}.json"
        spec.save(path)
        out.append((label, path, spec))
    v3 = specs["pallas-interpret"].to_json()
    for version in (1, 2):
        doc = json.loads(json.dumps(v3))
        doc["version"] = version
        doc.pop("dtype")
        if version == 1:
            doc.pop("mesh")
            for le in doc["layers"]:
                le.pop("sharding")
        path = tmp_path / f"v{version}.json"
        path.write_text(json.dumps(doc))
        out.append((f"v{version}", path, specs["pallas-interpret"]))
    return out


def test_reference_files_load_with_mapped_backends(tmp_path):
    files = _reference_files(tmp_path)
    for label, path, ref in files:
        got = ProgramSpec.load(path)
        assert got.geometry_signature() == ref.geometry_signature(), label
        assert [le.backend for le in got.layers] == \
            [_mapped(le.backend) for le in ref.layers], label
        assert [(le.blocks, le.source, le.measured_us, le.sharding)
                for le in got.layers] == \
            [(le.blocks, le.source, le.measured_us, le.sharding)
             for le in ref.layers], label
        assert got.mesh == ref.mesh and got.dtype == "float32", label
        # a port file round-trips to the same spec
        assert ProgramSpec.from_json(json.loads(json.dumps(
            got.to_json()))) == got, label
    tuned = ProgramSpec.load(tmp_path / "tuned.json")
    assert tuned.layers[0].blocks is not None
    assert "the reference's Pallas tile shapes, kept as data" in \
        tuned.describe()
    mesh = ProgramSpec.load(tmp_path / "mesh.json")
    assert "cout" in {le.sharding for le in mesh.layers}
    with pytest.warns(RuntimeWarning, match="degrading"):
        prog = Program(mesh, device="cpu")
    assert prog.device_count == 1 and prog.mesh_str == "1"


CFG = dict(name="dcgan", channel_scale=SCALE)


def _fallback_case(case, tmp_path):
    cfg = tgan.GanConfig(**CFG)
    doc = ProgramSpec.build(cfg, 2, "generator").to_json()
    path = tmp_path / "prog.json"
    if case == "missing":
        return tmp_path / "nope.json"
    if case == "corrupt":
        path.write_text("{not json")
        return path
    if case == "wrong version":
        doc["version"] = 4
    elif case == "unknown backend":
        doc["layers"][0]["backend"] = "systolic-array-9000"
    elif case == "stale blocks":
        doc["layers"][0]["backend"] = "pallas-interpret"
        doc["layers"][0]["blocks"] = [3, 7, 11]   # divides nothing
    elif case == "geometry drift":
        doc = ProgramSpec.build(tgan.GanConfig("dcgan", channel_scale=1 / 16),
                                2, "generator").to_json()
    elif case == "corrupt activation":
        doc["layers"][0]["activation"] = "gelu"
    elif case == "missing b_param":
        doc["layers"][0]["b_param"] = None
    elif case == "quantized dtype":
        doc["dtype"] = "bfloat16"
    path.write_text(json.dumps(doc))
    return path


@pytest.mark.parametrize("case", [
    "missing", "corrupt", "wrong version", "unknown backend",
    "stale blocks", "geometry drift", "corrupt activation",
    "missing b_param", "quantized dtype"])
def test_bad_program_files_build_fresh(case, tmp_path):
    cfg = tgan.GanConfig(**CFG)
    path = _fallback_case(case, tmp_path)
    prog, loaded = load_or_build(path, cfg, 2, "generator", device="cpu")
    assert not loaded
    assert prog.spec.channel_scale == SCALE
    assert [le.backend for le in prog.spec.layers] == ["ganax"] * 4
    g, _ = tgan.init_gan(cfg, torch.Generator().manual_seed(0), "cpu")
    assert prog.apply(g, torch.zeros((2, 100))).shape == (2, 64, 64, 3)


def test_storage_dtype_file_loads_at_its_dtype(tmp_path):
    """A file frozen at bf16 (the "quantized dtype" case above, which a
    float32 config rebuilds) loads for a config at bf16."""
    path = _fallback_case("quantized dtype", tmp_path)
    for dtype in ("bf16", "bfloat16"):
        cfg = tgan.GanConfig(**CFG, dtype=dtype)
        prog, loaded = load_or_build(path, cfg, 2, "generator",
                                     device="cpu")
        assert loaded and prog.spec.dtype == "bfloat16"
        g, _ = tgan.init_gan(cfg, torch.Generator().manual_seed(0), "cpu")
        assert prog.apply(g, torch.zeros((2, 100))).dtype == torch.bfloat16


def test_good_program_file_loads(tmp_path):
    cfg = tgan.GanConfig(**CFG)
    path = tmp_path / "prog.json"
    ProgramSpec.build(cfg, 2, "generator",
                      policy=tdf.DataflowPolicy("zero-insert")).save(path)
    prog, loaded = load_or_build(path, cfg, 2, "generator", device="cpu")
    assert loaded
    assert all(le.backend == "zero-insert" for le in prog.spec.layers)


def _inputs(name, role, rng):
    jcfg = jgan.GanConfig(name, channel_scale=SCALE)
    specs = jgan.generator_specs(jcfg) if role == "generator" \
        else jgan.discriminator_specs(jcfg)
    p = {k: ((s.scale or 1.0) * rng.normal(size=s.shape)).astype(np.float32)
         for k, s in specs.items()}
    for k in p:
        if k.endswith("_b"):
            p[k] = (0.05 * rng.normal(size=p[k].shape)).astype(np.float32)
    if role == "generator":
        x = rng.normal(size=(2, jcfg.z_dim))
    else:
        l = jcfg.layers[1][0]
        x = rng.uniform(-1, 1, size=(2,) + tuple(l.in_spatial) + (l.cin,))
    return p, x.astype(np.float32)


@pytest.mark.parametrize("role", ROLES)
@pytest.mark.parametrize("name", MODELS)
def test_program_apply_matches_the_reference(name, role):
    p, x = _inputs(name, role, np.random.default_rng(len(name)))
    jcfg = jgan.GanConfig(name, channel_scale=SCALE,
                          backend="pallas-interpret")
    ref = np.asarray(JProgram.build(jcfg, 2, role).apply(
        {k: jax.numpy.asarray(v) for k, v in p.items()}, x))
    tcfg = tgan.GanConfig(name, channel_scale=SCALE)
    params = params_from_jax(p, tcfg, "cpu")
    for backend in (None, "polyphase"):
        prog = Program.build(tcfg, 2, role, device="cpu",
                             policy=tdf.DataflowPolicy(backend),
                             differentiable=False)
        assert {le.backend for le in prog.spec.layers} == \
            {backend or "ganax"}
        got = prog.apply(params, torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), ref, **TOL)


def test_bucket_programs_share_one_spec():
    cfg = tgan.GanConfig(**CFG)
    spec = ProgramSpec.build(cfg, 4, "generator")
    progs = build_bucket_programs(spec, (4, 1, 2, 2), device="cpu")
    assert list(progs) == [1, 2, 4]
    assert all(p.spec is spec and not p.differentiable
               for p in progs.values())
    assert len({id(p) for p in progs.values()}) == 1    # one, shared
    for bad in ((), (0, 2)):
        with pytest.raises(ValueError, match="buckets"):
            build_bucket_programs(spec, bad, device="cpu")


def test_cli_describe_export_load(tmp_path, capsys):
    path = tmp_path / "prog.json"
    assert cli_main(["dcgan", "--channel-scale", "0.0625", "--role",
                     "generator", "--export", str(path)]) == 0
    out = capsys.readouterr().out
    assert "program dcgan/generator" in out and "-> ganax" in out
    assert cli_main(["dcgan", "--channel-scale", "0.0625", "--load",
                     str(path), "--stats"]) == 0
    out = capsys.readouterr().out
    assert "program dcgan/generator" in out and "rebuilt" not in out
    assert "dataflow.resolve.heuristic" in out
    # the reference's CLI file loads too
    JSpec.build(jgan.GanConfig("dcgan", channel_scale=0.0625), 8,
                "discriminator",
                policy=jdf.DataflowPolicy("pallas-interpret")).save(path)
    assert cli_main(["dcgan", "--channel-scale", "0.0625", "--load",
                     str(path)]) == 0
    out = capsys.readouterr().out
    assert "program dcgan/discriminator" in out and "-> ganax-plain" in out


def test_what_is_not_ported_raises_naming_its_item(tmp_path, capsys):
    # the tuner (item 11) is ported: an auto build with a cold planner
    # looks every layer up, measures nothing and takes the heuristic
    from repro_torch.tune import Planner as TPlanner
    cfg = tgan.GanConfig("dcgan", channel_scale=SCALE, backend="auto")
    planner = TPlanner()
    spec = ProgramSpec.build(cfg, 2, "generator", planner=planner)
    assert [(le.backend, le.source) for le in spec.layers] == \
        [("ganax", "heuristic")] * 4
    assert (planner.lookups, planner.hits, planner.measurements) == \
        (4, 0, 0)
    # plan keys: the reference's, field for field
    ref = JSpec.build(jgan.GanConfig(**CFG), 2, "generator")
    assert [(n, k.to_json()) for n, k in spec.plan_keys()] == \
        [(n, k.to_json()) for n, k in ref.plan_keys()]
    assert spec.layers[0].plan_key(2, "bfloat16", "sm_90").platform == \
        "sm_90"
    # the CLI: --backend auto looks up, --measure tunes, a warm file
    # serves a second build with zero measurements
    plans = tmp_path / "plans.json"
    base = ["dcgan", "--channel-scale", str(SCALE), "--role", "generator",
            "--batch", "2", "--backend", "auto", "--plans", str(plans)]
    assert cli_main(base) == 0
    assert "(heuristic)" in capsys.readouterr().out and not plans.exists()
    assert cli_main(base + ["--measure", "--export",
                            str(tmp_path / "tuned.json")]) == 0
    out = capsys.readouterr().out
    assert out.count("(tuned") == 4, out
    warm = TPlanner(plans)
    tuned = ProgramSpec.build(cfg, 2, "generator", planner=warm)
    assert warm.measurements == 0 and warm.hits == 4
    assert tuned == ProgramSpec.load(tmp_path / "tuned.json")
    # quantization (item 9) is ported: the CLI exports an int8 program at
    # bf16, which loads and serves with its embedded weights; a payload
    # of an unknown scheme raises at load, as the reference's does
    path = tmp_path / "q.json"
    assert cli_main(["dcgan", "--channel-scale", str(SCALE), "--role",
                     "generator", "--dtype", "bf16", "--quantize", "int8",
                     "--export", str(path)]) == 0
    loaded = ProgramSpec.load(path)
    assert loaded.dtype == "bfloat16" and loaded.quantized_params
    assert ProgramSpec.build(tgan.GanConfig(**CFG), 2, "generator",
                             dtype="bfloat16").dtype == "bfloat16"
    doc = dict(spec.to_json(), quantized_params={"scheme": "int8"})
    with pytest.raises(ValueError, match="scheme"):
        ProgramSpec.from_json(doc)
    prog = Program(loaded, device="cpu")
    assert prog.quantized
    assert prog.params["t0_w"].dtype == torch.bfloat16
    assert prog.params["t0_b"].dtype == torch.float32
    from repro_torch.serve.gan import GanServer
    srv = GanServer(tgan.GanConfig(**CFG), None, batch_size=2, program=prog,
                    device="cpu")
    assert srv.cfg.dtype == "bfloat16"
    assert srv.generate(3).dtype == torch.bfloat16
