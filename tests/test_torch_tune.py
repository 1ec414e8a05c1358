"""The port's autotuning planner (``repro_torch.tune``) against the
reference's (``repro.tune``).

Measurements differ between frameworks, so the parity tests feed plans,
not timings: plan keys, plan files (round trip, corrupt, stale, wrong
version, a file the reference wrote), the CPU candidate pool and
``backend="auto"`` resolution with pinned plans equal the reference's,
with its backends mapped (``pallas-tpu`` → ``ganax``,
``pallas-interpret`` → ``ganax-plain``) and its platform ``cpu`` kept
(a ``tpu`` key is stale here).  The card's pool (``sm_90``) is pure
geometry and is held to the kernels' route table on the CPU:
``kernel_route``'s route first, at most 12, each passing
``check_route``; the tc route's order of sums (``tc_route_emulation``)
of every candidate route against the plain version at 1e-5.  The GPU
tests of the candidate routes are in ``tests/test_torch_cuda.py``.
"""

import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.gans import GAN_MODELS as J_MODELS
from repro.core import dataflow as jdf
from repro.models import gan as jgan
from repro.tune import Plan as JPlan
from repro.tune import PlanKey as JPlanKey
from repro.tune import Planner as JPlanner
from repro.tune import enumerate_candidates as j_enumerate
from repro.tune import layer_plan_keys as j_layer_plan_keys
from repro.tune import plan_key_for_op as j_plan_key_for_op
from repro_torch.core import dataflow as tdf
from repro_torch.kernels import ganax_conv as gc
from repro_torch.kernels import ops
from repro_torch.models import gan as tgan
from repro_torch.program import Program, ProgramSpec
from repro_torch.tune import (Candidate, Plan, PlanKey, Planner,
                              enumerate_candidates, layer_plan_keys,
                              plan_key_for_op, set_planner, warm_gan_plans)
from repro_torch.tune import measure as tmeasure
from repro_torch.tune.candidates import MAX_BLOCK_CANDIDATES

KEY = PlanKey(kind="tconv", batch=1, in_spatial=(4, 4), kernel=(4, 4),
              strides=(2, 2), paddings=(1, 1), cin=4, cout=6,
              dtype="float32", platform="cpu")
ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _isolated_planner():
    """No test leaks a process-wide planner into the next."""
    set_planner(None)
    yield
    set_planner(None)


def _xw(key=KEY, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(key.batch, *key.in_spatial, key.cin))
    w = rng.normal(size=(*key.kernel, key.cin, key.cout))
    return x.astype(np.float32), w.astype(np.float32)


# ---------------------------------------------------------------------------
# Keys and pools: the reference's, field for field.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(J_MODELS))
def test_layer_plan_keys_match_the_reference(name, dtype):
    jcfg = jgan.GanConfig(name, channel_scale=1 / 16)
    tcfg = tgan.GanConfig(name, channel_scale=1 / 16)
    for role, (jl, tl) in enumerate(zip(jcfg.layers, tcfg.layers)):
        j_eps = (jgan.generator_epilogues if role == 0
                 else jgan.discriminator_epilogues)(jl)
        t_eps = (tgan.generator_epilogues if role == 0
                 else tgan.discriminator_epilogues)(tl)
        ref = j_layer_plan_keys(jl, 2, dtype, "cpu", epilogues=j_eps)
        got = layer_plan_keys(tl, 2, dtype, "cpu", epilogues=t_eps)
        assert [(n, k.to_json()) for n, k in got] == \
            [(n, k.to_json()) for n, k in ref]
        # the spec walk keys the same workloads
        cfg = tgan.GanConfig(name, channel_scale=1 / 16, dtype=dtype)
        keys = ProgramSpec.build(cfg, 2, ("generator", "discriminator")
                                 [role], platform="cpu").plan_keys()
        assert keys == got


def test_plan_key_for_op_matches_the_reference():
    x, w = _xw()
    ep = (jdf.Epilogue(bias=True, activation="relu"),
          tdf.Epilogue(bias=True, activation="relu"))
    for dt, td in ((jnp.float32, torch.float32),
                   (jnp.bfloat16, torch.bfloat16)):
        ref = j_plan_key_for_op("tconv", jnp.asarray(x, dt),
                                jnp.asarray(w, dt), KEY.strides,
                                KEY.paddings, epilogue=ep[0])
        got = plan_key_for_op("tconv", torch.tensor(x).to(td),
                              torch.tensor(w).to(td), KEY.strides,
                              KEY.paddings, epilogue=ep[1])
        assert got.to_json() == ref.to_json()
    assert plan_key_for_op("tconv", torch.tensor(x), torch.tensor(w),
                           KEY.strides, KEY.paddings) == KEY


def test_cpu_pool_equals_the_reference_s():
    jkey = JPlanKey(**KEY.to_json())
    assert [c.backend for c in enumerate_candidates(KEY)] == \
        [c.backend for c in j_enumerate(jkey)] == ["polyphase",
                                                   "zero-insert"]
    assert all(c.route is None for c in enumerate_candidates(KEY))
    # the interpret-mode counterpart only when asked for, and routeless
    assert enumerate_candidates(KEY, backends=["ganax-plain"]) == \
        [Candidate("ganax-plain")]


def _every_layer_key(platform, dtype, batch):
    for name in sorted(J_MODELS):
        cfg = tgan.GanConfig(name)
        for layers, eps in zip(cfg.layers, (tgan.generator_epilogues,
                                            tgan.discriminator_epilogues)):
            yield from layer_plan_keys(layers, batch, dtype, platform,
                                       epilogues=eps(layers))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_sm90_candidates_are_routes_the_kernels_take(dtype):
    """Every full-width Table-I layer at batch 64: the card's pool is
    the ganax kernel's routes only, kernel_route's route first, at most
    12, each passing check_route; the two oracles only where named."""
    seen = set()
    for name, key in _every_layer_key("sm_90", dtype, 64):
        cands = enumerate_candidates(key)
        routes = [c.route for c in cands if c.backend == "ganax"]
        assert [c.backend for c in cands] == ["ganax"] * len(routes)
        named = enumerate_candidates(key, backends=["ganax", "polyphase",
                                                    "zero-insert"])
        assert named == cands + [Candidate("polyphase"),
                                 Candidate("zero-insert")]
        assert 1 <= len(routes) <= MAX_BLOCK_CANDIDATES, (name, key)
        p, t, q = tdf.kernel_call_geometry(key.kind, key.in_spatial,
                                           key.kernel, key.strides,
                                           key.paddings)
        item = 4 if dtype == "float32" else 2
        k = t * key.cin
        rows = key.batch * math.prod(q)
        assert routes[0] == gc.kernel_route(key.cin, key.cout, rows, k, p,
                                            item)
        assert len(set(routes)) == len(routes)
        for r in routes:
            assert gc.check_route(r, key.cin, key.cout, k, item) == r
            assert r.splits * p * rows * key.cout < 2 ** 31
            seen.add((r.kind, r.block_n, r.splits))
    # the pool reaches past the heuristic: other tile widths and splits
    assert {(kind, n) for kind, n, _ in seen} == \
        {("tc", 64), ("tc", 128), ("narrow", 0)}
    assert max(s for *_, s in seen) >= 8


def test_route_validator_refuses_what_the_kernels_do_not_take():
    k = 16 * 256
    for bad in (gc.KernelRoute("tc", 1, block_n=96),
                gc.KernelRoute("tc", 3, block_n=64),
                gc.KernelRoute("tc", 1024, block_n=64),
                gc.KernelRoute("narrow", 1),
                gc.KernelRoute("wide", 1, block_n=64)):
        with pytest.raises(ValueError, match="no GANAX kernel takes"):
            gc.check_route(bad, 256, 128, k)
    with pytest.raises(ValueError, match="no GANAX kernel takes"):
        gc.check_route(gc.KernelRoute("tc", 1, block_n=128), 256, 64, k)
    with pytest.raises(ValueError, match="no GANAX kernel takes"):
        gc.check_route(gc.KernelRoute("tc", 1, block_n=64), 64, 3, 256)
    # a flattened K past the kernel's offset table has no tc route
    assert gc.route_options(3, 64, 3 * 1024) == []
    # the op layer holds a route to the table on any device
    x, w = _xw()
    xt, wt = torch.tensor(x), torch.tensor(w)
    with pytest.raises(ValueError, match="no GANAX kernel takes"):
        ops.ganax_conv_transpose(xt, wt, KEY.strides, KEY.paddings,
                                 route=gc.KernelRoute("tc", 1, block_n=64))
    good = gc.KernelRoute("narrow", 1)
    with pytest.raises(ValueError, match="has none"):
        tdf.tconv(xt, wt, KEY.strides, KEY.paddings, backend="polyphase",
                  route=good)
    np.testing.assert_array_equal(
        tdf.tconv(xt, wt, KEY.strides, KEY.paddings, route=good).numpy(),
        tdf.tconv(xt, wt, KEY.strides, KEY.paddings).numpy())
    # JSON form: the choice alone
    assert gc.KernelRoute.from_json(good.to_json()) == good
    with pytest.raises(ValueError, match="bad kernel route"):
        gc.KernelRoute.from_json({"kind": "tc"})


# (x shape, w shape, strides, paddings, transposed): 2-D and 3-D, a
# flattened-K Cin, K long enough for splits
EMULATION_CASES = [
    ((2, 4, 4, 64), (4, 4, 64, 80), (2, 2), (1, 1), True),
    ((2, 9, 9, 3), (4, 4, 3, 72), (2, 2), (1, 1), False),
    ((1, 4, 4, 128), (4, 4, 128, 16), (1, 1), (0, 0), False),
    ((1, 2, 3, 2, 64), (4, 4, 4, 64, 72), (2, 2, 2), (1, 1, 1), True),
]


@pytest.mark.parametrize("case", EMULATION_CASES,
                         ids=lambda c: f"{'t' if c[4] else ''}conv"
                         f"{len(c[2])}d-cin{c[1][-2]}-cout{c[1][-1]}")
def test_tc_route_emulation_of_every_candidate(case):
    xs, ws, s, p, transposed = case
    rng = np.random.default_rng(3)
    x = torch.tensor(rng.normal(size=xs), dtype=torch.float32)
    w = torch.tensor(rng.normal(size=ws) * 0.1, dtype=torch.float32)
    b = torch.tensor(rng.normal(size=ws[-1]), dtype=torch.float32)
    o = ops.kernel_operands(x, w, s, p, transposed=transposed)
    q = tuple(o[k] for k in ("qz", "qy", "qx") if k in o)
    ref = gc._plain(o["x_pad"], o["w_taps"], o["tables"], o["out_strides"],
                    q, b, "relu", 0.2)
    key = PlanKey("tconv" if transposed else "conv", xs[0], xs[1:-1],
                  ws[:-2], s, p, ws[-2], ws[-1], platform="sm_90")
    routes = [c.route for c in enumerate_candidates(key)
              if c.backend == "ganax"]
    assert len(routes) > 1 and all(r.kind == "tc" for r in routes)
    for r in routes:
        got = gc.tc_route_emulation(o["x_pad"], o["w_taps"], o["tables"],
                                    o["out_strides"], q, b, "relu",
                                    splits=r.splits, block_n=r.block_n)
        np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5,
                                   rtol=1e-5, err_msg=r.describe())


# ---------------------------------------------------------------------------
# Plan files.
# ---------------------------------------------------------------------------

def test_plan_file_round_trip(tmp_path):
    path = tmp_path / "plans.json"
    p1 = Planner(path, repeats=2)
    plan = p1.plan(KEY)
    assert plan.source == "measured" and p1.measurements == 2
    assert p1.failures == 0 and path.exists()
    routed = dataclasses.replace(KEY, platform="sm_90", cin=256, cout=80)
    tuned = Plan("ganax", route=gc.KernelRoute("tc", 2, block_n=128),
                 measured_us=3.5)
    p1.put(routed, tuned)
    p2 = Planner(path)
    assert len(p2) == 2
    assert p2.lookup(KEY) == plan and p2.lookup(routed) == tuned
    assert p2.plan(KEY) == plan and p2.measurements == 0


def test_corrupt_plan_file_falls_back(tmp_path):
    path = tmp_path / "plans.json"
    path.write_text("{not json")
    p = Planner(path)
    assert p.load_error is not None and len(p) == 0
    assert p.lookup(KEY) is None
    p.repeats = 1
    p.plan(KEY)
    assert json.loads(path.read_text())["version"] == 1


def test_wrong_version_is_stale(tmp_path):
    path = tmp_path / "plans.json"
    path.write_text(json.dumps({"version": 999, "plans": []}))
    assert "version" in Planner(path).load_error


def test_stale_entries_dropped(tmp_path):
    good = {"key": KEY.to_json(),
            "plan": Plan(backend="zero-insert").to_json()}
    stale = [
        {"key": KEY.to_json(),
         "plan": {"backend": "systolic-array-9000", "blocks": None}},
        # the reference's accelerator: no plan of it runs here
        {"key": dict(KEY.to_json(), platform="tpu"),
         "plan": {"backend": "pallas-tpu", "blocks": None}},
        # a route the kernels do not take for this geometry
        {"key": dict(KEY.to_json(), platform="sm_90"),
         "plan": {"backend": "ganax", "blocks": None,
                  "route": {"kind": "tc", "splits": 1,
                            "block_n": 64}}},
        {"key": dict(KEY.to_json(), systolic=True),
         "plan": {"backend": "zero-insert", "blocks": None}},
    ]
    path = tmp_path / "plans.json"
    path.write_text(json.dumps({"version": 1, "plans": stale + [good]}))
    p = Planner(path)
    assert p.stale_dropped == len(stale) and len(p) == 1
    assert p.lookup(KEY).backend == "zero-insert"


def test_a_reference_plan_file_loads_with_the_same_lookups(tmp_path):
    """A CPU plan file the reference wrote (hand-put plans: the parity
    is in the file, not in timings), a pre-epilogue entry and a TPU key
    among them."""
    path = tmp_path / "plans.json"
    ref = JPlanner(path)
    fused = dataclasses.replace(JPlanKey(**KEY.to_json()), bias=True,
                                activation="leaky_relu")
    key3d = JPlanKey(kind="tconv", batch=1, in_spatial=(3, 3, 3),
                     kernel=(4, 4, 4), strides=(2, 2, 2),
                     paddings=(1, 1, 1), cin=2, cout=3)
    plans = {JPlanKey(**KEY.to_json()): JPlan("pallas-interpret",
                                              blocks=(2, 2, 3),
                                              measured_us=7.0),
             fused: JPlan("polyphase", measured_us=11.5),
             key3d: JPlan("zero-insert", source="heuristic"),
             dataclasses.replace(fused, platform="tpu"):
                 JPlan("pallas-tpu", blocks=(1, 4, 6))}
    for k, v in plans.items():
        ref.put(k, v)
    doc = json.loads(path.read_text())
    for entry in doc["plans"]:      # one entry from before the epilogue
        if entry["key"]["in_spatial"] == [3, 3, 3]:
            for f in ("bias", "activation", "leaky_slope"):
                del entry["key"][f]
    path.write_text(json.dumps(doc))
    ref = JPlanner(path)
    got = Planner(path)
    assert got.load_error is None and got.stale_dropped == 1
    assert len(got) == len(ref) - 1 == 3
    for k in plans:
        r = ref.lookup(k)
        g = got.lookup(PlanKey.from_json(k.to_json()))
        if k.platform == "tpu":
            assert g is None and r is not None
            continue
        assert (g.backend, g.blocks, g.measured_us, g.source, g.route) == \
            ({"pallas-interpret": "ganax-plain"}.get(r.backend, r.backend),
             r.blocks, r.measured_us, r.source, None)


def test_second_process_warm_file_zero_measurements(tmp_path):
    """The contract end to end: a fresh process starting from the
    persisted plan file performs zero measurements."""
    path = tmp_path / "plans.json"
    Planner(path, repeats=1).plan(KEY)
    key_json = json.dumps(KEY.to_json())
    code = f"""
import json
from repro_torch.tune import Planner, PlanKey
key = PlanKey.from_json(json.loads({key_json!r}))
p = Planner({str(path)!r})
plan = p.plan(key)
assert plan.source == "measured", plan
assert p.measurements == 0, p.measurements
print("MEASUREMENTS", p.measurements)
"""
    env = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}:"
               f"{os.environ.get('PYTHONPATH', '')}")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=str(ROOT), env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "MEASUREMENTS 0" in out.stdout


# ---------------------------------------------------------------------------
# Measurement and tuning.
# ---------------------------------------------------------------------------

def test_time_interleaved_reduce_modes(monkeypatch):
    """The reference's stubbed clock: with 2 thunks and the rotated
    round-robin, thunk0 times [10, 30, 20] and thunk1 [100, 200, 300]."""
    clock = [0, 10, 10, 110, 110, 310, 310, 340, 340, 360, 360, 660]
    ticks = iter(clock)
    monkeypatch.setattr(tmeasure.time, "perf_counter", lambda: next(ticks))
    thunks = [lambda: 1, lambda: 2]
    assert tmeasure.time_interleaved(thunks, warmup=0, repeats=3) == \
        [20.0, 200.0]
    ticks = iter(clock)
    assert tmeasure.time_interleaved(thunks, warmup=0, repeats=3,
                                     reduce="min") == [10.0, 100.0]
    with pytest.raises(ValueError):
        tmeasure.time_interleaved(thunks, reduce="mean")


def test_synthesized_inputs_are_seeded_by_the_key():
    a = tmeasure.synthesize_inputs(KEY)
    b = tmeasure.synthesize_inputs(KEY)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    bf = tmeasure.synthesize_inputs(dataclasses.replace(KEY,
                                                        dtype="bfloat16"))
    assert bf[0].dtype == torch.bfloat16
    assert tmeasure.synthesize_bias(KEY) is None
    assert tmeasure.synthesize_bias(dataclasses.replace(
        KEY, bias=True)).shape == (KEY.cout,)


def test_tune_prefers_heuristic_within_margin(monkeypatch):
    """On the card the heuristic's candidate is ganax on kernel_route's
    route; a within-noise win keeps it."""
    key = dataclasses.replace(KEY, platform="sm_90", cin=64, cout=80)
    heur, other = [c for c in enumerate_candidates(key)][:2]
    assert heur.backend == other.backend == "ganax"
    p = Planner(margin=0.1)
    fake = {heur: 1.00e-3, other: 0.95e-3,
            Candidate("polyphase"): 2e-3}
    monkeypatch.setattr(p, "measure_candidates",
                        lambda key, backends=None: dict(fake))
    assert p.tune(key).route == heur.route
    fake[other] = 0.5e-3
    plan = p.tune(key)
    assert (plan.backend, plan.route, plan.measured_us) == \
        ("ganax", other.route, 500.0)


def test_tune_all_candidates_failing_degrades_to_heuristic(monkeypatch):
    """Parity with the reference: nothing measurable → the heuristic;
    and the port counts each failed candidate."""
    p = Planner()
    monkeypatch.setattr(p, "measure_candidates",
                        lambda key, backends=None: {})
    plan = p.tune(KEY)
    assert plan.source == "heuristic"
    assert plan.backend == tdf.DataflowPolicy().resolve(2)
    q = Planner(repeats=1)

    def broken(*a, **k):
        raise RuntimeError("kernel launch failed")
    monkeypatch.setattr(tmeasure, "candidate_fn",
                        lambda key, cand: broken)
    assert q.tune(KEY).source == "heuristic"
    assert (q.failures, q.measurements) == (2, 0)


def test_a_kernel_candidate_failing_on_the_card_raises(monkeypatch):
    """On a card no kernel fault is tuned around: a ganax candidate that
    does not run is counted, and the planner raises naming it instead of
    planning the layer on another route or backend."""
    key = dataclasses.replace(KEY, platform="sm_90", cin=64, cout=80)
    p = Planner(repeats=1)
    # the workload on the CPU: the card's pool, timed by the host clock
    synthesize = tmeasure.synthesize_inputs
    monkeypatch.setattr(tmeasure, "synthesize_inputs", lambda k: synthesize(
        dataclasses.replace(k, platform="cpu")))
    heur = enumerate_candidates(key)[0]

    def candidate_fn(key, cand):
        fn = tdf.conv if key.kind == "conv" else tdf.tconv

        def run(x, w):
            if cand == heur:
                raise RuntimeError("ganax_conv kernel launch failed")
            return fn(x, w, key.strides, key.paddings,
                      backend="ganax-plain")
        return run
    monkeypatch.setattr(tmeasure, "candidate_fn", candidate_fn)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        p.tune(key)
    assert p.failures == 1 and len(p) == 0
    assert p.measurements == len(enumerate_candidates(key)) - 1


def test_warm_gan_plans_covers_all_layers():
    cfg = tgan.GanConfig("dcgan", channel_scale=0.03125)
    planner = Planner(repeats=1)
    plans = warm_gan_plans(cfg, batch=2, planner=planner, platform="cpu")
    g_layers, d_layers = cfg.layers
    assert len(plans) == len(g_layers) + len(d_layers)
    assert all(p.source == "measured" and p.backend in
               ("polyphase", "zero-insert") for p in plans.values())
    before = planner.measurements
    warm_gan_plans(cfg, batch=2, planner=planner, platform="cpu")
    assert planner.measurements == before and planner.failures == 0


# ---------------------------------------------------------------------------
# backend="auto".
# ---------------------------------------------------------------------------

PINNED = [("polyphase", None), ("zero-insert", None),
          ("pallas-interpret", (2, 2, 3)), ("pallas-interpret", None)]


@pytest.mark.parametrize("backend,blocks", PINNED)
def test_auto_with_a_pinned_plan_resolves_as_the_reference(backend, blocks):
    jplanner, tplanner = JPlanner(), Planner()
    jkey = JPlanKey(**KEY.to_json())
    jplanner.put(jkey, JPlan(backend, blocks, 5.0))
    tplanner.put(KEY, Plan.from_json(JPlan(backend, blocks, 5.0).to_json()))
    geo = ("tconv", KEY.in_spatial, KEY.kernel, KEY.strides, KEY.paddings,
           KEY.cin, KEY.cout)
    ref = jdf.resolve_execution(jdf.DataflowPolicy(backend="auto"), *geo,
                                planner=jplanner)
    got = tdf.resolve_execution(tdf.DataflowPolicy(backend="auto"), *geo,
                                planner=tplanner, platform="cpu")
    assert (got.backend, got.blocks, got.source, got.measured_us) == (
        {"pallas-interpret": "ganax-plain"}.get(ref.backend, ref.backend),
        ref.blocks, ref.source, ref.measured_us)
    assert tplanner.hits == jplanner.hits == 1
    # dispatch through the plan runs the pinned backend's numbers
    x, w = (torch.tensor(a) for a in _xw())
    set_planner(tplanner)
    auto = tdf.tconv(x, w, KEY.strides, KEY.paddings, backend="auto")
    pinned = tdf.tconv(x, w, KEY.strides, KEY.paddings,
                       backend=got.backend)
    np.testing.assert_allclose(auto.numpy(), pinned.numpy(), atol=1e-6)
    assert tplanner.measurements == 0


def test_auto_misses_and_stale_plans_fall_back_to_the_heuristic():
    planner = Planner()
    auto = tdf.DataflowPolicy(backend="auto")
    geo = ("tconv", KEY.in_spatial, KEY.kernel, KEY.strides, KEY.paddings,
           KEY.cin, KEY.cout)
    miss = tdf.resolve_execution(auto, *geo, planner=planner,
                                 platform="cpu")
    assert (miss.backend, miss.source) == ("ganax", "heuristic")
    assert (planner.lookups, planner.hits, planner.measurements) == \
        (1, 0, 0)
    # a tuned route that the kernels take is frozen; another is dropped
    key = dataclasses.replace(KEY, platform="sm_90")
    planner.put(key, Plan("ganax", route=gc.KernelRoute("narrow", 1)))
    hit = tdf.resolve_execution(auto, *geo, planner=planner,
                                platform="sm_90")
    assert hit.route == gc.KernelRoute("narrow", 1)
    assert hit.route.k_split == 16 and hit.source == "tuned"
    planner._plans[key] = Plan("ganax", route=gc.KernelRoute("tc", 1,
                                                               block_n=64))
    stale = tdf.resolve_execution(auto, *geo, planner=planner,
                                  platform="sm_90")
    assert (stale.backend, stale.route) == ("ganax", None)
    # blocks that no longer divide the geometry are dropped
    planner._plans[KEY] = Plan("ganax-plain", blocks=(3, 8, 16))
    assert tdf.resolve_execution(auto, *geo, planner=planner,
                                 platform="cpu").blocks is None
    # a 1-D layer: a kernel plan cannot run it
    key1d = PlanKey("tconv", 1, (3,), (2,), (2,), (0,), 2, 3)
    planner.put(key1d, Plan("ganax-plain"))
    res = tdf.resolve_execution(auto, "tconv", (3,), (2,), (2,), (0,), 2, 3,
                                planner=planner, platform="cpu")
    assert (res.backend, res.source) == ("polyphase", "heuristic")
    with pytest.raises(ValueError, match="auto"):
        tdf.DataflowPolicy(backend="auto", interpret=True).resolve(2)


def test_measure_tunes_a_miss_at_build(tmp_path):
    """``measure=True`` tunes at build (CPU pool), the program freezes
    the winners, and a warm rebuild measures nothing."""
    cfg = tgan.GanConfig("dcgan", channel_scale=0.03125, backend="auto")
    planner = Planner(tmp_path / "p.json", repeats=1)
    spec = ProgramSpec.build(cfg, 2, "generator", planner=planner,
                             measure=True, platform="cpu")
    assert all(le.source == "tuned" for le in spec.layers)
    assert planner.measurements == 8
    again = Program.build(cfg, 2, "generator", planner=Planner(
        tmp_path / "p.json"), measure=True, device="cpu")
    assert again.spec == spec
    z = torch.zeros((2, cfg.z_dim))
    g, _ = tgan.init_gan(cfg, torch.Generator().manual_seed(0), "cpu")
    y = again.apply(g, z)
    assert y.shape == (2, 64, 64, 3)


def test_cli_writes_under_build_by_default(tmp_path):
    from repro_torch.tune.__main__ import DEFAULT_OUT, main
    assert DEFAULT_OUT.startswith("build/")
    out = tmp_path / "tune.json"
    assert main(["--models", "dcgan", "--channel-scale", "0.03125",
                 "--device", "cpu", "--repeats", "1", "--no-e2e",
                 "--plans", str(tmp_path / "plans.json"),
                 "--out", str(out)]) == 0
    doc = json.loads(out.read_text())
    assert doc["_meta"]["planner"]["measurements"] == 18
    assert set(doc["dcgan"]["layers"]) == {"g/g1", "g/g2", "g/g3", "g/g4",
                                           "d/d1", "d/d2", "d/d3", "d/d4",
                                           "d/d5"}
