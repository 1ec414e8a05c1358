"""The port's mesh (``repro_torch.launch.mesh``,
``repro_torch.sharding``) against the JAX package, over ``gloo`` ranks on
the CPU.

The ranks are child processes started by the port's launcher
(:func:`repro_torch.launch.mesh.spawn`), running
:func:`repro_torch.sharding.parity.run`, so they import torch and
``repro_torch`` only; this process computes the references with the JAX
package, unsharded, on the same numpy parameters and inputs, and holds
each rank's results against them.  Each world size spawns once (a
module-scoped fixture): world 2 runs the ``(2, 1)`` and ``(1, 2)``
cases, world 4 the ``(2, 2)`` ones.  The cases mirror
``tests/test_sharded_gan.py`` and ``tests/test_collective_matmul.py``:

* ``make_local_mesh``'s forms and errors against the reference's (its
  four forms at 1, 2, 4, 6, 7 and 8 devices through
  ``run_forced_devices``, the odd-count fallback among them);
* sharded forwards of DCGAN's and 3D-GAN's generator and discriminator,
  and (at world 2) of the other four Table-I generators (artgan,
  discogan, gpgan, magan), with ``cout_shard_min_bytes=0``, against the
  reference's unsharded ``Program.apply`` at 1e-5, each model with a
  Cout-sharded layer at ``(1, 2)``;
* gradients of ``sum(forward(params, x)**2)`` through a Cout-sharded
  program against the reference's unsharded ones (a missing or doubled
  gradient sum shows), at ``rtol=1e-4, atol=1e-5``;
* the data-parallel train step at ``(2, 1)`` (two steps through
  ``TrainLoop`` with a failure that makes every rank restore the
  checkpoint rank 0 wrote) and ``(2, 2)`` (from a checkpoint written
  unsharded) against the reference's step, at its tolerances; the
  sharded checkpoint restored unsharded;
* ``GanServer`` and ``GanEngine`` streams against the port's unsharded
  ones at equal seeds (RNG streams differ between the packages),
  ``GanServer.submit`` mixed with ``generate`` on every rank (rank 0's
  stream, the followers' empty answers, every rank closed), the bucket
  "divide" error, and a fault in rank 0's scheduler that must leave no
  rank waiting;
* both ring matmuls against the dense product at world 2 and 4;
* the sequence-sharded decode (``RunFlags(mesh=(2, 1) mesh,
  seq_shard_decode=True)``) at world 2: the tiny int8-decode model of
  tests/test_models.py (``tiny(qwen1.5-32b, float32, n_kv_heads=4)``),
  a 64-row cache the reference filled (40 steps from empty, carried
  across by ``cache_from_jax``, each rank cutting its 32 rows), 3 steps
  from lengths 13 and 40 (each on another rank), int8 and bf16, against
  the reference's unsharded ``decode_step`` (logits at 1e-4, the caches
  the ranks hold against the reference's), each attention layer's output
  against the port's one-device attention on the rank's own layer inputs
  (``parity.attention_oracle``) at 2e-5, 3 collectives a layer a step;
  the partials summed without their rescaling (a planted fault) far
  off;
* stale tuned routes and blocks dropped on a ``"cout"`` layer's local
  Cout shard (``dataflow.resolve.shard_blocks``), in this process.

Sizes: ``channel_scale = 0.0625``, batch 4 (2 for 3D-GAN).
"""

import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import run_forced_devices
from test_models import tiny

from repro.configs import base as jbase
from repro.models import gan as jgan
from repro.models import transformer as jtr
from repro.program import Program as JProgram
from repro.train.loop import make_gan_train_step as jax_train_step
from repro_torch import obs
from repro_torch.configs import base as tbase
from repro_torch.convert import cache_from_jax, lm_params_from_jax
from repro_torch.core import dataflow as tdf
from repro_torch.kernels.ganax_conv import KernelRoute
from repro_torch.launch.mesh import mesh_shape, production_mesh_shape, spawn
from repro_torch.models import gan as tgan
from repro_torch.program import ProgramSpec
from repro_torch.serve.gan import GanServer
from repro_torch.serve.gan_engine import GanEngine
from repro_torch.sharding import parity
from repro_torch.train import checkpoint as tckpt

SCALE = 0.0625
BATCH = {"dcgan": 4, "3dgan": 2, "artgan": 4, "discogan": 4, "gpgan": 4,
         "magan": 4}
# the Table-I generators held sharded at world 2 beside DCGAN and 3D-GAN
# (the reference holds all six: tests/test_sharded_gan.py)
MORE_GENERATORS = ("artgan", "discogan", "gpgan", "magan")
# GanServer calls on a mesh, in order (submits read after later calls)
SUBMIT_CALLS = (("generate", 6), ("submit", 4), ("submit", 5),
                ("generate", 3), ("submit", 2))
FWD_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
LR = 0.05
MESHES = {2: ((2, 1), (1, 2)), 4: ((2, 2),)}
# make_local_mesh's forms: key -> keyword arguments
FORMS = {"()": {}, "data=1": {"data": 1}, "data=2": {"data": 2},
         "model=2": {"model": 2}, "model=4": {"model": 4},
         "data=2,model=2": {"data": 2, "model": 2},
         "data=3,model=1": {"data": 3, "model": 1}}
FORM_NS = (1, 2, 4, 6, 7, 8)
# the sequence-sharded decode: a cache of DECODE_T rows filled by
# DECODE_FILL reference steps from empty, then DECODE_STEPS steps from
# lengths DECODE_LENS (one on each rank's half)
DECODE_T, DECODE_FILL, DECODE_STEPS = 64, 40, 3
DECODE_LENS = (13, 40)
DECODE_LOGITS_TOL = 1e-4
DECODE_ATTN_TOL = dict(atol=2e-5, rtol=2e-5)


def _np_params(specs, rng):
    """Numpy values of the reference's spec shapes, biases non-zero."""
    return {k: ((s.scale or 1.0) * rng.normal(size=s.shape)
                if s.init == "normal" else 0.05 * rng.normal(size=s.shape)
                ).astype(np.float32)
            for k, s in sorted(specs.items())}


def _t(tree):
    return {k: torch.tensor(v) for k, v in tree.items()}


def _jnp(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _inputs():
    """Per model: numpy G and D parameters, latents and images."""
    out = {}
    for i, name in enumerate(("dcgan", "3dgan")):
        jcfg = jgan.GanConfig(name, channel_scale=SCALE)
        rng = np.random.default_rng(10 + i)
        g = _np_params(jgan.generator_specs(jcfg), rng)
        d = _np_params(jgan.discriminator_specs(jcfg), rng)
        first = jcfg.layers[1][0]
        b = BATCH[name]
        out[name] = dict(
            g=g, d=d, z=rng.normal(size=(b, jcfg.z_dim)).astype(np.float32),
            img=rng.uniform(-1, 1, size=(b, *first.in_spatial, first.cin))
            .astype(np.float32))
    for i, name in enumerate(MORE_GENERATORS):
        jcfg = jgan.GanConfig(name, channel_scale=SCALE)
        rng = np.random.default_rng(20 + i)
        out[name] = dict(
            g=_np_params(jgan.generator_specs(jcfg), rng),
            z=rng.normal(size=(BATCH[name], jcfg.z_dim)).astype(np.float32))
    return out


def _decode_inputs():
    """The reference's tiny int8-decode model: its parameters, a cache of
    DECODE_T rows filled by DECODE_FILL teacher-forced steps from empty
    (both kv dtypes), then DECODE_STEPS steps from DECODE_LENS: their
    logits and the final caches (one jitted step)."""
    jcfg = tiny(jbase.get_config("qwen1.5-32b"), dtype="float32",
                n_kv_heads=4)
    params = jtr.init(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(5)
    fill = rng.integers(0, jcfg.vocab, (2, DECODE_FILL))
    toks = rng.integers(0, jcfg.vocab, (DECODE_STEPS, 2, 1))
    step = jax.jit(functools.partial(jtr.decode_step, cfg=jcfg))
    out = dict(cfg=dataclasses.asdict(jcfg),
               params=jax.tree.map(np.asarray, params), tokens=toks)
    for kvd in ("bf16", "int8"):
        cache = jtr.init_cache(jcfg, 2, DECODE_T, kv_dtype=kvd)
        for t in range(DECODE_FILL):
            _, cache = step(params, cache, jnp.asarray(fill[:, t:t + 1]),
                            jnp.full((2,), t, jnp.int32))
        filled = jax.tree.map(np.asarray, cache)
        logits = []
        for i in range(DECODE_STEPS):
            lg, cache = step(params, cache, jnp.asarray(toks[i]),
                             jnp.asarray(DECODE_LENS) + i)
            logits.append(np.asarray(lg))
        out[kvd] = dict(cache=filled, logits=np.stack(logits),
                        final=jax.tree.map(np.asarray, cache))
    return out


def _decode_case(dec: dict, kvd: str, fault: str | None = None) -> dict:
    tcfg = tbase.ArchConfig(**dec["cfg"])
    case = dict(
        name=f"decode {kvd} 2x1" + (f" {fault}" if fault else ""),
        kind="decode", mesh=(2, 1), cfg=dec["cfg"],
        params=lm_params_from_jax(dec["params"], tcfg, "cpu", torch.float32),
        cache=cache_from_jax(dec[kvd]["cache"], tcfg, "cpu"),
        tokens=torch.tensor(dec["tokens"]), lengths=torch.tensor(DECODE_LENS))
    if fault:
        case["fault"] = fault
    return case


def _cases(world: int, inp: dict, tmp) -> list[dict]:
    cases = []
    for mesh in MESHES[world]:
        tag = f"{mesh[0]}x{mesh[1]}"
        for name in ("dcgan", "3dgan"):
            for role, p, x in (("generator", "g", "z"),
                               ("discriminator", "d", "img")):
                cases.append(dict(
                    name=f"fwd {name} {role} {tag}", kind="forward",
                    model=name, scale=SCALE, role=role, mesh=mesh,
                    min_bytes=0, batch=BATCH[name],
                    params=_t(inp[name][p]),
                    x=torch.tensor(inp[name][x])))
        for name in MORE_GENERATORS if world == 2 else ():
            cases.append(dict(
                name=f"fwd {name} generator {tag}", kind="forward",
                model=name, scale=SCALE, role="generator", mesh=mesh,
                min_bytes=0, batch=BATCH[name], params=_t(inp[name]["g"]),
                x=torch.tensor(inp[name]["z"])))
    d = inp["dcgan"]
    ring = np.random.default_rng(world)
    m, k, n = 8 * world, 32, 16 * world
    cases.append(dict(
        name="ring", kind="ring", mesh=(1, world),
        **{key: torch.tensor(ring.normal(size=shape).astype(np.float32))
           for key, shape in (("x", (m, k)), ("w", (k, n)),
                              ("x2", (m, 16 * world)),
                              ("w2", (16 * world, n)))}))
    cases.append(dict(name="forms", kind="forms", forms=FORMS))
    if world == 2:
        for role, p, x in (("generator", "g", "z"),
                           ("discriminator", "d", "img")):
            cases.append(dict(
                name=f"grad dcgan {role} 1x2", kind="grad", model="dcgan",
                scale=SCALE, role=role, mesh=(1, 2), min_bytes=0,
                batch=4, params=_t(d[p]), x=torch.tensor(d[x])))
        cases.append(dict(
            name="train 2x1", kind="train", model="dcgan", scale=SCALE,
            mesh=(2, 1), g_params=_t(d["g"]), d_params=_t(d["d"]),
            z=torch.tensor(d["z"]), real=torch.tensor(d["img"]), lr=LR,
            steps=2, fail_at=1))
        for mesh in MESHES[2]:
            cases.append(dict(
                name=f"server {mesh[0]}x{mesh[1]}", kind="server",
                model="dcgan", scale=SCALE, mesh=mesh, params=_t(d["g"]),
                batch_size=4, seed=7, requests=[6, 4, 1]))
            cases.append(dict(
                name=f"submit {mesh[0]}x{mesh[1]}", kind="server_submit",
                model="dcgan", scale=SCALE, mesh=mesh, params=_t(d["g"]),
                batch_size=4, seed=7, calls=list(SUBMIT_CALLS)))
        cases.append(dict(
            name="engine 2x1", kind="engine", model="dcgan", scale=SCALE,
            mesh=(2, 1), params=_t(d["g"]), buckets=[2, 4], seed=3,
            requests=[3, 5, 2]))
        cases.append(dict(
            name="fault engine 2x1", kind="engine_fault", model="dcgan",
            scale=SCALE, mesh=(2, 1), params=_t(d["g"]), buckets=[2],
            seed=3, requests=[2]))
        cases.append(dict(
            name="cli", kind="cli",
            argv=["dcgan", "--role", "generator", "--mesh", "1x2",
                  "--channel-scale", str(SCALE)]))
        cases += [_decode_case(inp["decode"], kvd) for kvd in ("bf16", "int8")]
        cases.append(_decode_case(inp["decode"], "bf16", "no corr"))
    else:
        cases.append(dict(
            name="grad dcgan generator 2x2", kind="grad", model="dcgan",
            scale=SCALE, role="generator", mesh=(2, 2), min_bytes=0,
            batch=4, params=_t(d["g"]), x=torch.tensor(d["z"])))
        # an unsharded checkpoint of the initial state, restored sharded
        init = os.path.join(tmp, "init_ckpt")
        tckpt.save((_t(d["g"]), _t(d["d"])), init, 0)
        cases.append(dict(
            name="train 2x2", kind="train", model="dcgan", scale=SCALE,
            mesh=(2, 2), g_params=_t(d["g"]), d_params=_t(d["d"]),
            z=torch.tensor(d["z"]), real=torch.tensor(d["img"]), lr=LR,
            steps=1, init_from=init))
    return cases


@pytest.fixture(scope="module")
def inputs():
    return dict(_inputs(), decode=_decode_inputs())


@pytest.fixture(scope="module")
def spawned(inputs, tmp_path_factory):
    """``spawned(world)``: every rank's results of that world size's
    cases, from one spawn a world size."""
    runs = {}

    def get(world):
        if world not in runs:
            tmp = str(tmp_path_factory.mktemp(f"world{world}"))
            case_file = os.path.join(tmp, "cases.pt")
            torch.save(_cases(world, inputs, tmp), case_file)
            spawn(parity.run, world, case_file, tmp, "cpu", 2,
                  device="cpu")
            runs[world] = (world, [
                torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=True) for r in range(world)])
        return runs[world]
    return get


def _each(ranks, prefix):
    world, results = ranks
    names = [k for k in results[0] if k.startswith(prefix)]
    assert names, f"no {prefix!r} case at world {world}"
    for name in names:
        yield name, [r[name] for r in results]


@pytest.fixture(scope="module")
def references(inputs):
    """The reference's unsharded outputs per (model, role)."""
    refs = {}
    for name in ("dcgan", "3dgan") + MORE_GENERATORS:
        jcfg = jgan.GanConfig(name, channel_scale=SCALE)
        for role, p, x in (("generator", "g", "z"),
                           ("discriminator", "d", "img")):
            if p not in inputs[name]:
                continue
            prog = JProgram.build(jcfg, BATCH[name], role, mesh=None)
            refs[name, role] = np.asarray(prog.apply(
                _jnp(inputs[name][p]), jnp.asarray(inputs[name][x])))
    return refs


# -- make_local_mesh -------------------------------------------------------

@pytest.fixture(scope="module")
def reference_forms():
    """The reference's forms at each device count of FORM_NS, from one
    process of 8 forced devices whose ``jax.devices`` is cut to n."""
    out = run_forced_devices(f"""
        import json
        from repro.launch import mesh as M
        every = jax.devices()
        got = {{}}
        for n in {FORM_NS!r}:
            jax.devices = lambda n=n: every[:n]
            for key, kw in {FORMS!r}.items():
                try:
                    got[f"{{n}} {{key}}"] = list(
                        M.make_local_mesh(**kw).devices.shape)
                except ValueError as e:
                    got[f"{{n}} {{key}}"] = str(e)
        print("FORMS " + json.dumps(got))
        print("PASS")
    """)
    line = next(l for l in out.stdout.splitlines() if l.startswith("FORMS "))
    return json.loads(line[len("FORMS "):])


@pytest.mark.parametrize("n", FORM_NS)
def test_mesh_shape_forms_match_the_reference(n, reference_forms):
    for key, kw in FORMS.items():
        ref = reference_forms[f"{n} {key}"]
        try:
            got = list(mesh_shape(n, **kw))
        except ValueError as e:
            got = str(e)
        assert got == ref, (n, key)
    # the documented fallback: odd counts and 1 put everything on data
    if n % 2:
        assert mesh_shape(n) == (n, 1)


@pytest.mark.parametrize("world", sorted(MESHES))
def test_make_local_mesh_forms_on_the_ranks(world, spawned, reference_forms):
    world, results = spawned(world)
    for r in results:
        for key in FORMS:
            got = r["forms"][key]
            ref = reference_forms[f"{world} {key}"]
            assert (list(got) if isinstance(got, (list, tuple))
                    else got) == ref, (world, key)


def test_launcher_runs_on_the_card_unless_asked(monkeypatch):
    """``spawn``'s ranks take the card by default: without one it raises
    before it starts a rank."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        spawn(parity.run, 2, "cases.pt", "out")
    with pytest.raises(ValueError, match="world must be"):
        spawn(parity.run, 0, device="cpu")


def test_production_mesh_shape():
    assert production_mesh_shape() == ((16, 16), ("data", "model"))
    assert production_mesh_shape(True) == ((2, 16, 16),
                                           ("pod", "data", "model"))


# -- sharded forwards, gradients -------------------------------------------

@pytest.mark.parametrize("world", sorted(MESHES))
def test_sharded_forwards_match_the_reference(world, spawned, references):
    world, results = spawned(world)
    n_cout = 0
    for name, per_rank in _each(spawned(world), "fwd "):
        _, model, role, tag = name.split()
        ref = references[model, role]
        for r, res in enumerate(per_rank):
            assert res["mesh"] == tag and res["devices"] == world
            np.testing.assert_allclose(res["out"].numpy(), ref,
                                       err_msg=f"{name} rank {r}",
                                       **FWD_TOL)
            if tag.startswith("2"):
                assert "does not divide over the data axis" in \
                    res["batch_error"]
        n_cout += per_rank[0]["shardings"].count("cout")
    assert n_cout > 0, "no layer was Cout-sharded"


def test_every_table1_generator_runs_cout_sharded(spawned):
    """At mesh (1, 2) each of the four further Table-I generators runs at
    least one layer Cout-sharded (as the reference counts ``n_cout``),
    on both ranks."""
    world, results = spawned(2)
    for name in MORE_GENERATORS:
        for r, res in enumerate(results):
            got = res[f"fwd {name} generator 1x2"]
            assert got["shardings"].count("cout") >= 1, (name, r)


@pytest.mark.parametrize("world", sorted(MESHES))
def test_cout_sharded_gradients_match_the_reference(world, spawned, inputs):
    jcfg = jgan.GanConfig("dcgan", channel_scale=SCALE)
    d = inputs["dcgan"]
    for name, per_rank in _each(spawned(world), "grad "):
        role = name.split()[2]
        p, x = (d["g"], d["z"]) if role == "generator" else (d["d"],
                                                             d["img"])
        prog = JProgram.build(jcfg, 4, role, mesh=None)

        def loss(params, inp):
            return jnp.sum(prog.forward(params, inp) ** 2)
        ref_p, ref_x = jax.grad(loss, argnums=(0, 1))(_jnp(p),
                                                      jnp.asarray(x))
        for r, res in enumerate(per_rank):
            for k, g in res["grads"].items():
                np.testing.assert_allclose(
                    g.numpy(), np.asarray(ref_p[k]),
                    err_msg=f"{name} rank {r} {k}", **GRAD_TOL)
            np.testing.assert_allclose(res["dx"].numpy(), np.asarray(ref_x),
                                       err_msg=f"{name} rank {r} dx",
                                       **GRAD_TOL)


# -- training, checkpoints -------------------------------------------------

def _reference_steps(inputs, steps):
    jcfg = jgan.GanConfig("dcgan", channel_scale=SCALE, backend="polyphase")
    d = inputs["dcgan"]
    step, _ = jax_train_step(jcfg, 4, g_lr=LR, mesh=None)
    state = (_jnp(d["g"]), _jnp(d["d"]))
    batch = {"z": jnp.asarray(d["z"]), "real": jnp.asarray(d["img"])}
    metrics = []
    for _ in range(steps):
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


@pytest.mark.parametrize("world", sorted(MESHES))
def test_dp_train_step_matches_the_reference(world, spawned, inputs):
    for name, per_rank in _each(spawned(world), "train "):
        mesh = tuple(int(v) for v in name.split()[1].split("x"))
        steps = len(per_rank[0]["metrics"])
        (g_ref, d_ref), m_ref = _reference_steps(inputs, steps)
        for r, res in enumerate(per_rank):
            assert tuple(res["mesh"]) == mesh and res["replicated"]
            for got, ref in zip(res["metrics"], m_ref):
                for k in ref:
                    np.testing.assert_allclose(got[k], ref[k], rtol=1e-4,
                                               err_msg=f"{name} {k}")
            for got, ref in ((res["g"], g_ref), (res["d"], d_ref)):
                for k, v in got.items():
                    np.testing.assert_allclose(
                        v.numpy(), np.asarray(ref[k]),
                        err_msg=f"{name} rank {r} {k}", **GRAD_TOL)
        if name == "train 2x1":
            assert [res["restarts"] for res in per_rank] == [1, 1]


@pytest.mark.parametrize("world", sorted(MESHES))
def test_sharded_checkpoint_restores_unsharded(world, spawned):
    for name, per_rank in _each(spawned(world), "train "):
        res = per_rank[0]
        d = res["ckpt_dir"]
        step = tckpt.latest_step(d)
        meta = json.loads(open(os.path.join(
            d, f"step_{step:08d}", "meta.json")).read())
        assert meta["mesh"] == list(res["mesh"])
        template = ({k: torch.zeros_like(v) for k, v in res["g"].items()},
                    {k: torch.zeros_like(v) for k, v in res["d"].items()})
        g, dd = tckpt.restore(template, d)
        for got, ref in ((g, res["g"]), (dd, res["d"])):
            for k in ref:
                assert torch.equal(got[k], ref[k]), (name, k)


# -- serving ---------------------------------------------------------------

def _port_gen(inputs):
    cfg = tgan.GanConfig("dcgan", channel_scale=SCALE)
    return cfg, _t(inputs["dcgan"]["g"])


def test_sharded_server_stream_matches_unsharded(spawned, inputs):
    cfg, g = _port_gen(inputs)
    for name, per_rank in _each(spawned(2), "server "):
        ref = GanServer(cfg, g, batch_size=4, seed=7, device="cpu")
        want = [ref.generate(n) for n in (6, 4, 1)]
        for r, res in enumerate(per_rank):
            assert res["mesh"] == name.split()[1]
            for got, exp in zip(res["images"], want):
                np.testing.assert_allclose(got.numpy(), exp.numpy(),
                                           err_msg=f"{name} rank {r}",
                                           **FWD_TOL)
        if name.endswith("2x1"):
            assert "does not divide over the program's data axis" in \
                per_rank[0]["batch_error"]


def test_sharded_server_submit_stream_matches_unsharded(spawned, inputs):
    """``submit`` on a sharded server: rank 0's answers, ``generate``
    and ``submit`` mixed, are the unsharded server's stream; a
    follower's are ``None`` once the engine took over (the ``generate``
    before it answered on every rank), and every rank's engine stopped
    at ``close`` (the spawn returned: no rank waited)."""
    cfg, g = _port_gen(inputs)
    for name, per_rank in _each(spawned(2), "submit "):
        ref = GanServer(cfg, g, batch_size=4, seed=7, device="cpu")
        want = [ref.generate(n) for _, n in SUBMIT_CALLS]
        assert [res["leader"] for res in per_rank] == [True, False]
        for got, exp in zip(per_rank[0]["images"], want):
            np.testing.assert_allclose(got.numpy(), exp.numpy(),
                                       err_msg=name, **FWD_TOL)
        first, *rest = per_rank[1]["images"]
        np.testing.assert_allclose(first.numpy(), want[0].numpy(),
                                   err_msg=name, **FWD_TOL)
        assert rest == [None] * len(rest)
        for res in per_rank:
            assert res["mesh"] == name.split()[1] and res["stopped"]


def test_sharded_engine_stream_matches_unsharded(spawned, inputs):
    cfg, g = _port_gen(inputs)
    for name, per_rank in _each(spawned(2), "engine "):
        with GanEngine(cfg, g, buckets=(2, 4), seed=3, device="cpu") as ref:
            want = [ref.submit(n).result(30) for n in (3, 5, 2)]
        assert per_rank[1]["images"] is None     # answers are rank 0's
        for got, exp in zip(per_rank[0]["images"], want):
            np.testing.assert_allclose(got.numpy(), exp.numpy(),
                                       err_msg=name, **FWD_TOL)
        for res in per_rank:
            assert "do not divide" in res["bucket_error"]


def test_engine_fault_on_rank_0_stops_every_rank(spawned):
    """Rank 0's scheduler raises: its request fails with the error, it
    broadcasts the stop first, and every rank's engine closes (the
    spawn returned, so no rank hung)."""
    for name, per_rank in _each(spawned(2), "fault engine"):
        assert "planted fault" in per_rank[0]["error"]
        assert per_rank[1]["error"] is None
        assert all(res["stopped"] for res in per_rank)


def test_program_cli_builds_sharded_programs(spawned):
    for name, per_rank in _each(spawned(2), "cli"):
        for r, res in enumerate(per_rank):
            assert "mesh=1x2" in res["stdout"]
            assert f"sharded: mesh 1x2 over 2 ranks (this rank: data 0, " \
                   f"model {r})" in res["stdout"]


# -- the ring matmuls -------------------------------------------------------

@pytest.mark.parametrize("world", sorted(MESHES))
def test_ring_matmuls_match_dense(world, spawned):
    world, results = spawned(world)
    for r, res in enumerate(results):
        got = res["ring"]
        rng = np.random.default_rng(world)
        m, k, n = 8 * world, 32, 16 * world
        x = rng.normal(size=(m, k)).astype(np.float32)
        w = rng.normal(size=(k, n)).astype(np.float32)
        x2 = rng.normal(size=(m, 16 * world)).astype(np.float32)
        w2 = rng.normal(size=(16 * world, n)).astype(np.float32)
        lo, hi = got["y_cols"]
        np.testing.assert_allclose(got["y"].numpy(), (x @ w)[:, lo:hi],
                                   atol=1e-4, rtol=1e-4, err_msg=f"rank {r}")
        lo, hi = got["y2_rows"]
        np.testing.assert_allclose(got["y2"].numpy(), (x2 @ w2)[lo:hi],
                                   atol=1e-4, rtol=1e-4, err_msg=f"rank {r}")


# -- the sequence-sharded decode -------------------------------------------

def _gathered(per_rank: list) -> dict:
    """The ranks' cache blocks, concatenated on the sequence axis in
    data-rank order."""
    return {k: (_gathered([r[k] for r in per_rank]) if isinstance(v, dict)
                else torch.cat([r[k] for r in per_rank], dim=2))
            for k, v in per_rank[0].items()}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: v})
    return out


@pytest.mark.parametrize("kvd", ["bf16", "int8"])
def test_seq_sharded_decode_matches_the_reference(kvd, spawned, inputs):
    """Each rank's logits against the reference's unsharded steps; the
    ranks' blocks, put back together, against the reference's final
    cache (int8 codes equal but for at most 0.1% off by one); each
    attention layer's output against the port's one-device attention on
    the same layer inputs; 3 collectives a layer a step, none staged on
    the CPU."""
    dec = inputs["decode"]
    ref = dec[kvd]
    per_rank = [res[f"decode {kvd} 2x1"] for res in spawned(2)[1]]
    case = _decode_case(dec, kvd)
    n_layers = dec["cfg"]["n_layers"]
    for r, res in enumerate(per_rank):
        assert res["coords"] == {"data": r, "model": 0}
        err = np.abs(res["logits"].numpy() - ref["logits"]).max()
        assert err <= DECODE_LOGITS_TOL, (r, err)
        assert len(res["attn"]) == len(res["inputs"]) \
            == n_layers * DECODE_STEPS
        want = parity.attention_oracle(case, torch.device("cpu"),
                                       res["inputs"])
        for got, w in zip(res["attn"], want):
            np.testing.assert_allclose(got.numpy(), w.numpy(),
                                       **DECODE_ATTN_TOL)
        assert res["collectives"] == 3 * n_layers * DECODE_STEPS
        assert res["staged"] == 0
    got = _flat(_gathered([res["cache"] for res in per_rank]))
    for path, want in _flat(ref["final"]).items():
        g = got[path].numpy()
        if g.dtype == np.int8:
            d = np.abs(g.astype(np.int32) - want.astype(np.int32))
            assert d.max() <= 1 and (d > 0).mean() <= 1e-3, path
        else:
            np.testing.assert_allclose(g, want, rtol=1e-5,
                                       atol=1e-5 * np.abs(want).max(),
                                       err_msg=path)


def test_seq_sharded_decode_fault_fails_the_gate(spawned, inputs):
    """The partials summed without ``corr`` (each relative to its own
    shard's max) put the logits far outside the gate on every rank."""
    ref = inputs["decode"]["bf16"]["logits"]
    for res in spawned(2)[1]:
        got = res["decode bf16 2x1 no corr"]["logits"].numpy()
        assert np.abs(got - ref).max() > 100 * DECODE_LOGITS_TOL


# -- stale tuned routes on the local Cout shard ------------------------------

def test_stale_tuned_route_dropped_on_the_local_cout_shard():
    """A plan's route that fits Cout 16 but not the local 8 of a ``"cout"``
    layer on 2 model ranks is dropped, counted ``shard_blocks``; the
    same plan keeps its route on one device."""
    from repro_torch.tune import Plan, Planner
    from repro_torch.tune.planner import PlanKey
    geo = dict(kind="tconv", in_spatial=(4, 4), kernel=(4, 4),
               strides=(2, 2), paddings=(1, 1), cin=16, cout=16)
    route = KernelRoute("tc", 1, block_n=64)
    planner = Planner(None)
    key = PlanKey(batch=4, dtype="float32", platform="cpu",
                  **tdf.Epilogue().key_fields(), **geo)
    planner.put(key, Plan(backend="ganax", route=route, source="measured",
                          measured_us=1.0))
    pol = tdf.DataflowPolicy(backend="auto")
    args = (pol, geo["kind"], geo["in_spatial"], geo["kernel"],
            geo["strides"], geo["paddings"], geo["cin"], geo["cout"])
    kw = dict(batch=4, planner=planner, platform="cpu")
    one = tdf.resolve_execution(*args, **kw)
    assert one.route == route and one.sharding == "data"
    before = obs.counter("dataflow.resolve.shard_blocks").value
    two = tdf.resolve_execution(*args, mesh_model=2, cout_shard_min_bytes=0,
                                **kw)
    assert two.sharding == "cout" and two.route is None
    assert obs.counter("dataflow.resolve.shard_blocks").value == before + 1
    # a spec refuses a route that does not fit the local shard
    cfg = tgan.GanConfig("dcgan", channel_scale=SCALE)
    spec = ProgramSpec.build(cfg, 4, mesh=(1, 2), cout_shard_min_bytes=0)
    doc = spec.to_json()
    i = next(i for i, le in enumerate(spec.layers) if le.sharding == "cout"
             and le.cout == 16)
    doc["layers"][i]["route"] = route.to_json()
    with pytest.raises(ValueError, match="on Cout 8"):
        ProgramSpec.from_json(doc)
