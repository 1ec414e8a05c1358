"""The port's GAN training against the JAX package's.

* ``Discriminator`` against ``discriminator_apply`` for all six Table-I
  models, and ``gan_losses`` / ``bce_with_logits`` against the
  reference's (atol = rtol = 1e-4, f32 on both sides);
* one and two ``make_gan_train_step`` steps of DCGAN and 3D-GAN against
  the reference's step (``backend="polyphase"``, XLA's native autodiff),
  from the same numpy parameters, latents and reals: the losses and
  every updated parameter at atol = rtol = 1e-5, and each step's
  implied gradient ``(p_before - p_after) / lr`` at 1e-4;
* ``TrainLoop``'s exact replay after an injected failure, preemption,
  and checkpoints read both ways between the packages.

Sizes: ``channel_scale = 1/32``, batch 2.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import gan as jgan
from repro.train import checkpoint as jckpt
from repro.train.loop import make_gan_train_step as jax_train_step
from repro_torch import quickstart
from repro_torch.models import gan as tgan
from repro_torch.train import checkpoint as tckpt
from repro_torch.train.loop import (LoopConfig, TrainLoop,
                                    make_gan_train_step)

SCALE = 1 / 32
BATCH = 2
CPU = torch.device("cpu")
TOL = dict(atol=1e-4, rtol=1e-4)
G_LR, D_LR = 0.05, 0.1


def _np_params(specs, rng):
    """Numpy values of the reference's spec shapes, biases non-zero."""
    return {k: ((s.scale or 1.0) * rng.normal(size=s.shape)
                if s.init == "normal" else 0.05 * rng.normal(size=s.shape)
                ).astype(np.float32)
            for k, s in sorted(specs.items())}


def _setup(name, seed=0):
    jcfg = jgan.GanConfig(name, channel_scale=SCALE, backend="polyphase")
    rng = np.random.default_rng(seed)
    g = _np_params(jgan.generator_specs(jcfg), rng)
    d = _np_params(jgan.discriminator_specs(jcfg), rng)
    first = jcfg.layers[1][0]
    batch = {"z": rng.normal(size=(BATCH, jcfg.z_dim)).astype(np.float32),
             "real": rng.uniform(-1, 1, size=(BATCH, *first.in_spatial,
                                              first.cin)).astype(np.float32)}
    return jcfg, g, d, batch


def _jnp(tree):
    return jax.tree.map(jnp.asarray, tree)


def _t(tree):
    return {k: torch.tensor(v) for k, v in tree.items()}


@pytest.mark.parametrize("name", sorted(tgan.GAN_MODELS))
def test_discriminator_matches_reference(name):
    jcfg, _, d, batch = _setup(name)
    ref = jgan.discriminator_apply(_jnp(d), jnp.asarray(batch["real"]), jcfg)
    disc = tgan.Discriminator(tgan.GanConfig(name, channel_scale=SCALE),
                              _t(d), CPU)
    assert all(p.requires_grad for p in disc.parameters())
    with torch.no_grad():
        got = disc(torch.from_numpy(batch["real"]))
    assert got.dtype == torch.float32 and tuple(got.shape) == (BATCH,)
    assert np.abs(np.asarray(ref)).max() > 1e-4       # not vacuous
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_gan_losses_match_reference():
    jcfg, g, d, batch = _setup("dcgan")
    ref = jgan.gan_losses(_jnp(g), _jnp(d), jnp.asarray(batch["z"]),
                          jnp.asarray(batch["real"]), jcfg)
    tcfg = tgan.GanConfig("dcgan", channel_scale=SCALE)
    with torch.no_grad():
        got = tgan.gan_losses(tgan.Generator(tcfg, _t(g), CPU),
                              tgan.Discriminator(tcfg, _t(d), CPU),
                              torch.from_numpy(batch["z"]),
                              torch.from_numpy(batch["real"]))
    for a, r in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), **TOL)
    logits = np.array([-40.0, -3.0, -0.5, 0.0, 0.25, 2.0, 40.0], np.float32)
    for target in (0.0, 1.0):
        np.testing.assert_allclose(
            tgan.bce_with_logits(torch.from_numpy(logits), target).numpy(),
            np.asarray(jgan.bce_with_logits(jnp.asarray(logits), target)),
            rtol=1e-6)


@functools.lru_cache(maxsize=None)
def _reference_trajectory(name):
    """The reference's states and metrics after steps 1 and 2."""
    jcfg, g, d, batch = _setup(name)
    step, _ = jax_train_step(jcfg, BATCH, g_lr=G_LR, d_lr=D_LR)
    state, out = (_jnp(g), _jnp(d)), []
    for _ in range(2):
        state, metrics = step(state, _jnp(batch))
        out.append((jax.tree.map(np.asarray, state),
                    {k: float(v) for k, v in metrics.items()}))
    return out


@pytest.mark.parametrize("steps", [1, 2])
@pytest.mark.parametrize("name", ["dcgan", "3dgan"])
def test_train_step_matches_reference(name, steps):
    ref = _reference_trajectory(name)
    jcfg, g, d, batch = _setup(name)
    train_step, (gen, disc) = make_gan_train_step(
        tgan.GanConfig(name, channel_scale=SCALE), BATCH, _t(g), _t(d),
        g_lr=G_LR, d_lr=D_LR, device=CPU)
    state = (gen.params, disc.params)
    tbatch = _t(batch)
    before = (g, d)
    for i in range(steps):
        state, metrics = train_step(state, tbatch)
        ref_state, ref_metrics = ref[i]
        for k, v in ref_metrics.items():
            np.testing.assert_allclose(float(metrics[k]), v, **TOL,
                                       err_msg=f"step {i + 1} {k}")
        for part, lr, prev, ours, theirs in zip(
                "gd", (G_LR, D_LR), before, state, ref_state):
            assert sorted(ours) == sorted(theirs)
            for k in theirs:
                p = ours[k].detach().numpy()
                np.testing.assert_allclose(
                    p, theirs[k], atol=1e-5, rtol=1e-5,
                    err_msg=f"step {i + 1} {part} {k}")
                np.testing.assert_allclose(
                    (prev[k] - p) / lr, (prev[k] - theirs[k]) / lr, **TOL,
                    err_msg=f"step {i + 1} gradient of {part} {k}")
        before = ref_state
    assert all(torch.equal(state[0][k], p) for k, p in gen.params.items())


def _loop(tmp_path, label, total_steps=6, injector=None):
    cfg = tgan.GanConfig("dcgan", channel_scale=SCALE)
    g, d = tgan.init_gan(cfg, torch.Generator().manual_seed(0), CPU)
    train_step, (gen, disc) = make_gan_train_step(cfg, BATCH, g, d,
                                                  g_lr=G_LR, device=CPU)
    logs = []
    loop = TrainLoop(LoopConfig(total_steps=total_steps,
                                ckpt_dir=str(tmp_path / label),
                                ckpt_every=2, log_every=1),
                     train_step, quickstart.make_batch_fn(cfg, BATCH, CPU),
                     (gen.params, disc.params), failure_injector=injector,
                     log_fn=logs.append)
    return loop, logs


@pytest.mark.parametrize("fail_at", [1, 3])
def test_loop_replays_exactly_after_an_injected_failure(tmp_path, fail_at):
    """A failure before the first checkpoint restarts from the step-0
    parameters; a later one from the latest checkpoint.  Either way the
    run ends in the uninterrupted run's state, bit for bit."""
    clean, _ = _loop(tmp_path, "clean")
    clean_state = clean.run()
    fired = []

    def injector(step):
        if step == fail_at and not fired:
            fired.append(step)
            return True
        return False

    loop, logs = _loop(tmp_path, "faulty", injector=injector)
    state = loop.run()
    assert fired == [fail_at] and loop.restarts == 1
    assert any("FAILURE" in line for line in logs)
    assert loop.steps == 6 + (fail_at - 2 * (fail_at // 2))
    for ours, theirs in zip(state, clean_state):
        for k in theirs:
            assert torch.equal(ours[k], theirs[k]), k
    assert tckpt.all_steps(loop.cfg.ckpt_dir) == [2, 4, 6]
    restored = tckpt.restore(state, loop.cfg.ckpt_dir)
    for ours, theirs in zip(restored, clean_state):
        for k in theirs:
            assert torch.equal(ours[k], theirs[k]), k


def test_loop_checkpoints_and_stops_on_preemption(tmp_path):
    loop, logs = _loop(tmp_path, "preempt")

    def preempt_at_3(step):
        if step == 3:
            loop._preempted = True      # what the SIGTERM handler sets
        return False

    loop.failure_injector = preempt_at_3
    loop.run()
    assert loop.steps == 4 and any("SIGTERM" in line for line in logs)
    assert tckpt.latest_step(loop.cfg.ckpt_dir) == 4


def _states(name="dcgan"):
    jcfg, g, d, _ = _setup(name)
    return (g, d), ((_t(g), _t(d)))


@pytest.mark.parametrize("direction", ["reference_to_port",
                                       "port_to_reference"])
def test_checkpoints_read_both_ways(tmp_path, direction):
    (g, d), torch_state = _states()
    if direction == "reference_to_port":
        jckpt.save((_jnp(g), _jnp(d)), str(tmp_path), 7)
        template = jax.tree.map(torch.zeros_like, torch_state)
        restored = tckpt.restore(template, str(tmp_path))
        restored = jax.tree.map(lambda t: t.numpy(), restored)
    else:
        tckpt.save_async(torch_state, str(tmp_path), 7)
        tckpt.wait_pending()
        template = jax.tree.map(jnp.zeros_like, (_jnp(g), _jnp(d)))
        restored = jax.tree.map(np.asarray,
                                jckpt.restore(template, str(tmp_path)))
    with open(tmp_path / "step_00000007" / "meta.json") as f:
        keys = sorted(json.load(f)["keys"])
    assert keys == sorted([f"0::{k}" for k in g] + [f"1::{k}" for k in d])
    for ours, theirs in zip(restored, (g, d)):
        for k in theirs:
            np.testing.assert_array_equal(ours[k], theirs[k])


def test_quickstart_trains_and_serves_on_the_cpu(capsys):
    quickstart.main(["--device", "cpu", "--steps", "2", "--batch", "2",
                     "--channel-scale", str(SCALE)])
    out = capsys.readouterr().out
    assert "done: 2 adversarial steps through the ganax dataflow" in out
    assert "served 3 samples (64, 64, 3)" in out


def test_synthetic_reals_are_a_pure_function_of_the_step():
    cfg = tgan.GanConfig("3dgan", channel_scale=SCALE)
    batch_fn = quickstart.make_batch_fn(cfg, 2, CPU)
    a, b, c = batch_fn(5), batch_fn(5), batch_fn(6)
    assert tuple(a["real"].shape) == (2, 64, 64, 64, 1)
    assert tuple(a["z"].shape) == (2, 100)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["real"], c["real"])
    assert 0.0 <= float(a["real"].min()) and float(a["real"].max()) <= 1.0


def test_train_step_refuses_a_foreign_state():
    cfg = tgan.GanConfig("dcgan", channel_scale=SCALE)
    g, d = tgan.init_gan(cfg, torch.Generator().manual_seed(0), CPU)
    train_step, (gen, disc) = make_gan_train_step(cfg, BATCH, g, d,
                                                  device=CPU)
    batch = quickstart.make_batch_fn(cfg, BATCH, CPU)(0)
    copies = ({k: v.clone() for k, v in gen.params.items()}, disc.params)
    with pytest.raises(ValueError, match="own parameters"):
        train_step(copies, batch)
    with pytest.raises(ValueError, match="built for batch 2"):
        train_step((gen.params, disc.params),
                   {k: v[:1] for k, v in batch.items()})


def _train_records(obs, run):
    """``run()`` with obs tracing on: the ``train.*`` counter deltas, the
    ``train.*`` gauge names and the events (step attributes only)."""
    before = obs.snapshot()["counters"]
    sink = obs.enable()
    try:
        run()
    finally:
        obs.disable()
    snap = obs.snapshot()
    counters = {k: v - before.get(k, 0) for k, v in snap["counters"].items()
                if k.startswith("train.") and v - before.get(k, 0)}
    gauges = sorted(k for k in snap["gauges"] if k.startswith("train."))
    events = [(e["name"], e["attrs"].get("step")) for e in sink.events()]
    steps = len(sink.spans("train.step"))
    return counters, gauges, events, steps, \
        obs.histogram("train.step_us").count


def test_loop_records_the_reference_train_metrics(tmp_path):
    """The same step count, checkpoint cadence and injected failure give
    the reference's ``train.*`` counters, gauges and events."""
    import repro.obs as jobs
    import repro_torch.obs as tobs
    from repro.train.loop import LoopConfig as JLoopConfig
    from repro.train.loop import TrainLoop as JTrainLoop

    def injector_at(step_no):
        fired = []

        def injector(step):
            if step == step_no and not fired:
                fired.append(step)
                return True
            return False
        return injector

    def jax_step(state, batch):
        state = jax.tree.map(lambda a: a - 0.1 * batch["z"].mean(), state)
        loss = jnp.sum(state["w"])
        return state, {"g_loss": loss, "d_loss": loss, "loss": 2 * loss}

    # the gauge names are read off the process-wide registries: an LLM
    # TrainLoop of another file in this worker (the CLIs' tests) leaves
    # its own train.* gauges there, so both registries start empty here
    jobs.registry.reset()
    tobs.registry.reset()

    ref_loop = JTrainLoop(
        JLoopConfig(total_steps=6, ckpt_dir=str(tmp_path / "ref"),
                    ckpt_every=2, log_every=1, straggler_factor=1e9),
        jax_step, lambda step: {"z": jnp.full((2,), float(step))},
        {"w": jnp.zeros((3,))}, failure_injector=injector_at(3),
        log_fn=lambda line: None)
    loop, logs = _loop(tmp_path, "port", injector=injector_at(3))
    loop.cfg.straggler_factor = 1e9
    hist0 = (jobs.histogram("train.step_us").count,
             tobs.histogram("train.step_us").count)
    ref = _train_records(jobs, ref_loop.run)
    got = _train_records(tobs, loop.run)
    assert got[:4] == ref[:4]
    assert got[0] == {"train.steps": 7, "train.checkpoints": 3,
                      "train.failures": 1}
    assert (got[4] - hist0[1], ref[4] - hist0[0]) == (7, 7)
    assert any("dataflow μop cache" in line for line in logs)
