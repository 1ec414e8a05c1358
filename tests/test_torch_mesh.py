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
  Cout shard (``dataflow.resolve.shard_blocks``), in this process;
* the dense transformer on a mesh, each case against the reference's
  unsharded results on the same numpy parameters and batches:
  - the reference's own mesh config (``tests/test_distributed.py``'s
    Gemma3: 3 layers, d 64, 4 q over 2 kv heads of 16, window 8,
    pattern (2, 1), vocab 512) in f32, batch 8 x 32: two train steps
    with the ``build_cell`` shardings (``Rules(fsdp=True)`` masters, a
    tensor-parallel compute copy) at (2, 1) (through ``TrainLoop``,
    with a failure that makes every rank restore the checkpoint rank 0
    wrote), (1, 2) and (2, 2), and ``grad_accum=2`` at (2, 1): loss,
    ``grad_norm`` and each leaf's update at ``LM_TRAIN_TOL``, against
    one jitted reference step a ``grad_accum``; the same two steps at
    world 4 on the ``(pod, data, model)`` meshes (2, 1, 2) and (2, 2, 1)
    (the batch over pod and data, the gradients averaged over the pods),
    and OLMoE's at (2, 2, 1), its routing groups spanning the pods;
  - a tiny HuBERT, one step at (2, 1), the ranks' label masks holding
    different counts (the loss over the global count);
  - ``tiny(qwen1.5-32b, float32, n_kv_heads=4)`` (vocab 97, padded to
    256: the padding on the last model rank only): the TP prefill's
    logits and cache at (1, 2); the batch-sharded decode at (2, 1) and
    the TP decode at (1, 2) and (2, 2), bf16 and int8 caches, against
    the decode reference above;
  - the Gemma3 under ``seq_shard_decode`` at (2, 1), one slot's window
    on each rank only (lengths 13 and 50 of 64 rows);
  - the reshard: the (2, 2) state saved after its step, restored at
    (1, 2) and (2, 1) by the world-2 ranks and on one device here, equal
    bit for bit, and the next step against the reference's from the
    restored state;
  - the planted faults (``parity.FAULTS``): ``wo``'s partials not summed
    over ``model``, the norm of the rank's blocks only, the gradients
    summed over ``data``, each pod's gradients not averaged over the
    pods (at (2, 1, 2)), each far above the gate;
  - in this process: an SSM head split over ``model`` raises
    ``ValueError``, ``make_batch_fn(shardings=...)`` cuts each rank's
    rows, ``init_cache`` on a mesh gives each rank its blocks;
* MLA, MoE, SSM and hybrid layers on a mesh, at world 2: the tiny
  presets (``reduced_config(..., "tiny")``, f32) of MiniCPM3-4B,
  OLMoE-1B-7B, Llama-4-Scout, Mamba2-2.7B and Hymba-1.5B (its attention
  at 5 q heads over 1 kv head, so that 2 ranks pad them as the
  reference's ``_pad_heads_even``, and one windowed layer), each against
  the reference's unsharded results on the same numpy parameters (one
  jitted reference step a config, run in a thread beside the spawns):
  two train steps at (2, 1) and (1, 2) (loss, ``grad_norm`` and each
  leaf's update at ``LM_TRAIN_TOL``, ``aux_lb``/``aux_z`` at
  ``AUX_TOL``; OLMoE's routing groups span the data ranks, Scout's do
  not), each MoE layer's routing bit for bit the port's one-device
  routing, the TP prefill's logits and cache blocks at (1, 2), the
  batch-sharded and TP decode's logits and caches, MLA's and Hymba's
  ``seq_shard_decode`` at 2e-5; the padded heads' layout against the
  reference's ``_pad_heads_even``; the item's planted faults (the MoE
  combine not summed, ``q_norm``'s RMS over half of ``q_lora``, the SSM
  norm over half of ``d_inner``, ``aux_lb`` as the mean of the ranks'
  products, the pad head kept) far above their gates.

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
from repro.train import optimizer as jopt
from repro.train import train_state as jts
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
from repro_torch.data import pipeline as tpipe
from repro_torch.launch import train as tlaunch
from repro_torch.models import transformer as ttr
from repro_torch.sharding import rules as trules

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
# The dense transformer on a mesh.  The reference's mesh config
# (tests/test_distributed.py:79-82), f32; batch LM_BATCH; AdamW with a
# clip that binds (the first step's gradient norm is ~17) and an eps of
# 1e-3, above the clipped gradients' rounding: at 1e-8 Adam's first
# steps turn a gradient element at rounding level into a +-lr step,
# which no tolerance on the parameters holds.  Each leaf's update (state
# after the steps minus before) against the reference's, ||a - b|| /
# ||b|| <= LM_TRAIN_TOL, and loss and grad_norm at rtol LM_TRAIN_TOL:
# the f32 checks' 1e-4.
LM_BATCH = (8, 32)
LM_OPT = dict(peak_lr=1e-2, warmup_steps=2, total_steps=10, grad_clip=0.5,
              eps=1e-3)
LM_TRAIN_TOL = 1e-4
LM_TRAIN_MESHES = {2: ((2, 1), (1, 2)), 4: ((2, 2),)}
# the (pod, data, model) meshes of world 4: the multi-pod mesh's axes
LM_POD_MESHES = ((2, 1, 2), (2, 2, 1))
# the seq-sharded decode of the windowed Gemma3: rows a slot, filled
# steps, the slots' lengths (window 8: 6..13 on rank 0, 43..50 on rank 1)
SWA_T, SWA_FILL, SWA_LENS = 64, 50, (13, 50)
# MLA, MoE, SSM and hybrid layers on a mesh: the configs, their train
# batches (OLMoE's 128 tokens are one routing group across the data
# ranks; Scout's 512 two groups, one a rank), the prompts prefilled into
# FAM_T rows a slot and decoded DECODE_STEPS steps, the aux losses'
# relative tolerance, and each planted fault's config, mesh and the
# factor over its gate it must reach (the dense transformer's three:
# 100; the other layers' faults on the tiny presets: 4, the chip phase's
# ratio: q_norm's halves have nearly the whole's RMS at this width)
FAMILIES = ("minicpm3-4b", "olmoe-1b-7b", "llama4-scout-17b-a16e",
            "mamba2-2.7b", "hymba-1.5b")
FAM_BATCH = {"olmoe-1b-7b": (4, 32), "llama4-scout-17b-a16e": (8, 64)}
FAM_PROMPT, FAM_T = (2, 24), 32
AUX_TOL = 1e-6
FAM_SEQ = ("minicpm3-4b", "hymba-1.5b")
FAULT_CASES = {"wo not summed": ("g3", (1, 2), 100),
               "local norm": ("g3", (1, 2), 100),
               "grads summed": ("g3", (2, 1), 100),
               "pods not averaged": ("g3", (2, 1, 2), 100),
               "moe combine not summed": ("olmoe-1b-7b", (1, 2), 4),
               "aux_lb mean of products": ("olmoe-1b-7b", (2, 1), 4),
               "q_norm over a half": ("minicpm3-4b", (1, 2), 4),
               "ssm norm over a half": ("mamba2-2.7b", (1, 2), 4),
               "pad head kept": ("hymba-1.5b", (1, 2), 4)}


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


def _g3_cfg():
    """The reference's own mesh config (tests/test_distributed.py), f32."""
    return dataclasses.replace(
        jbase.get_config("gemma3-4b"), n_layers=3, d_model=64, d_ff=128,
        vocab=512, n_heads=4, n_kv_heads=2, head_dim=16, local_window=8,
        local_global_pattern=(2, 1), dtype="float32")


def _np_lm_params(jcfg, seed=0) -> dict:
    """Numpy parameters of the reference's spec tree, drawn as
    ``parity.condition`` leaves the reference's init (at that init the
    logits saturate the softmax and a last-bit change of the forward, as
    a row-parallel sum makes, moves the gradients by 1e-4 of their
    norm): a stacked matrix at its input width's ``**-0.5``, the
    embedding at ``d_model**-0.5``, the other matrices at the
    reference's fan-in scale; norm scales off their zero init, biases
    zero."""
    from repro.models.common import PSpec
    rng = np.random.default_rng(seed + 100)

    def leaf(path, spec):
        shape, name = spec.shape, getattr(path[-1], "key", "")
        if spec.init == "zeros":
            scale = 0.1 if name in ("ln_mix", "ln_mlp", "final_norm") \
                else 0.0
        elif spec.init == "embed":
            scale = jcfg.d_model ** -0.5
        elif len(shape) >= 3:
            scale = shape[-2] ** -0.5
        else:
            scale = spec.scale or shape[0] ** -0.5
        return (scale * rng.normal(size=shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(
        leaf, jtr.model_specs(jcfg), is_leaf=lambda x: isinstance(x, PSpec))


@functools.lru_cache(maxsize=None)
def _jit_train_step(jcfg, accum: int):
    return jax.jit(jts.make_train_step(jcfg, jopt.AdamWConfig(**LM_OPT),
                                       jtr.RunFlags(remat=False),
                                       grad_accum=accum))


def _ref_steps(jcfg, np_state: dict, batches: list, accum: int = 1):
    """The reference's unsharded steps from ``np_state``: the final state
    (numpy) and each step's metrics."""
    step = _jit_train_step(jcfg, accum)
    state = jax.tree.map(jnp.asarray, np_state)
    metrics = []
    for b in batches:
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    return jax.tree.map(np.asarray, state), metrics


def _np_state(params: dict) -> dict:
    zeros = jax.tree.map(np.zeros_like, params)
    return {"params": params, "opt": {"mu": zeros, "nu": zeros,
                                      "count": np.zeros((), np.int32)},
            "step": np.zeros((), np.int32)}


def _accum(batch: dict, accum: int) -> dict:
    return {k: v.reshape(accum, v.shape[0] // accum, *v.shape[1:])
            for k, v in batch.items()} if accum > 1 else batch


def _lm_inputs():
    """The dense-mesh cases' configs, numpy parameters and batches, and
    the reference's unsharded results: the Gemma3 train steps (one jit a
    grad_accum), a HuBERT step, the Qwen prefill and the Gemma3's
    windowed decode."""
    g3 = _g3_cfg()
    rng = np.random.default_rng(31)
    g3_params = _np_lm_params(g3)
    batches = [{"tokens": rng.integers(0, g3.vocab, LM_BATCH)
                .astype(np.int32)} for _ in range(3)]
    train = {accum: _ref_steps(g3, _np_state(g3_params),
                               [_accum(b, accum) for b in batches[:2]],
                               accum) for accum in (1, 2)}
    hub = tiny(jbase.get_config("hubert-xlarge"), dtype="float32",
               frontend_dim=32)
    hub_params = _np_lm_params(hub, seed=1)
    mask = np.zeros((4, 16), np.float32)
    mask[:2] = rng.uniform(size=(2, 16)) < 0.9     # rank 0's rows: many
    mask[2:, :3] = 1.0                              # rank 1's rows: few
    hub_batch = {"features": rng.normal(size=(4, 16, 32)).astype(np.float32),
                 "labels": rng.integers(0, hub.vocab, (4, 16))
                 .astype(np.int32), "label_mask": mask}
    hub_ref = _ref_steps(hub, _np_state(hub_params), [hub_batch])
    qwen = tiny(jbase.get_config("qwen1.5-32b"), dtype="float32",
                n_kv_heads=4)
    q_params = jax.tree.map(np.asarray, jtr.init(qwen,
                                                 jax.random.PRNGKey(0)))
    q_tokens = rng.integers(0, qwen.vocab, (2, 24)).astype(np.int32)
    logits, cache, _ = jtr.forward(jax.tree.map(jnp.asarray, q_params),
                                   {"tokens": jnp.asarray(q_tokens)}, qwen,
                                   mode="prefill")
    # kv heads that do not divide the model axis: 4 q heads of 10 over 1
    # kv head, at (1, 4) the kv projections fall back to replication (10
    # columns over 4 ranks) while the q heads split
    kvrep = tiny(jbase.get_config("gemma-7b"), dtype="float32", n_heads=4,
                 n_kv_heads=1, head_dim=10)
    kvrep_params = _np_lm_params(kvrep, seed=3)
    kvrep_batch = {"tokens": rng.integers(0, kvrep.vocab, (4, 16))
                   .astype(np.int32)}
    kvrep_ref = _ref_steps(kvrep, _np_state(kvrep_params), [kvrep_batch])
    # the VLM's image prefix through replicated img_proj, then the TP
    # layers and the vocab split
    vlm = tiny(jbase.get_config("internvl2-26b"), dtype="float32",
               frontend_dim=32)
    vlm_params = _np_lm_params(vlm, seed=2)
    vlm_batch = {"tokens": rng.integers(0, vlm.vocab, (2, 24))
                 .astype(np.int32),
                 "img_embeds": rng.normal(size=(2, vlm.img_tokens, 32))
                 .astype(np.float32)}
    vlm_logits = np.asarray(jtr.forward(
        jax.tree.map(jnp.asarray, vlm_params),
        {k: jnp.asarray(v) for k, v in vlm_batch.items()}, vlm,
        mode="prefill")[0])
    # the windowed Gemma3's decode: a cache of SWA_T rows holding the
    # prefill of SWA_FILL tokens, then DECODE_STEPS from SWA_LENS
    dstep = jax.jit(functools.partial(jtr.decode_step, cfg=g3))
    jparams = jax.tree.map(jnp.asarray, g3_params)
    fill = rng.integers(0, g3.vocab, (2, SWA_FILL))
    _, pcache, _ = jtr.forward(jparams, {"tokens": jnp.asarray(fill)}, g3,
                               mode="prefill")
    filled = jax.tree.map(lambda a: np.pad(np.asarray(a), [(0, 0)] * 2 + [
        (0, SWA_T - SWA_FILL)] + [(0, 0)] * (a.ndim - 3)), pcache)
    dcache = jax.tree.map(jnp.asarray, filled)
    swa_toks = rng.integers(0, g3.vocab, (DECODE_STEPS, 2, 1))
    swa_logits = []
    for i in range(DECODE_STEPS):
        lg, dcache = dstep(jparams, dcache, jnp.asarray(swa_toks[i]),
                           jnp.asarray(SWA_LENS) + i)
        swa_logits.append(np.asarray(lg))
    return dict(
        g3=g3, g3_params=g3_params, batches=batches, train=train, hub=hub,
        hub_params=hub_params, hub_batch=hub_batch, hub_ref=hub_ref,
        qwen=qwen, q_params=q_params, q_tokens=q_tokens,
        q_logits=np.asarray(logits), q_cache=jax.tree.map(np.asarray, cache),
        vlm=vlm, vlm_params=vlm_params, vlm_batch=vlm_batch,
        kvrep=kvrep, kvrep_params=kvrep_params, kvrep_batch=kvrep_batch,
        kvrep_ref=kvrep_ref,
        vlm_logits=vlm_logits,
        swa_cache=filled, swa_tokens=swa_toks,
        swa_logits=np.stack(swa_logits))


def _fam_cfg(name: str):
    """The family's tiny preset in f32 (Hymba's attention at 5 q heads
    over 1 kv head, its second layer windowed)."""
    from repro.launch.train import reduced_config
    jcfg = dataclasses.replace(reduced_config(name, "tiny"), dtype="float32")
    if name == "hymba-1.5b":
        jcfg = dataclasses.replace(jcfg, n_heads=5, n_kv_heads=1,
                                   global_layers=(0,), local_window=8)
    return jcfg


def _padded_cache(cache: dict, rows: int) -> dict:
    """A prefill's cache with its sequence leaves (k, v, their scales,
    ckv, krope) zero-padded to ``rows``; the SSM state as it is."""
    return {k: (_padded_cache(v, rows) if isinstance(v, dict) else
                np.asarray(v) if k in ("h", "conv") else np.pad(
                    np.asarray(v), [(0, 0), (0, 0),
                                    (0, rows - v.shape[2])]
                    + [(0, 0)] * (v.ndim - 3)))
            for k, v in cache.items()}


def _fam_refs(fam: dict) -> dict:
    """The reference's unsharded results of the families' cases: two
    train steps, the prefill's logits and cache, and DECODE_STEPS decode
    steps from the prefill's cache (their logits and final cache)."""
    out = {}
    for name, f in fam.items():
        jcfg = f["jcfg"]
        state, metrics = _ref_steps(jcfg, _np_state(f["params"]),
                                    f["batches"])
        jparams = jax.tree.map(jnp.asarray, f["params"])
        logits, cache, _ = jtr.forward(jparams, {"tokens": jnp.asarray(
            f["prompt"])}, jcfg, mode="prefill")
        filled = _padded_cache(jax.tree.map(np.asarray, cache), FAM_T)
        step = jax.jit(functools.partial(jtr.decode_step, cfg=jcfg))
        dcache = jax.tree.map(jnp.asarray, filled)
        dlogits = []
        for i in range(DECODE_STEPS):
            lg, dcache = step(jparams, dcache, jnp.asarray(f["dtokens"][i]),
                              jnp.full((FAM_PROMPT[0],), FAM_PROMPT[1] + i,
                                       jnp.int32))
            dlogits.append(np.asarray(lg))
        out[name] = dict(state=state, metrics=metrics,
                         logits=np.asarray(logits),
                         cache=jax.tree.map(np.asarray, cache), filled=filled,
                         dlogits=np.stack(dlogits),
                         final=jax.tree.map(np.asarray, dcache))
    return out


def _fam_inputs() -> dict:
    """Per family: its config, numpy parameters (``_np_lm_params``),
    train batches, prompt and decode tokens; ``"refs"`` joins the thread
    that computes the reference's results (:func:`_fam_refs`) beside the
    spawns."""
    import threading
    rng = np.random.default_rng(32)
    fam = {}
    for i, name in enumerate(FAMILIES):
        jcfg = _fam_cfg(name)
        fam[name] = dict(
            jcfg=jcfg, params=_np_lm_params(jcfg, seed=10 + i),
            batches=[{"tokens": rng.integers(0, jcfg.vocab, FAM_BATCH.get(
                name, LM_BATCH)).astype(np.int32)} for _ in range(2)],
            prompt=rng.integers(0, jcfg.vocab, FAM_PROMPT).astype(np.int32),
            dtokens=rng.integers(0, jcfg.vocab,
                                 (DECODE_STEPS, FAM_PROMPT[0], 1)))
    got: dict = {}

    def work():
        try:
            got["refs"] = _fam_refs(fam)
        except BaseException as e:      # raised again by refs()
            got["error"] = e
    thread = threading.Thread(target=work, daemon=True)
    thread.start()

    def refs() -> dict:
        thread.join()
        if "error" in got:
            raise got["error"]
        return got["refs"]
    return {"fam": fam, "refs": refs}


def _fam_cases(inp: dict, tmp) -> list:
    """The families' world-2 cases (module docstring)."""
    fam = inp["fam"]["fam"]
    refs = None
    cases = []
    for name, f in fam.items():
        jcfg = f["jcfg"]
        for mesh in ((2, 1), (1, 2)):
            cases.append(_lm_train_case(
                inp["lm"], f"fam train {name} {mesh[0]}x{mesh[1]}", mesh,
                tmp, jcfg=jcfg, params=f["params"], batches=f["batches"]))
        tcfg = tbase.ArchConfig(**dataclasses.asdict(jcfg))
        cases.append(dict(name=f"fam prefill {name} 1x2", kind="lm_prefill",
                          mesh=(1, 2), cfg=dataclasses.asdict(jcfg),
                          params=_tparams(f["params"], jcfg),
                          tokens=torch.tensor(f["prompt"])))
        if refs is None:
            refs = inp["fam"]["refs"]()      # the caches to decode from
        cache = cache_from_jax(refs[name]["filled"], tcfg, "cpu")
        for mesh, seq in (((2, 1), False), ((1, 2), False), ((2, 1), True)):
            if seq and name not in FAM_SEQ:
                continue
            cases.append(dict(
                name=f"fam decode {name} {mesh[0]}x{mesh[1]}"
                     + (" seq" if seq else ""),
                kind="lm_decode", mesh=mesh, seq_shard=seq,
                cfg=dataclasses.asdict(jcfg),
                params=_tparams(f["params"], jcfg), cache=cache,
                tokens=torch.tensor(f["dtokens"]),
                lengths=torch.full((FAM_PROMPT[0],), FAM_PROMPT[1])))
    for fault, (name, mesh, _) in FAULT_CASES.items():
        if name in fam:
            f = fam[name]
            cases.append(_lm_train_case(
                inp["lm"], f"lm fault {fault}", mesh, tmp, jcfg=f["jcfg"],
                params=f["params"], batches=f["batches"][:1], fault=fault,
                return_state=False))
    return cases


def _tparams(np_params, jcfg):
    return lm_params_from_jax(np_params, tbase.ArchConfig(
        **dataclasses.asdict(jcfg)), "cpu", torch.float32)


def _lm_train_case(lm, name, mesh, tmp, **over):
    accum = over.get("grad_accum", 1)
    jcfg = over.pop("jcfg", lm["g3"])
    params = over.pop("params", lm["g3_params"])
    batches = over.pop("batches", lm["batches"][:2])
    return dict(dict(
        name=name, kind="lm_train", mesh=mesh,
        cfg=dataclasses.asdict(jcfg), params=_tparams(params, jcfg),
        batches=[{k: torch.tensor(v) for k, v in _accum(b, accum).items()}
                 for b in batches], opt=dict(LM_OPT), return_state=True,
        ckpt_dir=os.path.join(tmp, name.replace(" ", "_"))), **over)


def _lm_cases(world: int, inp: dict, tmp, saved: str | None) -> list:
    lm = inp["lm"]
    cases = []
    for mesh in LM_TRAIN_MESHES[world]:
        tag = f"{mesh[0]}x{mesh[1]}"
        over = dict(ckpt_every=1, fail_at=1) if mesh == (2, 1) else {}
        if world == 4:
            over["save_dir"] = os.path.join(tmp, "lm_saved")
        cases.append(_lm_train_case(lm, f"lm train {tag}", mesh, tmp,
                                    **over))
    dec = inp["decode"]
    qcfg = tbase.ArchConfig(**dec["cfg"])
    for mesh in ((2, 1), (1, 2)) if world == 2 else ((2, 2),):
        for kvd in ("bf16", "int8"):
            cases.append(dict(
                name=f"lm decode {kvd} {mesh[0]}x{mesh[1]}",
                kind="lm_decode", mesh=mesh, seq_shard=False,
                cfg=dec["cfg"], params=lm_params_from_jax(
                    dec["params"], qcfg, "cpu", torch.float32),
                cache=cache_from_jax(dec[kvd]["cache"], qcfg, "cpu"),
                tokens=torch.tensor(dec["tokens"]),
                lengths=torch.tensor(DECODE_LENS)))
    if world == 4:
        cases.append(_lm_train_case(
            lm, "lm train kv replicated 1x4", (1, 4), tmp, jcfg=lm["kvrep"],
            params=lm["kvrep_params"], batches=[lm["kvrep_batch"]]))
        for mesh in LM_POD_MESHES:
            cases.append(_lm_train_case(
                lm, "lm train pod " + "x".join(map(str, mesh)), mesh, tmp))
        f = inp["fam"]["fam"]["olmoe-1b-7b"]
        cases.append(_lm_train_case(
            lm, "fam train olmoe-1b-7b pod 2x2x1", (2, 2, 1), tmp,
            jcfg=f["jcfg"], params=f["params"], batches=f["batches"]))
    for fault, (name, mesh, _) in FAULT_CASES.items():
        if name == "g3" and (len(mesh) == 3) == (world == 4):
            cases.append(_lm_train_case(
                lm, f"lm fault {fault}", mesh, tmp, fault=fault,
                batches=lm["batches"][:1], return_state=False))
    if world == 4:
        return cases
    cases.append(_lm_train_case(lm, "lm train accum2 2x1", (2, 1), tmp,
                                grad_accum=2))
    cases.append(_lm_train_case(
        lm, "lm train hubert 2x1", (2, 1), tmp, jcfg=lm["hub"],
        params=lm["hub_params"], batches=[lm["hub_batch"]]))
    cases += _fam_cases(inp, tmp)
    qwen = lm["qwen"]
    cases.append(dict(
        name="lm prefill 1x2", kind="lm_prefill", mesh=(1, 2),
        cfg=dataclasses.asdict(qwen),
        params=_tparams(lm["q_params"], qwen),
        tokens=torch.tensor(lm["q_tokens"])))
    cases.append(dict(
        name="lm prefill vlm 1x2", kind="lm_prefill", mesh=(1, 2),
        cfg=dataclasses.asdict(lm["vlm"]),
        params=_tparams(lm["vlm_params"], lm["vlm"]),
        tokens=torch.tensor(lm["vlm_batch"]["tokens"]),
        extra={"img_embeds": torch.tensor(lm["vlm_batch"]["img_embeds"])}))
    g3 = tbase.ArchConfig(**dataclasses.asdict(lm["g3"]))
    cases.append(dict(
        name="lm swa decode 2x1", kind="decode", mesh=(2, 1),
        cfg=dataclasses.asdict(lm["g3"]),
        params=_tparams(lm["g3_params"], lm["g3"]),
        cache=cache_from_jax(lm["swa_cache"], g3, "cpu"),
        tokens=torch.tensor(lm["swa_tokens"]),
        lengths=torch.tensor(SWA_LENS)))
    for mesh in ((1, 2), (2, 1)):
        case = _lm_train_case(lm, f"lm reshard {mesh[0]}x{mesh[1]}", mesh,
                              tmp, batches=lm["batches"])
        case.update(kind="reshard", from_dir=saved)
        cases.append(case)
    return cases


def _cases(world: int, inp: dict, tmp, saved: str | None = None
           ) -> list[dict]:
    cases = _lm_cases(world, inp, tmp, saved)
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
    fam = _fam_inputs()        # its references in a thread from here on
    return dict(_inputs(), decode=_decode_inputs(), lm=_lm_inputs(),
                fam=fam)


@pytest.fixture(scope="module")
def spawned(inputs, tmp_path_factory):
    """``spawned(world)``: every rank's results of that world size's
    cases, from one spawn a world size."""
    runs, dirs = {}, {}

    def get(world):
        if world not in runs:
            # world 2 restores the state world 4 saved (the reshard)
            saved = os.path.join(get(4) and dirs[4], "lm_saved") \
                if world == 2 else None
            tmp = dirs[world] = str(tmp_path_factory.mktemp(f"world{world}"))
            case_file = os.path.join(tmp, "cases.pt")
            torch.save(_cases(world, inputs, tmp, saved), case_file)
            spawn(parity.run, world, case_file, tmp, "cpu", 2,
                  device="cpu")
            runs[world] = (world, [
                torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=True) for r in range(world)])
        return runs[world]
    get.dirs = dirs
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


# -- the dense transformer on a mesh ---------------------------------------

class _Place:
    """One rank's place on a ``(data, model)`` mesh, as the port reads a
    ``DeviceMesh`` (axis names, sizes, this rank's index): the ranks of a
    mesh emulated in this process."""

    mesh_dim_names = ("data", "model")

    def __init__(self, shape, data, model):
        self.shape, self._at = tuple(shape), {"data": data, "model": model}

    def get_local_rank(self, axis):
        return self._at[axis]


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def _check_lm_state(got: dict, before: dict, want: dict, what: str) -> None:
    """Each leaf's update ``got - before`` against ``want - before`` (the
    reference's) at LM_TRAIN_TOL of its norm, params and both moments;
    the counters equal."""
    for part in ("params", "mu", "nu"):
        g = got["params"] if part == "params" else got["opt"][part]
        w = want["params"] if part == "params" else want["opt"][part]
        b = before["params"] if part == "params" else before["opt"][part]
        for (path, t), wl, bl in zip(tckpt.tree_items(g).items(),
                                     jax.tree.leaves(w), jax.tree.leaves(b)):
            rel = _rel(t.numpy() - bl, np.asarray(wl) - bl)
            assert rel <= LM_TRAIN_TOL, (what, part, path, rel)
    assert int(got["step"]) == int(want["step"])
    assert int(got["opt"]["count"]) == int(want["opt"]["count"])


def _check_metrics(got: list, want: list, what: str) -> float:
    rel = {(i, k): abs(g[k] - w[k]) / abs(w[k])
           for i, (g, w) in enumerate(zip(got, want, strict=True))
           for k in ("loss", "grad_norm", "total_loss", "lr", "tokens")}
    assert max(rel.values()) <= LM_TRAIN_TOL, (what, rel)
    return max(rel.values())


@pytest.mark.parametrize("world,name", [
    (2, "lm train 2x1"), (2, "lm train 1x2"), (4, "lm train 2x2"),
    (2, "lm train accum2 2x1"), (4, "lm train pod 2x1x2"),
    (4, "lm train pod 2x2x1")])
def test_lm_train_steps_match_the_reference(world, name, spawned, inputs):
    """Two steps with the build_cell shardings, every rank's gathered
    state and metrics against the reference's unsharded steps from the
    same state; at (2, 1) through TrainLoop with one injected failure,
    every rank restoring the checkpoint rank 0 wrote.  On the (pod,
    data, model) meshes the batch splits over (pod, data), pod-major as
    ``batch_sharding`` cuts it, the gradients are averaged over the pods
    and the clip's norm is summed over each leaf's split axes only."""
    lm = inputs["lm"]
    accum = 2 if "accum2" in name else 1
    want_state, want_metrics = lm["train"][accum]
    before = _np_state(lm["g3_params"])
    for res in spawned(world)[1]:
        got = res[name]
        _check_metrics(got["metrics"], want_metrics, name)
        _check_lm_state(got["state"], before, want_state, name)
        assert got["restarts"] == (1 if name == "lm train 2x1" else 0)
        # each call runs the global layer's flash over the rank's heads
        model = int(name.split()[-1].split("x")[-1])
        heads = {c[3] for c in got["flash"]}
        assert heads == {lm["g3"].n_heads // model}, (name, heads)


def test_lm_train_with_replicated_kv_heads(spawned, inputs):
    """At (1, 4) the one kv head (10 columns) falls back to replication
    while the 4 q heads split: each rank reads the kv head its q head
    maps to, the replicated kv weights' gradients are summed over
    ``model``, and the vocab's 256 padded columns leave ranks 2 and 3 all
    padding; one step against the reference's."""
    lm = inputs["lm"]
    tcfg = tbase.ArchConfig(**dataclasses.asdict(lm["kvrep"]))
    specs = tlaunch.train_shardings(tcfg, (1, 4))[0]
    assert specs["segments"]["seg0"]["pos0"]["attn"]["wk"] == ()
    assert specs["segments"]["seg0"]["pos0"]["attn"]["wq"] == \
        (None, None, "model")
    want_state, want_metrics = lm["kvrep_ref"]
    for res in spawned(4)[1]:
        got = res["lm train kv replicated 1x4"]
        _check_metrics(got["metrics"], want_metrics, "kv replicated")
        _check_lm_state(got["state"], _np_state(lm["kvrep_params"]),
                        want_state, "kv replicated")
        assert {c[3] for c in got["flash"]} == {1}


def test_lm_train_clip_binds(inputs):
    """The gate is read where the clip acts: the reference's first
    gradient norm is above ``grad_clip``."""
    assert inputs["lm"]["train"][1][1][0]["grad_norm"] > LM_OPT["grad_clip"]


def test_lm_train_hubert_normalizes_by_the_global_count(spawned, inputs):
    """The ranks' label masks hold different counts: the loss is the
    global nll sum over the global count, as the reference's."""
    lm = inputs["lm"]
    want_state, want_metrics = lm["hub_ref"]
    mask = lm["hub_batch"]["label_mask"]
    assert mask[:2].sum() != mask[2:].sum()
    for res in spawned(2)[1]:
        got = res["lm train hubert 2x1"]
        _check_metrics(got["metrics"], want_metrics, "hubert")
        assert got["metrics"][0]["tokens"] == float(mask.sum())
        _check_lm_state(got["state"], _np_state(lm["hub_params"]),
                        want_state, "hubert")


@pytest.mark.parametrize("fault", sorted(parity.FAULTS))
def test_lm_train_faults_fail_the_gate(fault, spawned, inputs):
    """Each planted fault reads far above the gate on every rank (its
    factor of FAULT_CASES): loss, ``grad_norm`` against LM_TRAIN_TOL,
    ``aux_lb`` against AUX_TOL."""
    name, mesh, factor = FAULT_CASES[fault]
    want = inputs["lm"]["train"][1][1] if name == "g3" \
        else inputs["fam"]["refs"]()[name]["metrics"]
    for res in spawned(2 if len(mesh) == 2 else 4)[1]:
        got = res[f"lm fault {fault}"]["metrics"]
        worst = max(max(abs(g[k] - w[k]) / abs(w[k]) / tol
                        for k, tol in (("loss", LM_TRAIN_TOL),
                                       ("grad_norm", LM_TRAIN_TOL),
                                       ("aux_lb", AUX_TOL)) if w[k])
                    for g, w in zip(got, want))
        assert worst > factor, (fault, worst)


def _by_coords(per_rank: list, name: str) -> dict:
    return {(r[name]["coords"]["data"], r[name]["coords"]["model"]): r[name]
            for r in per_rank}


def _tp_cache(blocks: list) -> dict:
    """Cache blocks of the model ranks, concatenated on the heads."""
    return {k: (_tp_cache([b[k] for b in blocks]) if isinstance(v, dict)
                else torch.cat([b[k] for b in blocks], dim=3))
            for k, v in blocks[0].items()}


def test_tp_prefill_matches_the_reference(spawned, inputs):
    """Qwen's TP prefill at (1, 2): each rank's vocab columns of the
    logits (vocab 97 padded to 256: rank 0's columns 97-127 and all of
    rank 1's are padding) and its kv heads of the cache against the
    reference's, flash over 2 of the 4 heads."""
    lm = inputs["lm"]
    ranks = _by_coords(spawned(2)[1], "lm prefill 1x2")
    want = lm["q_logits"]
    cols = want.shape[-1] // 2
    for (_, m), res in ranks.items():
        got = res["logits"].numpy()
        w = want[..., m * cols:(m + 1) * cols]
        live = np.arange(m * cols, (m + 1) * cols) < lm["qwen"].vocab
        np.testing.assert_allclose(got[..., live], w[..., live], atol=1e-4,
                                   rtol=1e-4, err_msg=f"model rank {m}")
        assert (got[..., ~live] <= -1e29).all()
        assert live.any() == (m == 0)
        assert {c[3] for c in res["flash"]} == {lm["qwen"].n_heads // 2}
    got = _flat(_tp_cache([ranks[0, m]["cache"] for m in (0, 1)]))
    for path, w in _flat(lm["q_cache"]).items():
        np.testing.assert_allclose(got[path].numpy(), w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max(),
                                   err_msg=path)


def test_tp_prefill_of_the_vlm_matches_the_reference(spawned, inputs):
    """InternVL2's tiny preset at (1, 2): the image prefix through the
    replicated img_proj, the layers over 2 of the 4 heads, each rank's
    vocab columns against the reference's logits."""
    lm = inputs["lm"]
    ranks = _by_coords(spawned(2)[1], "lm prefill vlm 1x2")
    want = lm["vlm_logits"]
    cols = want.shape[-1] // 2
    for (_, m), res in ranks.items():
        w = want[..., m * cols:(m + 1) * cols]
        live = w > -1e29
        np.testing.assert_allclose(res["logits"].numpy()[live], w[live],
                                   atol=1e-4, rtol=1e-4)
        assert {c[3] for c in res["flash"]} == {lm["vlm"].n_heads // 2}


@pytest.mark.parametrize("world,mesh", [(2, (2, 1)), (2, (1, 2)),
                                        (4, (2, 2))])
@pytest.mark.parametrize("kvd", ["bf16", "int8"])
def test_lm_decode_on_a_mesh_matches_the_reference(world, mesh, kvd, spawned,
                                                   inputs):
    """The batch-sharded decode (each data rank its slot) and the TP
    decode (each model rank its heads and vocab columns): the logits put
    back together against the reference's unsharded decode_step, the
    caches' blocks against its final cache."""
    ref = inputs["decode"][kvd]
    ranks = _by_coords(spawned(world)[1],
                       f"lm decode {kvd} {mesh[0]}x{mesh[1]}")
    rows = 2 // mesh[0]
    logits = np.concatenate([np.concatenate(
        [ranks[d, m]["logits"].numpy() for m in range(mesh[1])], axis=-1)
        for d in range(mesh[0])], axis=1)
    assert np.abs(logits - ref["logits"]).max() <= DECODE_LOGITS_TOL
    for (d, m), res in ranks.items():
        got = _flat(res["cache"])
        for path, want in _flat(ref["final"]).items():
            heads = want.shape[3] // mesh[1] if want.shape[3] > 1 else 1
            w = want[:, d * rows:(d + 1) * rows, :,
                     (m * heads if want.shape[3] > 1 else 0):][..., :heads, :]
            g = got[path].numpy()
            if g.dtype == np.int8:
                diff = np.abs(g.astype(np.int32) - w.astype(np.int32))
                assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, path
            else:
                np.testing.assert_allclose(g, w, rtol=1e-5,
                                           atol=1e-5 * np.abs(w).max(),
                                           err_msg=path)


def test_windowed_layers_under_seq_shard_decode(spawned, inputs):
    """The Gemma3's windowed layers under seq_shard_decode at (2, 1): slot
    0's window (rows 6..15) lies on rank 0 only and slot 1's (43..52) on
    rank 1 only, so a rank holds no live row of a slot; the logits
    against the reference's decode_step (whose windowed layers attend
    over the whole cache) and every layer's attention against the
    one-device attention on the rank's own inputs."""
    lm = inputs["lm"]
    per_rank = [res["lm swa decode 2x1"] for res in spawned(2)[1]]
    g3 = tbase.ArchConfig(**dataclasses.asdict(lm["g3"]))
    case = dict(cfg=dataclasses.asdict(lm["g3"]),
                params=_tparams(lm["g3_params"], lm["g3"]),
                cache=cache_from_jax(lm["swa_cache"], g3, "cpu"),
                tokens=torch.tensor(lm["swa_tokens"]),
                lengths=torch.tensor(SWA_LENS))
    assert SWA_LENS[0] + DECODE_STEPS <= SWA_T // 2 \
        and SWA_LENS[1] - g3.local_window >= SWA_T // 2
    for res in per_rank:
        got = res["logits"].numpy()
        assert np.isfinite(got).all()
        assert np.abs(got - lm["swa_logits"]).max() <= DECODE_LOGITS_TOL
        want = parity.attention_oracle(case, torch.device("cpu"),
                                       res["inputs"])
        assert len(want) == len(res["attn"]) == g3.n_layers * DECODE_STEPS
        for a, w in zip(res["attn"], want):
            np.testing.assert_allclose(a.numpy(), w.numpy(),
                                       **DECODE_ATTN_TOL)


def test_reshard_is_bit_for_bit(spawned, inputs):
    """The (2, 2) state saved after its two steps: restored on one device
    here and cut here at every coordinate of (1, 2) and (2, 1), and
    restored at (1, 2) and (2, 1) by the world-2 ranks, equal bit for bit
    to what the (2, 2) ranks held; the next step from it against the
    reference's from the same arrays."""
    from repro_torch.train.train_state import state_specs
    lm = inputs["lm"]
    whole = spawned(4)[1][0]["lm train 2x2"]["state"]
    saved = os.path.join(spawned.dirs[4], "lm_saved")
    one = tckpt.restore(whole, saved)
    assert all(torch.equal(a, b) for a, b in zip(tckpt.tree_leaves(one),
                                                 tckpt.tree_leaves(whole)))
    tcfg = tbase.ArchConfig(**dataclasses.asdict(lm["g3"]))
    for mesh in ((1, 2), (2, 1)):
        specs = state_specs(tcfg, tlaunch.train_shardings(tcfg, mesh)[1],
                            mesh)
        for d in range(mesh[0]):
            for m in range(mesh[1]):
                place = _Place(mesh, d, m)
                want = trules.shard_tree(whole, specs, place)
                got = tckpt.restore(want, saved, shardings=specs,
                                    mesh=place)
                assert all(torch.equal(a, b) for a, b in zip(
                    tckpt.tree_leaves(got), tckpt.tree_leaves(want)))
    np_whole = tckpt.tree_map(lambda t: t.numpy(), whole)
    state, metrics = _ref_steps(lm["g3"], np_whole, lm["batches"][2:])
    for res in spawned(2)[1]:
        for mesh in ("1x2", "2x1"):
            got = res[f"lm reshard {mesh}"]
            assert got["bits_equal"] and got["restored_step"] == 2
            _check_metrics(got["metrics"], metrics, f"reshard {mesh}")
            _check_lm_state(got["state"], np_whole, state, f"reshard {mesh}")


def test_dense_mesh_refusals_batch_rows_and_cache_blocks():
    """In this process: MLA, MoE, SSM and hybrid configs pass the mesh
    check, and heads that do not divide the model axis are padded, not
    refused; an SSM head split over it raises ValueError naming the
    config and the axis; make_batch_fn(shardings=...) gives each rank its
    rows; init_cache on a mesh gives each rank its block of slots and
    heads (of rows with seq_shard_decode), the MLA latent whole over
    model, the SSM state by heads and the conv cache by channels."""
    for name in FAMILIES:
        ttr.check_mesh(tlaunch.reduced_config(name, "tiny"), (1, 2))
    odd = dataclasses.replace(tlaunch.reduced_config("gemma-7b", "tiny"),
                              n_heads=3, n_kv_heads=3)
    ttr.check_mesh(odd, (1, 2))        # padded, as the reference's
    ssm = dataclasses.replace(tlaunch.reduced_config("mamba2-2.7b", "tiny"),
                              ssm_head_dim=256)
    with pytest.raises(ValueError, match="mamba2-2.7b: a model axis of 2 "
                                         "splits the 1 ssm_heads"):
        ttr.check_mesh(ssm, (1, 2))
    ttr.check_mesh(ssm, (3, 1))        # a data axis splits no head
    for name, path, want in (
            ("minicpm3-4b", ("attn", "ckv"), (2, 2, 16, 32)),
            ("mamba2-2.7b", ("ssm", "h"), (2, 2, 4, 32, 16)),
            ("mamba2-2.7b", ("ssm", "conv"), (2, 2, 3, 144))):
        cfg = tlaunch.reduced_config(name, "tiny")
        block = ttr.init_cache(cfg, 4, 16, device="cpu", flags=ttr.RunFlags(
            mesh=_Place((2, 2), 1, 1)))["seg0"]["pos0"]
        assert tuple(block[path[0]][path[1]].shape) == want, (name, path)
    src = lambda step: {"tokens": np.arange(8 * 5).reshape(8, 5) + step}
    for data in range(2):
        for model in range(2):
            fn = tpipe.make_batch_fn(
                src, shardings={"tokens": trules.batch_sharding(
                    (2, 2), 2, batch_size=8)}, device="cpu",
                mesh=_Place((2, 2), data, model))
            np.testing.assert_array_equal(
                fn(1)["tokens"].numpy(), src(1)["tokens"][4 * data:
                                                          4 * data + 4])
    with pytest.raises(ValueError, match="need the mesh"):
        tpipe.make_batch_fn(src, shardings=(("data",),), device="cpu")
    qwen = tiny(jbase.get_config("qwen1.5-32b"), dtype="float32",
                n_kv_heads=4)
    qcfg = tbase.ArchConfig(**dataclasses.asdict(qwen))
    whole = ttr.init_cache(qcfg, 4, 16, kv_dtype="int8", device="cpu")
    for seq, want in ((False, (4, 2, 16, 2, 16)), (True, (4, 4, 8, 2, 16))):
        block = ttr.init_cache(qcfg, 4, 16, kv_dtype="int8", device="cpu",
                               flags=ttr.RunFlags(
                                   mesh=_Place((2, 2), 1, 1),
                                   seq_shard_decode=seq))
        attn = block["seg0"]["pos0"]["attn"]
        assert tuple(attn["k"].shape) == want and attn["k"].dtype == \
            torch.int8
        # one scale a token over every head: the scales are not split
        assert attn["k_s"].shape[3] == whole["seg0"]["pos0"]["attn"][
            "k_s"].shape[3] == 1


# -- MLA, MoE, SSM and hybrid layers on a mesh ------------------------------

def _fam_heads(name: str, model: int) -> set:
    """The heads of each flash call of the family's train and prefill on
    a model axis: its heads split, or padded (Hymba's 5 over 2: 3 a
    rank); none for Mamba2."""
    jcfg = _fam_cfg(name)
    return set() if name == "mamba2-2.7b" else {-(-jcfg.n_heads // model)}


def _check_aux(got: list, want: list, what: str) -> None:
    for g, w in zip(got, want, strict=True):
        for k in ("aux_lb", "aux_z"):
            assert (g[k] == w[k] == 0) or \
                abs(g[k] - w[k]) <= AUX_TOL * abs(w[k]), (what, k, g[k], w[k])


@pytest.mark.parametrize("mesh", ["2x1", "1x2"])
@pytest.mark.parametrize("name", FAMILIES)
def test_family_train_steps_match_the_reference(name, mesh, spawned, inputs):
    """Two train steps with the build_cell shardings against the
    reference's unsharded steps: loss, grad_norm and each leaf's update
    (masters and both moments) at LM_TRAIN_TOL, the MoE aux losses at
    AUX_TOL; the flash calls over the rank's (padded) heads."""
    f = inputs["fam"]["fam"][name]
    ref = inputs["fam"]["refs"]()[name]
    model = int(mesh[-1])
    for res in spawned(2)[1]:
        got = res[f"fam train {name} {mesh}"]
        _check_metrics(got["metrics"], ref["metrics"], name)
        _check_aux(got["metrics"], ref["metrics"], name)
        _check_lm_state(got["state"], _np_state(f["params"]), ref["state"],
                        name)
        assert {c[3] for c in got["flash"]} == _fam_heads(name, model)
    if f["jcfg"].moe:
        assert ref["metrics"][0]["aux_lb"] > 0 and \
            ref["metrics"][0]["aux_z"] > 0


@pytest.mark.parametrize("name", ["olmoe-1b-7b", "llama4-scout-17b-a16e"])
def test_family_routing_is_the_one_device_routing(name, spawned, inputs):
    """Each MoE layer's routing in the first step's forward (expert ids,
    places in the buffers, kept pairs), every rank's rows put together in
    data order, equal bit for bit to the port's one-device forward on the
    same parameters and batch (its routing held to the reference's in
    tests/test_torch_moe.py); the model ranks' routings equal.  OLMoE's
    group of 128 tokens spans both data ranks (the logits gathered);
    Scout's 512 tokens make one whole group a rank."""
    f = inputs["fam"]["fam"][name]
    tcfg = tbase.ArchConfig(**dataclasses.asdict(f["jcfg"]))
    params = _tparams(f["params"], f["jcfg"])
    batch = {"tokens": torch.tensor(f["batches"][0]["tokens"])}
    want: list = []
    with parity.routings(want), torch.no_grad():
        ttr.loss_fn(params, batch, tcfg, ttr.RunFlags(remat=False))
    layers = len(want)
    assert layers == tcfg.n_layers
    for mesh in ("2x1", "1x2"):
        ranks = _by_coords(spawned(2)[1], f"fam train {name} {mesh}")
        data = int(mesh[0])
        for layer in range(layers):
            # the remat's forward: the first `layers` calls of step 1
            for m in range(3 - data):
                got = [torch.cat([ranks[d, m]["routing"][layer][i]
                                  for d in range(data)])
                       for i in range(3)]
                for g, w in zip(got, want[layer]):
                    assert torch.equal(g, w), (name, mesh, layer)


def test_moe_train_on_a_pod_mesh_matches_the_reference(spawned, inputs):
    """OLMoE's two train steps at (pod, data, model) = (2, 2, 1): its
    routing group of 128 tokens spans the four batch ranks, so the
    logits are gathered over (pod, data) and each rank takes the rows
    at its index there, pod-major as ``batch_sharding`` cuts the batch.
    Loss, grad_norm, the aux losses and each leaf's update against the
    reference's; each MoE layer's routing, the ranks' rows put together
    in (pod, data) order, bit for bit the port's one-device routing."""
    name = "olmoe-1b-7b"
    f = inputs["fam"]["fam"][name]
    ref = inputs["fam"]["refs"]()[name]
    results = [r[f"fam train {name} pod 2x2x1"] for r in spawned(4)[1]]
    for got in results:
        _check_metrics(got["metrics"], ref["metrics"], name)
        _check_aux(got["metrics"], ref["metrics"], name)
        _check_lm_state(got["state"], _np_state(f["params"]), ref["state"],
                        name)
    tcfg = tbase.ArchConfig(**dataclasses.asdict(f["jcfg"]))
    want: list = []
    with parity.routings(want), torch.no_grad():
        ttr.loss_fn(_tparams(f["params"], f["jcfg"]),
                    {"tokens": torch.tensor(f["batches"][0]["tokens"])},
                    tcfg, ttr.RunFlags(remat=False))
    order = sorted(results, key=lambda r: (r["coords"]["pod"],
                                           r["coords"]["data"]))
    for layer in range(len(want)):
        got = [torch.cat([r["routing"][layer][i] for r in order])
               for i in range(3)]
        for g, w in zip(got, want[layer]):
            assert torch.equal(g, w), (name, layer)


@pytest.mark.parametrize("name", FAMILIES)
def test_family_tp_prefill_matches_the_reference(name, spawned, inputs):
    """The TP prefill at (1, 2): each rank's vocab columns of the logits
    against the reference's, and its blocks of the cache (the latent
    whole, the SSM state by heads, the conv cache by the rules' channel
    blocks, Hymba's k and v by the head dim) against the reference's cut
    by ``cache_shardings``."""
    f = inputs["fam"]["fam"][name]
    ref = inputs["fam"]["refs"]()[name]
    ranks = _by_coords(spawned(2)[1], f"fam prefill {name} 1x2")
    want = ref["logits"]
    cols = want.shape[-1] // 2
    whole = tckpt.tree_map(torch.tensor, ref["cache"])
    specs = trules.cache_shardings((1, 2), whole)
    for (_, m), res in ranks.items():
        w = want[..., m * cols:(m + 1) * cols]
        live = w > -1e29
        np.testing.assert_allclose(res["logits"].numpy()[live], w[live],
                                   atol=1e-4, rtol=1e-4)
        assert {c[3] for c in res["flash"]} == _fam_heads(name, 2)
        block = trules.shard_tree(whole, specs, _Place((1, 2), 0, m))
        got = _flat(res["cache"])
        for path, wb in _flat(block).items():
            np.testing.assert_allclose(got[path].numpy(), wb.numpy(),
                                       rtol=1e-5,
                                       atol=1e-5 * float(wb.abs().max()),
                                       err_msg=f"{name} {path}")


@pytest.mark.parametrize("name,mesh", [
    (name, mesh) for name in FAMILIES for mesh in ("2x1", "1x2")]
    + [(name, "2x1 seq") for name in FAM_SEQ])
def test_family_decode_on_a_mesh_matches_the_reference(name, mesh, spawned,
                                                       inputs):
    """DECODE_STEPS steps from the reference's prefilled cache: the
    batch-sharded decode (a slot a data rank; OLMoE's and Scout's one
    routing group across them) and the TP decode (the rank's heads,
    experts, SSM heads and vocab columns) at DECODE_LOGITS_TOL, the
    caches' blocks against the reference's final cache; MLA's and
    Hymba's seq_shard_decode (every rank all slots, its rows of the
    cache; Hymba's windowed layer's live rows all on rank 1) at the
    attention outputs' 2e-5."""
    ref = inputs["fam"]["refs"]()[name]
    seq = mesh.endswith("seq")
    shape = tuple(int(v) for v in mesh.split()[0].split("x"))
    ranks = _by_coords(spawned(2)[1], f"fam decode {name} {mesh}")
    want = ref["dlogits"]
    whole = tckpt.tree_map(torch.tensor, ref["final"])
    specs = trules.cache_shardings(shape, whole, seq_shard=seq)
    for (d, m), res in ranks.items():
        got = res["logits"].numpy()
        rows, cols = got.shape[1], got.shape[2]
        w = want[:, 0 if seq else d * rows:][:, :rows,
                                             m * cols:(m + 1) * cols]
        live = w > -1e29
        tol = DECODE_ATTN_TOL if seq else dict(atol=DECODE_LOGITS_TOL,
                                                rtol=0)
        np.testing.assert_allclose(got[live], w[live], **tol,
                                   err_msg=f"{name} {mesh} rank {d, m}")
        block = trules.shard_tree(whole, specs, _Place(shape, d, m))
        got_c = _flat(res["cache"])
        for path, wb in _flat(block).items():
            np.testing.assert_allclose(got_c[path].numpy(), wb.numpy(),
                                       rtol=1e-5,
                                       atol=1e-5 * float(wb.abs().max()),
                                       err_msg=f"{name} {mesh} {path}")


def test_padded_heads_are_the_references():
    """The padded heads' layout against the reference's
    ``_pad_heads_even`` on a model axis of 2 (Hymba's tiny heads: 5 q
    over 1 kv): rank r's block of the reference's padded q, k and v
    (GQA expanded, 6 heads, 3 a rank) equals the rank's real heads and
    their kv heads zero-padded as the port builds them; 25 of Hymba's
    full-width heads pad to 26, 13 a rank, the pad the last."""
    from repro.models.attention import _pad_heads_even
    from repro_torch.models import attention as tattn
    from repro_torch.sharding.collectives import TensorGroup

    class _Fake:
        shape = {"data": 1, "model": 2}
    rng = np.random.default_rng(7)
    q, k, v = (rng.normal(size=(2, 3, h, 4)).astype(np.float32)
               for h in (5, 1, 1))
    qp, kp, vp, hq, hk = _pad_heads_even(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), 5, 1, _Fake())
    assert (hq, hk) == (6, 6)
    for r in range(2):
        lo, n, per = tattn._padded_heads(5, TensorGroup(None, 2, r))
        kv = torch.arange(lo, lo + n) // 5
        for ref, ours in ((qp, torch.tensor(q)[:, :, lo:lo + n]),
                          (kp, torch.tensor(k)[:, :, kv]),
                          (vp, torch.tensor(v)[:, :, kv])):
            np.testing.assert_array_equal(
                np.asarray(ref)[:, :, r * per:(r + 1) * per],
                tattn._pad_to(ours, per).numpy())
    assert [tattn._padded_heads(25, TensorGroup(None, 2, r))
            for r in range(2)] == [(0, 13, 13), (13, 12, 13)]
