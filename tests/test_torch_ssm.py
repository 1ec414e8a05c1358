"""The port's Mamba2 mixer, Mamba2 and Hymba against the JAX package's,
on the CPU.

``ssm_apply`` (the chunked SSD, intra-chunk terms for all chunks at
once), the same with ``ssd_chunked_plain`` (the reference's loop over
chunks transcribed) in its place, ``ssm_decode_step`` and
``ssm_recurrence_plain`` are held to ``repro.models.ssm`` on the same
numpy inputs at the tiny ``mamba2-2.7b`` preset (d 128, 8 SSM heads of
32, state 16, conv 4): S = 600 runs three chunks of 256 with a padded
tail, S = 1 and 3 are shorter than the conv's W-1 = 3 rows of history.
The mixer's parameters are drawn as Mamba2 draws its own (A in [1, 16],
dt in [1e-3, 0.1] through ``dt_bias``), the norm, D and the conv bias
moved off their constant init, so every term counts and the state
carries across chunks.  The whole tiny models run on the reference's
parameters (converted by ``lm_params_from_jax``): the tiny Mamba2 (2
layers) and a tiny Hymba of 4 layers with ``global_layers=(0, 3)``, so
two windowed hybrid layers sit between two global ones (the tiny
preset's 2 layers are both global): logits, caches, decode steps, the
loss's gradients, and the engine's greedy tokens with more slots than
requests, so that idle slots' state evolves as the reference's does.
The models' logits, caches and gradients are compared on weights
conditioned to fan-in = width (tests/test_torch_gemma3.py says why):
at the reference's init ``in_proj``'s fan-in is the layer count, so
``dt`` reaches ~20 and a token's decay e^-50, and there both
frameworks' f32 train logits read 2e-4 to 3e-4 of their largest value
from the port's float64 ones (1.4e-6 conditioned).  The engine runs at
the reference's init.

Tolerances: the mixer in f32 at 1e-5 of each value and of the largest
(two f32 summation orders); in bf16 within ``BF16_NORM`` of the norm
(tests/test_torch_llm.py says why); the models at ``F32_MODEL`` (the
default of tests/test_torch_llm.py's ``_close``); the
gradients at 1e-5 of each leaf's largest element, but for A and dt
(``DECAY_LEAVES``), whose f32 sums cancel: each framework's f32
gradient is held within 1e-4 of the port's float64 one.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.launch.train import reduced_config as j_reduced_config
from repro.models import common as jcommon
from repro.models import ssm as jssm
from repro.models import transformer as jtr
from repro.serve import engine as jengine
from repro_torch.configs import base as tbase
from repro_torch.convert import lm_params_from_jax
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as tlaunch
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttr
from repro_torch.serve.engine import (DecodeEngine, EngineConfig, Request,
                                      _merge_slot_cache)
from repro_torch.train import checkpoint as tckpt
from test_torch_llm import BF16_NORM, _close, _flat, _np_params, _port_cfg
from test_torch_moe import _conditioned, _jflat

CPU = torch.device("cpu")
ARCHS = ["mamba2-2.7b", "hymba-1.5b"]
F32_LAYER = 1e-5
# parameters at full width (the reference's count_params) and the depth
# cut chip_smoke.py trains Mamba2 at (32 of 64 layers)
FULL_PARAMS = {"mamba2-2.7b": 2_832_074_240, "hymba-1.5b": 1_641_688_320}
MAMBA2_TRAIN_CUT = (32, 1_545_144_320)
LENGTHS = (1, 3, 600)
FORMS = {"ssm_apply": tssm._ssd_chunked, "plain": tssm.ssd_chunked_plain}
# the leaves whose f32 gradient sums cancel: A and dt enter every decay
# of the state, and their gradients sum (B, L, H, P, N) terms of both
# signs; against float64 both frameworks' f32 read 2.6e-5 to 3.5e-5 of
# the largest element there (1.6e-6 at most elsewhere) on the mixer
DECAY_LEAVES = ("A_log", "dt_bias")
GRAD_F64 = 1e-4


def _hold_gradients(got: dict, ref: dict, exact: dict) -> None:
    """Each leaf finite; the port's f32 gradient ``got`` and the
    reference's ``ref`` each within GRAD_F64 of the port's float64
    ``exact`` (of the leaf's largest element); ``got`` within 1e-5 of
    ``ref`` but on DECAY_LEAVES."""
    assert sorted(got) == sorted(ref) == sorted(exact)
    for name, g in got.items():
        assert bool(torch.isfinite(g).all()), name
        r, e = np.asarray(ref[name]), exact[name].numpy()
        assert np.abs(e).max() > 0, name
        for a in (g.numpy(), r):
            np.testing.assert_allclose(a, e, rtol=GRAD_F64,
                                       atol=GRAD_F64 * np.abs(e).max(),
                                       err_msg=name)
        if name.rsplit("/", 1)[-1] not in DECAY_LEAVES:
            np.testing.assert_allclose(g.numpy(), r, rtol=1e-5,
                                       atol=1e-5 * np.abs(r).max(),
                                       err_msg=name)


def _cfgs(arch, dtype="float32"):
    """The tiny Mamba2 preset, or the tiny Hymba at 4 layers with
    ``global_layers=(0, 3)``, as (JAX config, port config)."""
    jcfg = dataclasses.replace(j_reduced_config(arch, "tiny"), dtype=dtype)
    if arch == "hymba-1.5b":
        jcfg = dataclasses.replace(jcfg, n_layers=4, global_layers=(0, 3))
    return jcfg, _port_cfg(jcfg)


def _mixer_leaves(a: dict, rng) -> None:
    """In place, on one mixer's numpy parameters (any leading layers
    axis): A and dt drawn as Mamba2 draws them, D, the norm scale and
    the conv bias off their constant init."""
    h = a["A_log"].shape
    a["A_log"] = np.log(rng.uniform(1, 16, size=h)).astype(np.float32)
    a["dt_bias"] = np.log(np.expm1(rng.uniform(1e-3, 0.1, size=h))
                          ).astype(np.float32)
    a["D"] = (1 + 0.1 * rng.normal(size=h)).astype(np.float32)
    for key in ("conv_b", "norm"):
        a[key] = (a[key] + 0.1 * rng.normal(size=a[key].shape)
                  ).astype(np.float32)


@functools.cache
def _layer_params() -> dict:
    jcfg, _ = _cfgs("mamba2-2.7b")
    p = {k: np.asarray(v, np.float32) for k, v in jcommon.init_params(
        jax.random.PRNGKey(3), jssm.ssm_specs(jcfg)).items()}
    _mixer_leaves(p, np.random.default_rng(5))
    return p


def _x(s: int) -> np.ndarray:
    return np.random.default_rng(s).normal(size=(2, s, 128)
                                           ).astype(np.float32)


@functools.cache
def _reference_layer(s: int, dtype: str):
    """The reference's ``ssm_apply(mode="prefill")`` on (2, s, 128):
    (y, h, conv) as numpy f32."""
    jcfg, _ = _cfgs("mamba2-2.7b", dtype)
    jdt = jcfg.activation_dtype
    fn = jax.jit(functools.partial(jssm.ssm_apply, cfg=jcfg, mode="prefill"))
    y, c = fn(jax.tree.map(lambda a: jnp.asarray(a, jdt), _layer_params()),
              jnp.asarray(_x(s), jdt))
    return tuple(np.asarray(a, np.float32) for a in (y, c["h"], c["conv"]))


def _port_layer(s: int, dtype: str, form: str = "ssm_apply",
                monkeypatch=None):
    _, tcfg = _cfgs("mamba2-2.7b", dtype)
    dt = tcfg.activation_dtype
    params = {k: torch.tensor(v).to(dt) for k, v in _layer_params().items()}
    if form != "ssm_apply":
        monkeypatch.setattr(tssm, "_ssd_chunked", FORMS[form])
    return params, tssm.ssm_apply(params, torch.tensor(_x(s)).to(dt), tcfg,
                                  mode="prefill")


def _f32_close(got, want, tol=F32_LAYER):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * np.abs(want).max())


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("s", LENGTHS)
def test_ssm_apply_f32_matches_reference(s, form, monkeypatch):
    """f32: ``y``, the final state ``h`` (f32) and the conv cache (the
    last W-1 raw inputs, zero rows where S < W-1) within 1e-5."""
    y_ref, h_ref, conv_ref = _reference_layer(s, "float32")
    _, (y, cache) = _port_layer(s, "float32", form, monkeypatch)
    assert y.dtype == torch.float32 and y.shape == y_ref.shape
    assert cache["h"].dtype == torch.float32
    assert tuple(cache["conv"].shape) == conv_ref.shape == (2, 3, 288)
    _f32_close(y, y_ref)
    _f32_close(cache["h"], h_ref)
    _f32_close(cache["conv"], conv_ref)
    if s < 3:
        assert not conv_ref[:, :3 - s].any()


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("s", (3, 600))
def test_ssm_apply_bf16_close_to_reference(s, form, monkeypatch):
    """bf16: ``y`` and ``h`` within ``BF16_NORM`` of the reference's
    norm (``h`` f32 on both sides, from bf16 operands), the conv cache
    (raw bf16 inputs) equal."""
    y_ref, h_ref, conv_ref = _reference_layer(s, "bfloat16")
    _, (y, cache) = _port_layer(s, "bfloat16", form, monkeypatch)
    assert y.dtype == torch.bfloat16 and cache["h"].dtype == torch.float32
    for got, want in ((y, y_ref), (cache["h"], h_ref)):
        got = got.float().numpy()
        assert np.linalg.norm(got - want) <= BF16_NORM * np.linalg.norm(want)
    np.testing.assert_array_equal(cache["conv"].float().numpy(), conv_ref)


def test_the_state_carries_across_chunks():
    """At S = 600 the second chunk's output depends on the first's state
    and conv history: run alone, its output moves by far more than the
    f32 tolerance (so the cases above see a fault in the handoff)."""
    y_ref, _, _ = _reference_layer(600, "float32")
    _, tcfg = _cfgs("mamba2-2.7b")
    params = {k: torch.tensor(v) for k, v in _layer_params().items()}
    alone, _ = tssm.ssm_apply(params, torch.tensor(_x(600)[:, 256:]), tcfg)
    rel = np.linalg.norm(alone.numpy() - y_ref[:, 256:]) / \
        np.linalg.norm(y_ref[:, 256:])
    assert rel > 1e3 * F32_LAYER, rel


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_decode_step_matches_reference(dtype):
    """From the reference's prefill cache of S = 600, four decode steps:
    each step's output and the cache it leaves against the reference's
    ``ssm_decode_step`` (f32 at 1e-5; bf16 in norm), the new state
    written into the cache the step was given."""
    jcfg, tcfg = _cfgs("mamba2-2.7b", dtype)
    jdt, dt = jcfg.activation_dtype, tcfg.activation_dtype
    jp = jax.tree.map(lambda a: jnp.asarray(a, jdt), _layer_params())
    params = {k: torch.tensor(v).to(dt) for k, v in _layer_params().items()}
    _, jcache = jax.jit(functools.partial(
        jssm.ssm_apply, cfg=jcfg, mode="prefill"))(jp, jnp.asarray(_x(600),
                                                                   jdt))
    cache = {k: torch.tensor(np.asarray(v, np.float32)).to(
        torch.float32 if k == "h" else dt) for k, v in jcache.items()}
    step = jax.jit(functools.partial(jssm.ssm_decode_step, cfg=jcfg))
    rng = np.random.default_rng(9)
    for _ in range(4):
        x = rng.normal(size=(2, 1, 128)).astype(np.float32)
        jy, jcache = step(jp, jnp.asarray(x, jdt), cache=jcache)
        h_before = cache["h"]
        y, out = tssm.ssm_decode_step(params, torch.tensor(x).to(dt), tcfg,
                                      cache)
        assert out is cache and out["h"] is h_before
        for got, want in ((y, jy), (cache["h"], jcache["h"]),
                          (cache["conv"], jcache["conv"])):
            want = np.asarray(want, np.float32)
            if dtype == "float32":
                _f32_close(got, want)
            else:
                got = got.float().numpy()
                assert np.linalg.norm(got - want) <= \
                    BF16_NORM * np.linalg.norm(want)


def test_recurrence_plain_equals_ssm_apply():
    """S = 600, f32: the token-by-token recurrence against the chunked
    SSD (y, h, conv at 1e-5), and in float64 against the reference's
    f32 output at 1e-5."""
    params, (y, cache) = _port_layer(600, "float32")
    _, tcfg = _cfgs("mamba2-2.7b")
    x = torch.tensor(_x(600))
    ry, rcache = tssm.ssm_recurrence_plain(params, x, tcfg)
    for got, want in ((ry, y), (rcache["h"], cache["h"]),
                      (rcache["conv"], cache["conv"])):
        _f32_close(got, want.numpy())
    wide = {k: v.double() for k, v in params.items()}
    y64, c64 = tssm.ssm_recurrence_plain(wide, x.double(), tcfg)
    assert y64.dtype == c64["h"].dtype == torch.float64
    y_ref, h_ref, _ = _reference_layer(600, "float32")
    _f32_close(y64.numpy(), y_ref)
    _f32_close(c64["h"].numpy(), h_ref)


def test_gradients_match_reference_and_are_finite():
    """f32, S = 600: the gradients of ``sum(y·w)`` wrt x and every
    parameter finite (the mask before the ``exp`` keeps the upper
    triangle's gradient 0, not ``inf·0``) and held to ``jax.grad`` of
    the reference's and to the port's float64 ones
    (``_hold_gradients``)."""
    jcfg, tcfg = _cfgs("mamba2-2.7b")
    p = _layer_params()
    x = _x(600)
    w = np.random.default_rng(12).normal(size=x.shape).astype(np.float32)

    def jloss(params, x):
        return jnp.sum(jssm.ssm_apply(params, x, jcfg)[0] * w)
    jg = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    want = dict(jg[0], x=jg[1])

    def grads(dt):
        tp = {k: torch.tensor(v).to(dt).requires_grad_()
              for k, v in p.items()}
        xt = torch.tensor(x).to(dt).requires_grad_()
        y, _ = tssm.ssm_apply(tp, xt, tcfg)
        names = sorted(tp) + ["x"]
        return dict(zip(names, torch.autograd.grad(
            (y * torch.tensor(w).to(dt)).sum(),
            [tp[n] for n in names[:-1]] + [xt])))
    _hold_gradients(grads(torch.float32), want, grads(torch.float64))


# ---------------------------------------------------------------------------
# Specs, counts and caches at full width.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_specs_and_counts_match_reference(arch):
    """Every spec path, shape, axes, initializer and scale at full width
    (an SSM block's ``ssm`` and no ``attn``, a hybrid block both); the
    parameter count and model FLOPs a token (6·N) equal the reference's;
    ``ssm_d_inner`` and ``ssm_heads``; the cache's tree, shapes and
    dtypes at the tiny size (no attention cache for an SSM block)."""
    jcfg, tcfg = jbase.get_config(arch), tbase.get_config(arch)
    assert (tcfg.ssm_d_inner, tcfg.ssm_heads) == \
        (jcfg.ssm_d_inner, jcfg.ssm_heads)
    want = {"/".join(p.key for p in path): (s.shape, s.axes, s.init,
                                            s.scale)
            for path, s in jax.tree_util.tree_flatten_with_path(
                jtr.model_specs(jcfg),
                is_leaf=lambda x: isinstance(x, jcommon.PSpec))[0]}
    got = {p: (s.shape, s.axes, s.init, s.scale)
           for p, s in _flat(ttr.model_specs(tcfg)).items()}
    assert got == want
    assert any("/ssm/A_log" in p for p in got)
    assert any("/attn/" in p for p in got) == (arch == "hymba-1.5b")
    assert ttr.count_params(tcfg) == jtr.count_params(jcfg) == \
        FULL_PARAMS[arch]
    assert ttr.model_flops_per_token(tcfg) == \
        jtr.model_flops_per_token(jcfg) == 6.0 * FULL_PARAMS[arch]
    if arch == "mamba2-2.7b":
        layers, n = MAMBA2_TRAIN_CUT
        assert ttr.count_params(dataclasses.replace(tcfg, n_layers=layers)) \
            == jtr.count_params(dataclasses.replace(jcfg, n_layers=layers)) \
            == n
    jcfg, tcfg = _cfgs(arch)
    jcache = {p: (a.shape, str(a.dtype)) for p, a in
              _jflat(jtr.init_cache(jcfg, 3, 40)).items()}
    tcache = {p: (tuple(t.shape), str(t.dtype).removeprefix("torch."))
              for p, t in _flat(ttr.init_cache(tcfg, 3, 40,
                                               device=CPU)).items()}
    assert tcache == jcache
    assert dataclasses.asdict(tserve.reduced_config(arch, "tiny")) == \
        dataclasses.asdict(j_reduced_config(arch, "tiny"))


def test_merge_slot_cache_writes_state_caches_whole():
    """A state cache replaces its slot's row (the row's old state gone,
    other rows kept); a sequence cache fills the prompt's positions; a
    state cache of another shape raises."""
    _, tcfg = _cfgs("hymba-1.5b")
    cache = ttr.init_cache(tcfg, 3, 40, device=CPU)
    for t in _flat(cache).values():
        t.fill_(7.0)
    params = ttr.init(tcfg, torch.Generator().manual_seed(0))
    _, pcache = ttr.forward(params, {"tokens": torch.arange(5)[None]}, tcfg,
                            mode="prefill")
    _merge_slot_cache(cache, pcache, 1, 5)
    for path, t in _flat(cache).items():
        p = _flat(pcache)[path]
        if "/ssm/" in path:
            assert torch.equal(t[:, 1:2], p), path
        else:
            assert torch.equal(t[:, 1:2, :5], p), path
            assert (t[:, 1, 5:] == 7).all(), path
        assert (t[:, [0, 2]] == 7).all(), path
    bad = {"seg0": {"pos0": {"ssm": {"h": torch.zeros(1, 1, 8, 32, 15)}}}}
    with pytest.raises(ValueError):
        _merge_slot_cache({"seg0": {"pos0": {"ssm": {
            "h": cache["seg0"]["pos0"]["ssm"]["h"]}}}}, bad, 0, 5)


# ---------------------------------------------------------------------------
# The tiny models.
# ---------------------------------------------------------------------------

TRAIN_S = 300
PROMPTS = (TRAIN_S, 13)
MAX_LEN = 320
DECODE_STEPS = 4


def _model_params(jcfg, seed: int = 0) -> dict:
    """The reference's initial parameters as numpy, the norm scales off
    their zero init and every mixer's leaves as ``_mixer_leaves``."""
    np_params = _np_params(jcfg, seed)
    rng = np.random.default_rng(seed + 100)
    for seg in np_params["segments"].values():
        for blk in seg.values():
            _mixer_leaves(blk["ssm"], rng)
    return np_params


@pytest.fixture
def float64_config(monkeypatch):
    """``cfg`` at ``dtype="float64"`` (the port's float64 yardstick; the
    configs name f32, bf16 and f16 only)."""
    monkeypatch.setitem(tbase._DTYPES, "float64", torch.float64)
    return lambda cfg: dataclasses.replace(cfg, dtype="float64")


@functools.cache
def _reference(arch):
    """The reference's tiny model in f32 on conditioned weights: its
    numpy parameters, 2 x TRAIN_S tokens, the prefill logits and cache of
    the prompts (the first row, and the second row's first 13 tokens),
    DECODE_STEPS batched decode steps and their cache."""
    jcfg, _ = _cfgs(arch)
    np_params = _conditioned(_model_params(jcfg), jcfg.d_model)
    jp = jax.tree.map(jnp.asarray, np_params)
    rng = np.random.default_rng(31)
    toks = rng.integers(0, jcfg.vocab, size=(2, TRAIN_S))
    prefill_fn = jax.jit(functools.partial(jtr.forward, cfg=jcfg,
                                           mode="prefill"))
    decode_fn = jax.jit(functools.partial(jtr.decode_step, cfg=jcfg))
    prompts = [toks[i, :n] for i, n in enumerate(PROMPTS)]
    cache = jtr.init_cache(jcfg, 2, MAX_LEN)
    prefills = []
    for slot, prompt in enumerate(prompts):
        lg, pc, _ = prefill_fn(jp, {"tokens": jnp.asarray(prompt[None])})
        prefills.append((lg, pc))
        cache = jengine._merge_slot_cache(cache, pc, slot, len(prompt))
    steps = rng.integers(0, jcfg.vocab, size=(DECODE_STEPS, 2, 1))
    lengths = np.array(PROMPTS)
    decodes = []
    for t in range(DECODE_STEPS):
        lg, cache = decode_fn(jp, cache, jnp.asarray(steps[t]),
                              jnp.asarray(lengths + t, jnp.int32))
        decodes.append(lg)
    return dict(np_params=np_params, toks=toks, prompts=prompts,
                prefills=prefills, steps=steps, lengths=lengths,
                decodes=decodes, cache=cache)


@pytest.mark.parametrize("arch,impl", [("mamba2-2.7b", "flash"),
                                       ("hymba-1.5b", "flash"),
                                       ("hymba-1.5b", "naive")])
def test_tiny_model_matches_reference(arch, impl):
    """f32, conditioned: the train logits of 2 x 300 tokens (two chunks)
    against the reference's prefill logits of the prompts (causal: the
    second row's first 13 positions are its 13-token prompt's), each
    prompt's prefill logits and cache (merged into two slots by the
    engine's ``_merge_slot_cache``), DECODE_STEPS batched decode steps
    and the cache they wrote in place."""
    ref = _reference(arch)
    _, tcfg = _cfgs(arch)
    tp = lm_params_from_jax(ref["np_params"], tcfg, CPU)
    flags = ttr.RunFlags(attn_impl=impl)
    train, none = ttr.forward(tp, {"tokens": torch.tensor(ref["toks"])},
                              tcfg, flags=flags)
    assert none is None
    for row, (prompt, (jl, _)) in enumerate(zip(ref["prompts"],
                                                ref["prefills"])):
        _close(train[row:row + 1, :len(prompt)], jl)
    cache = ttr.init_cache(tcfg, 2, MAX_LEN, device=CPU)
    for slot, (prompt, (jl, jpc)) in enumerate(zip(ref["prompts"],
                                                   ref["prefills"])):
        lg, pc = ttr.forward(tp, {"tokens": torch.tensor(prompt[None])},
                             tcfg, mode="prefill", flags=flags)
        _close(lg, jl)
        assert sorted(_flat(pc)) == sorted(_jflat(jpc))
        for path, a in _jflat(jpc).items():
            _close(_flat(pc)[path], a)
        _merge_slot_cache(cache, pc, slot, len(prompt))
    for t in range(DECODE_STEPS):
        lg, out = ttr.decode_step(tp, cache, torch.tensor(ref["steps"][t]),
                                  torch.tensor(ref["lengths"] + t), tcfg,
                                  flags)
        assert all(a is b for a, b in zip(_flat(out).values(),
                                          _flat(cache).values()))
        _close(lg, ref["decodes"][t])
    for path, a in _jflat(ref["cache"]).items():
        _close(_flat(cache)[path], a)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_reference(arch, float64_config):
    """f32: ``loss_fn`` of the tiny model over 2 x TRAIN_S tokens (two
    chunks), under remat, on conditioned weights, against the
    reference's at 1e-5; its gradients held to ``jax.grad`` of the
    reference's and to the port's float64 ones (``_hold_gradients``)."""
    ref = _reference(arch)
    jcfg, tcfg = _cfgs(arch)
    loss = functools.partial(jtr.loss_fn, cfg=jcfg,
                             flags=jtr.RunFlags(remat=False))
    (jtotal, _), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jax.tree.map(jnp.asarray, ref["np_params"]),
        {"tokens": jnp.asarray(ref["toks"])})

    def grads(cfg, impl):
        tp = lm_params_from_jax(ref["np_params"], cfg, CPU)
        leaves = [t.requires_grad_() for t in tckpt.tree_leaves(tp)]
        total, _ = ttr.loss_fn(tp, {"tokens": torch.tensor(ref["toks"])},
                               cfg, ttr.RunFlags(attn_impl=impl, remat=True))
        return total, dict(zip(_flat(tp), torch.autograd.grad(total,
                                                                leaves)))
    total, got = grads(tcfg, "flash")
    np.testing.assert_allclose(float(total.detach()), float(jtotal),
                               rtol=F32_LAYER)
    # float64 through the naive attention (the flash kernel and its plain
    # version take f32 and bf16)
    _hold_gradients(got, _jflat(jgrads),
                    grads(float64_config(tcfg), "naive")[1])


ENGINE = dict(n_slots=4, max_len=MAX_LEN, max_new=6, temperature=0.0)
ENGINE_PROMPTS = (5, 270, 19)


@functools.cache
def _reference_engine(arch):
    """The reference engine's greedy tokens, steps and each step's
    logits on ENGINE_PROMPTS over ENGINE's four slots (one always
    idle)."""
    jcfg, _ = _cfgs(arch)
    np_params = _model_params(jcfg, seed=1)
    je = jengine.DecodeEngine(jcfg, jax.tree.map(jnp.asarray, np_params),
                              jengine.EngineConfig(**ENGINE))
    logits = []
    decode = je._decode
    step_logits = jax.jit(functools.partial(jtr.decode_step, cfg=jcfg))

    def recorded(params, cache, tokens, lengths, key):
        # the step's logits first: the engine's step donates the cache
        logits.append(np.asarray(step_logits(params, cache, tokens,
                                             lengths)[0]))
        return decode(params, cache, tokens, lengths, key)
    je._decode = recorded
    rng = np.random.default_rng(32)
    prompts = [[int(t) for t in rng.integers(0, jcfg.vocab, size=n)]
               for n in ENGINE_PROMPTS]
    jreqs = [jengine.Request(rid=i, prompt=p) for i, p in enumerate(prompts)]
    je.run(jreqs)
    return np_params, prompts, [r.generated for r in jreqs], je.steps, logits


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_with_idle_slots_matches_reference(arch, monkeypatch):
    """float32: three requests in four slots, so an idle slot's state
    evolves in every decode step, as the reference's: the port's engine
    gives the reference engine's greedy tokens and steps, and every
    step's logits close."""
    np_params, prompts, tokens, steps, jlogits = _reference_engine(arch)
    _, tcfg = _cfgs(arch)
    te = DecodeEngine(tcfg, lm_params_from_jax(np_params, tcfg, CPU),
                      EngineConfig(**ENGINE), device=CPU)
    logits = []
    decode_step = ttr.decode_step

    def recorded(*args, **kw):
        out = decode_step(*args, **kw)
        logits.append(out[0].clone())
        return out
    monkeypatch.setattr(ttr, "decode_step", recorded)
    treqs = [Request(rid=i, prompt=p) for i, p in enumerate(prompts)]
    te.run(treqs)
    assert all(r.done and len(r.generated) == 6 for r in treqs)
    assert [r.generated for r in treqs] == tokens
    assert te.steps == steps == len(logits) == len(jlogits)
    for got, want in zip(logits, jlogits):
        _close(got, want)
    # the idle slot's state moved away from zero
    idle = _flat(te.cache)["seg0/pos0/ssm/h"][:, 3]
    assert idle.abs().max() > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_clis_run_the_tiny_preset(arch, tmp_path):
    """``python -m repro_torch.launch.train`` and ``.serve`` at the tiny
    preset on the CPU."""
    loop, _ = tlaunch.main(["--arch", arch, "--preset", "tiny", "--steps",
                            "2", "--batch", "2", "--seq", "32", "--device",
                            "cpu", "--ckpt-dir", str(tmp_path)])
    assert loop.steps == 2
    _, reqs = tserve.main(["--arch", arch, "--preset", "tiny", "--requests",
                           "3", "--max-new", "4", "--device", "cpu"])
    assert all(r.done and len(r.generated) == 4 for r in reqs)
