"""The port's LLM stack against the JAX package's, on the CPU.

The configs, ``reduced_config``, the norms, RoPE, MLPs, attention, the
transformer (specs, cache, prefill, decode), sampling and the decode
engine are fed the same numpy inputs and the JAX package's parameters
(converted by ``lm_params_from_jax``), with the norms' scales and the
QKV biases perturbed away from their zero init so those paths count.
The port's "flash" attention runs the CUDA kernel's plain version here.

Tolerances, by dtype:
* float32: 1e-6 for the elementwise copies (norm, RoPE), 1e-5 for an
  MLP or one attention block; through a model, 1e-4 of each value and
  1e-4 of the largest one (f32 on both sides, summed in another order:
  an error scales with the terms summed, not with the one output, and
  the random weights give logits of up to ~50).
* bfloat16: the logits within 3e-2 of their norm.  The two frameworks
  round at other places: JAX's GELU and SiLU round each of their ops to
  bf16 where PyTorch rounds once (about 40% of the activations differ
  by an ulp, 2^-8), and the kernel keeps ``p`` in f32 where the
  reference's ``flash_attention`` (a naive softmax below 1024 keys)
  rounds it to bf16.  Two layers of near-argmax attention then carry a
  few ulps to about 1% of the logits' norm.  For the same reason the
  engines' greedy tokens are compared in float32, where no tie of the
  argmax can flip; in bf16 the engine is held to the port's own
  step-by-step decode.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.launch.train import reduced_config as j_reduced_config
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import mlp as jmlp
from repro.models import transformer as jtr
from repro.serve import engine as jengine
from repro_torch.configs import base as tbase
from repro_torch.convert import lm_params_from_jax
from repro_torch.launch import serve as tserve
from repro_torch.launch.serve import reduced_config
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon
from repro_torch.models import mlp as tmlp
from repro_torch.models import transformer as ttr
from repro_torch.serve.engine import (DecodeEngine, EngineConfig, Request,
                                      _merge_slot_cache)
from repro_torch.serve.sampling import sample
from test_serve import TINY as J_TINY

CPU = torch.device("cpu")
F32_OP = dict(atol=1e-5, rtol=1e-5)
F32_MODEL = 1e-4
BF16_NORM = 3e-2
ARCHS = ["gemma-7b", "qwen1.5-32b"]


def _port_cfg(jcfg, **over):
    return dataclasses.replace(tbase.ArchConfig(**dataclasses.asdict(jcfg)),
                               **over)


def _cfgs(arch: str, dtype: str = "float32"):
    """The tiny preset of ``arch`` (``"qwen-tiny"``: test_serve's TINY),
    as (JAX config, port config) at ``dtype``."""
    jcfg = J_TINY if arch == "qwen-tiny" else j_reduced_config(arch, "tiny")
    jcfg = dataclasses.replace(jcfg, dtype=dtype)
    return jcfg, _port_cfg(jcfg)


def _np_params(jcfg, seed: int = 0) -> dict:
    """The reference's initial parameters as numpy, with the norm scales
    and the QKV biases moved off their zero init."""
    rng = np.random.default_rng(seed)
    perturbed = ("ln_mix", "ln_mlp", "final_norm", "bq", "bk", "bv")

    def leaf(path, a):
        a = np.asarray(a, np.float32)
        if getattr(path[-1], "key", None) in perturbed:
            a = a + 0.1 * rng.normal(size=a.shape).astype(np.float32)
        return a
    return jax.tree_util.tree_map_with_path(
        leaf, jtr.init(jcfg, jax.random.PRNGKey(seed)))


def _both(np_params, tcfg):
    return (jax.tree.map(jnp.asarray, np_params),
            lm_params_from_jax(np_params, tcfg, CPU, torch.float32))


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _close(got, ref, tol=F32_MODEL):
    """``got`` within ``tol`` of each value of ``ref`` plus ``tol`` of its
    largest finite magnitude (the masked padding logits, -1e30, exactly)."""
    got, ref = _np(got), _np(ref)
    live = np.abs(ref) < 1e29
    assert (got[~live] == ref[~live]).all()
    np.testing.assert_allclose(got[live], ref[live], rtol=tol,
                               atol=tol * np.abs(ref[live]).max())


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: v})
    return out


# ---------------------------------------------------------------------------
# Configs.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", jbase.list_configs())
def test_registered_configs_match_reference(name):
    jcfg, tcfg = jbase.get_config(name), tbase.get_config(name)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.padded_vocab == jcfg.padded_vocab
    assert tcfg.resolved_head_dim == jcfg.resolved_head_dim
    assert tcfg.supports_decode == jcfg.supports_decode
    assert tcfg.activation_dtype == getattr(torch, jcfg.activation_dtype.name)
    assert [([dataclasses.asdict(d) for d in descs], rep)
            for descs, rep in tcfg.layer_segments()] == \
        [([dataclasses.asdict(d) for d in descs], rep)
         for descs, rep in jcfg.layer_segments()]
    assert tbase.list_configs() == jbase.list_configs()
    assert {k: dataclasses.asdict(v) for k, v in tbase.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jbase.SHAPES.items()}


@pytest.mark.parametrize("preset", ["tiny", "100m", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_config_matches_reference(arch, preset):
    assert dataclasses.asdict(reduced_config(arch, preset)) == \
        dataclasses.asdict(j_reduced_config(arch, preset))


def test_gemma_7b_parameter_count():
    cfg = tbase.get_config("gemma-7b")
    assert ttr.count_params(cfg) == jtr.count_params(
        jbase.get_config("gemma-7b")) == 8_537_680_896


@pytest.mark.parametrize("arch", ARCHS)
def test_model_specs_and_cache_match_reference(arch):
    """Every spec path with its shape, axes and initializer, at full
    width, and the cache's tree and shapes at the tiny preset."""
    jspecs = jax.tree_util.tree_flatten_with_path(
        jtr.model_specs(jbase.get_config(arch)),
        is_leaf=lambda x: isinstance(x, jcommon.PSpec))[0]
    want = {"/".join(p.key for p in path): (s.shape, s.axes, s.init)
            for path, s in jspecs}
    got = {path: (s.shape, s.axes, s.init) for path, s in
           _flat(ttr.model_specs(tbase.get_config(arch))).items()}
    assert got == want
    jcfg, tcfg = _cfgs(arch)
    jcache = {"/".join(p.key for p in path): a.shape for path, a in
              jax.tree_util.tree_flatten_with_path(
                  jtr.init_cache(jcfg, 3, 40))[0]}
    tcache = {p: tuple(t.shape) for p, t in
              _flat(ttr.init_cache(tcfg, 3, 40, device=CPU)).items()}
    assert tcache == jcache


def test_init_draws_the_specs_in_the_activation_dtype():
    _, tcfg = _cfgs("gemma-7b", "bfloat16")
    a = ttr.init(tcfg, torch.Generator().manual_seed(3))
    b = ttr.init(tcfg, torch.Generator().manual_seed(3))
    specs = _flat(ttr.model_specs(tcfg))
    for path, t in _flat(a).items():
        assert tuple(t.shape) == specs[path].shape and \
            t.dtype == torch.bfloat16, path
        assert torch.equal(t, _flat(b)[path])
        if specs[path].init == "zeros":
            assert not t.any(), path
    assert _flat(a)["embed"].float().std() > 0.9     # the "embed" draw


# ---------------------------------------------------------------------------
# Norms, RoPE, MLPs.
# ---------------------------------------------------------------------------

def test_rms_norm_matches_reference():
    rng = np.random.default_rng(0)
    x = (3 * rng.normal(size=(2, 5, 48))).astype(np.float32)
    scale = (0.2 * rng.normal(size=(48,))).astype(np.float32)
    ref = jcommon.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-6)
    got = tcommon.rms_norm(torch.tensor(x), torch.tensor(scale), 1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6,
                               rtol=1e-6)


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope_matches_reference(theta):
    rng = np.random.default_rng(1)
    pos = np.broadcast_to(np.arange(24)[None], (2, 24))
    jcos, jsin = jcommon.rope_angles(jnp.asarray(pos), 32, theta)
    tcos, tsin = tcommon.rope_angles(torch.tensor(pos), 32, theta)
    np.testing.assert_allclose(tcos.numpy(), np.asarray(jcos), atol=1e-6,
                               rtol=1e-6)
    np.testing.assert_allclose(tsin.numpy(), np.asarray(jsin), atol=1e-6,
                               rtol=1e-6)
    x = rng.normal(size=(2, 24, 3, 32)).astype(np.float32)
    ref = jcommon.apply_rope(jnp.asarray(x), jcos, jsin)
    got = tcommon.apply_rope(torch.tensor(x), tcos, tsin)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6,
                               rtol=1e-6)


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu"])
def test_mlp_matches_reference(kind):
    jcfg, tcfg = _cfgs("gemma-7b")
    rng = np.random.default_rng(2)
    specs = jmlp.mlp_specs(jcfg, kind)
    assert {k: (s.shape, s.axes, s.init) for k, s in specs.items()} == {
        k: (s.shape, s.axes, s.init)
        for k, s in tmlp.mlp_specs(tcfg, kind).items()}
    p = {k: (0.1 * rng.normal(size=s.shape)).astype(np.float32)
         for k, s in specs.items()}
    x = rng.normal(size=(2, 7, jcfg.d_model)).astype(np.float32)
    ref = jmlp.mlp_apply({k: jnp.asarray(v) for k, v in p.items()},
                         jnp.asarray(x), kind)
    got = tmlp.mlp_apply({k: torch.tensor(v) for k, v in p.items()},
                         torch.tensor(x), kind)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F32_OP)


# ---------------------------------------------------------------------------
# Attention.
# ---------------------------------------------------------------------------

def _attn_params(jcfg, rng):
    return {k: (0.1 * rng.normal(size=s.shape)).astype(np.float32)
            for k, s in jattn.attention_specs(jcfg, jcfg.block()).items()}


@pytest.mark.parametrize("impl", ["flash", "naive"])
@pytest.mark.parametrize("arch", ARCHS)
def test_attention_prefill_matches_reference(arch, impl):
    """Tiny preset: GQA of 4 q-heads over 2 KV heads; qwen adds QKV
    biases.  The output and the cache (the un-expanded heads)."""
    jcfg, tcfg = _cfgs(arch)
    rng = np.random.default_rng(3)
    p = _attn_params(jcfg, rng)
    x = rng.normal(size=(2, 11, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(11)[None], (2, 11))
    ref, rc = jattn.attention_apply(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), jcfg,
        jcfg.block(), positions=jnp.asarray(pos), mode="prefill",
        attn_impl=impl)
    got, gc = tattn.attention_apply(
        {k: torch.tensor(v) for k, v in p.items()}, torch.tensor(x), tcfg,
        tcfg.block(), positions=torch.tensor(pos), mode="prefill",
        attn_impl=impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F32_OP)
    for key in ("k", "v"):
        assert tuple(gc[key].shape) == (2, 11, jcfg.n_kv_heads,
                                        jcfg.resolved_head_dim)
        np.testing.assert_allclose(gc[key].numpy(), np.asarray(rc[key]),
                                   **F32_OP)


@pytest.mark.parametrize("arch", ARCHS)
def test_attention_decode_matches_reference(arch):
    """One token per sequence at per-sequence lengths over a cache of
    random contents: the output, and the cache written in place at
    ``lengths`` (the reference returns an updated copy)."""
    jcfg, tcfg = _cfgs(arch)
    rng = np.random.default_rng(4)
    p = _attn_params(jcfg, rng)
    b, t = 3, 20
    x = rng.normal(size=(b, 1, jcfg.d_model)).astype(np.float32)
    shape = (b, t, jcfg.n_kv_heads, jcfg.resolved_head_dim)
    cache = {k: rng.normal(size=shape).astype(np.float32) for k in "kv"}
    lengths = np.array([0, 7, 19])
    ref, rc = jattn.attention_apply(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), jcfg,
        jcfg.block(), positions=jnp.asarray(lengths[:, None]),
        mode="decode", cache={k: jnp.asarray(v) for k, v in cache.items()},
        lengths=jnp.asarray(lengths))
    tcache = {k: torch.tensor(v) for k, v in cache.items()}
    got, gc = tattn.attention_apply(
        {k: torch.tensor(v) for k, v in p.items()}, torch.tensor(x), tcfg,
        tcfg.block(), positions=torch.tensor(lengths[:, None]),
        mode="decode", cache=tcache, lengths=torch.tensor(lengths))
    assert gc is tcache
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F32_OP)
    for key in "kv":
        np.testing.assert_allclose(tcache[key].numpy(), np.asarray(rc[key]),
                                   **F32_OP)


def test_flash_expands_gqa_in_the_reference_head_order():
    """q-head i attends with KV head i // rep, as the reference's
    ``reshape(b, s, hk, rep, hd)``."""
    rng = np.random.default_rng(5)
    q = rng.normal(size=(2, 9, 6, 16)).astype(np.float32)
    k, v = (rng.normal(size=(2, 9, 2, 16)).astype(np.float32)
            for _ in range(2))
    pos = jnp.broadcast_to(jnp.arange(9)[None], (2, 9))
    ref = jattn.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), pos, pos, causal=True)
    got = tattn.flash_attention(torch.tensor(q), torch.tensor(k),
                                torch.tensor(v), causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F32_OP)


# ---------------------------------------------------------------------------
# The transformer.
# ---------------------------------------------------------------------------

def _prefill_both(jp, tp, jcfg, tcfg, prompts, impl, max_len=24):
    """Prefill each prompt alone into its own slot of a fresh cache, as
    the engines do; returns the last-position logits and the caches."""
    jflags, tflags = jtr.RunFlags(attn_impl=impl), ttr.RunFlags(
        attn_impl=impl)
    jcache = jtr.init_cache(jcfg, len(prompts), max_len)
    tcache = ttr.init_cache(tcfg, len(prompts), max_len, device=CPU)
    out = []
    for slot, prompt in enumerate(prompts):
        toks = np.asarray(prompt)[None]
        jl, jpc, _ = jtr.forward(jp, {"tokens": jnp.asarray(toks)}, jcfg,
                                 mode="prefill", flags=jflags)
        tl, tpc = ttr.forward(tp, {"tokens": torch.tensor(toks)}, tcfg,
                              mode="prefill", flags=tflags)
        out.append((jl, tl, jpc, tpc))
        jcache = jengine._merge_slot_cache(jcache, jpc, slot, len(prompt))
        _merge_slot_cache(tcache, tpc, slot, len(prompt))
    return out, jcache, tcache


@pytest.mark.parametrize("impl", ["flash", "naive"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_and_decode_match_reference(arch, impl):
    """float32: each prompt's prefill logits and cache, then one batched
    decode step at per-slot lengths: its logits and the updated cache."""
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _both(_np_params(jcfg), tcfg)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, jcfg.vocab, size=n) for n in (13, 6)]
    outs, jcache, tcache = _prefill_both(jp, tp, jcfg, tcfg, prompts, impl)
    for jl, tl, jpc, tpc in outs:
        _close(tl, jl)
        for (path, a), (tpath, b) in zip(
                sorted(_flat(jpc).items()), sorted(_flat(tpc).items())):
            assert path == tpath
            _close(b, a)
    toks = rng.integers(0, jcfg.vocab, size=(2, 1))
    lengths = np.array([13, 6])
    jl, jcache = jtr.decode_step(jp, jcache, jnp.asarray(toks),
                                 jnp.asarray(lengths, jnp.int32), jcfg,
                                 jtr.RunFlags(attn_impl=impl))
    tl, tcache = ttr.decode_step(tp, tcache, torch.tensor(toks),
                                 torch.tensor(lengths), tcfg,
                                 ttr.RunFlags(attn_impl=impl))
    assert tuple(tl.shape) == (2, jcfg.padded_vocab)
    _close(tl, jl)
    for path, a in _flat(jcache).items():
        _close(_flat(tcache)[path], a)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_bf16_close_to_reference(arch):
    """bfloat16, the activation dtype of both configs: prefill and one
    decode step, the logits within ``BF16_NORM`` of their norm (see the
    module docstring), the padding columns masked."""
    jcfg, tcfg = _cfgs(arch, "bfloat16")
    np_params = _np_params(jcfg)
    jp = jax.tree.map(jnp.asarray, np_params)
    tp = lm_params_from_jax(np_params, tcfg, CPU)
    assert _flat(tp)["embed"].dtype == torch.bfloat16
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, jcfg.vocab, size=n) for n in (12, 5)]
    outs, jcache, tcache = _prefill_both(jp, tp, jcfg, tcfg, prompts,
                                         "flash")
    toks = rng.integers(0, jcfg.vocab, size=(2, 1))
    lengths = np.array([12, 5])
    jl, _ = jtr.decode_step(jp, jcache, jnp.asarray(toks),
                            jnp.asarray(lengths, jnp.int32), jcfg)
    tl, _ = ttr.decode_step(tp, tcache, torch.tensor(toks),
                            torch.tensor(lengths), tcfg)
    v = jcfg.vocab
    for a, b in [(jl_, tl_) for jl_, tl_, _, _ in outs] + [(jl, tl)]:
        a, b = _np(a)[..., :v], _np(b)[..., :v]
        assert np.linalg.norm(b - a) <= BF16_NORM * np.linalg.norm(a)
    assert (_np(tl)[:, v:] == -1e30).all()


# ---------------------------------------------------------------------------
# Sampling and the engine.
# ---------------------------------------------------------------------------

def test_sampling_greedy():
    logits = torch.tensor([[0.0, 5.0, 1.0], [2.0, 0.0, -1.0]])
    assert sample(logits, None, temperature=0.0).tolist() == [1, 0]


def test_sampling_top_k_and_top_p_restrict_support():
    logits = torch.tensor([[0.0, 10.0, 9.0, -5.0]])
    gen = torch.Generator().manual_seed(0)
    for _ in range(20):
        assert int(sample(logits, gen, temperature=1.0, top_k=2)[0]) in (1, 2)
        assert int(sample(logits, gen, temperature=1.0, top_p=0.5)[0]) == 1


def _engines(arch, impl, dtype="float32", **ecfg):
    jcfg, tcfg = _cfgs(arch, dtype)
    np_params = _np_params(jcfg, seed=1)
    jp = jax.tree.map(jnp.asarray, np_params)
    tp = lm_params_from_jax(np_params, tcfg, CPU)
    je = jengine.DecodeEngine(jcfg, jp, jengine.EngineConfig(**ecfg),
                              flags=jtr.RunFlags(attn_impl=impl))
    te = DecodeEngine(tcfg, tp, EngineConfig(**ecfg),
                      flags=ttr.RunFlags(attn_impl=impl), device=CPU)
    return je, te


@pytest.mark.parametrize("impl", ["flash", "naive"])
@pytest.mark.parametrize("arch", ["qwen-tiny", "gemma-7b"])
def test_engine_greedy_tokens_match_reference(arch, impl):
    """Five requests of ragged prompts over two slots (so slots are
    reused mid-run): the same greedy tokens and the same step count."""
    je, te = _engines(arch, impl, n_slots=2, max_len=32, max_new=6,
                      temperature=0.0)
    rng = np.random.default_rng(8)
    prompts = [[int(t) for t in rng.integers(0, je.cfg.vocab, size=n)]
               for n in (5, 9, 3, 12, 7)]
    jreqs = [jengine.Request(rid=i, prompt=p) for i, p in enumerate(prompts)]
    treqs = [Request(rid=i, prompt=p) for i, p in enumerate(prompts)]
    je.run(jreqs)
    te.run(treqs)
    assert all(r.done and len(r.generated) == 6 for r in treqs)
    assert [r.generated for r in treqs] == [r.generated for r in jreqs]
    assert te.steps == je.steps >= 12


def test_engine_eos_frees_slot_as_reference():
    """EOS set to a token the greedy run emits: the request stops there
    and frees its one slot for the next, in both engines."""
    je, te = _engines("qwen-tiny", "flash", n_slots=1, max_len=16,
                      max_new=2)
    probe = Request(rid=0, prompt=[5, 6])
    te.run([probe])
    eos = probe.generated[1]
    je, te = _engines("qwen-tiny", "flash", n_slots=1, max_len=16,
                      max_new=8, eos_id=eos)
    jreqs = [jengine.Request(rid=i, prompt=[5, 6]) for i in range(2)]
    treqs = [Request(rid=i, prompt=[5, 6]) for i in range(2)]
    je.run(jreqs)
    te.run(treqs)
    assert all(r.done and r.generated[-1] == eos for r in treqs)
    assert [r.generated for r in treqs] == [r.generated for r in jreqs]
    assert not te.active.any()


@pytest.mark.parametrize("arch", ["qwen-tiny", "gemma-7b"])
def test_engine_bf16_matches_step_by_step_decode(arch):
    """bfloat16: the engine's greedy tokens equal a manual loop of
    prefill and ``decode_step`` on the port (the reference's
    ``test_engine_matches_manual_decode``)."""
    _, te = _engines(arch, "flash", "bfloat16", n_slots=2, max_len=32,
                     max_new=6, temperature=0.0)
    prompt = [3, 1, 4, 1, 5]
    req = Request(rid=0, prompt=list(prompt))
    te.run([req])
    cfg, params = te.cfg, te.params
    cache = ttr.init_cache(cfg, 1, 32, device=CPU)
    logits, pcache = ttr.forward(params, {"tokens": torch.tensor([prompt])},
                                 cfg, mode="prefill")
    _merge_slot_cache(cache, pcache, 0, len(prompt))
    cur = int(torch.argmax(logits[0, -1].float()))
    manual = [cur]
    lengths = torch.tensor([len(prompt)])
    for _ in range(5):
        lg, cache = ttr.decode_step(params, cache, torch.tensor([[cur]]),
                                    lengths, cfg)
        cur = int(torch.argmax(lg[0].float()))
        manual.append(cur)
        lengths = lengths + 1
    assert req.generated == manual


def test_serve_launcher_runs_on_the_cpu(capsys):
    engine, reqs = tserve.main(["--arch", "gemma-7b", "--preset", "tiny",
                                "--device", "cpu", "--requests", "3",
                                "--max-new", "4"])
    assert all(r.done and len(r.generated) == 4 for r in reqs)
    assert "tok/s" in capsys.readouterr().out
