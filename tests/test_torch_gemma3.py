"""The port's sliding-window attention, logit soft-capping, positions
given in the batch and Gemma3's local:global layers against the JAX
package's, on the CPU.

Both packages get the same numpy inputs and the reference's parameters
(converted by ``lm_params_from_jax``, the norm scales moved off their
zero init) at tests/test_models.py's tiny layout of ``gemma3-4b``: 4
layers of d 64 under a (2, 1) local:global pattern (a group of local,
local, global and a remainder segment of one local layer), window 8, 4
q heads over 2 kv heads of 16.  The port's "flash" attention runs the
CUDA kernels' plain version here.

Tolerances: the attention functions at 2e-5 (f32 against f32 summed
in another order, tests/test_models.py's own tolerance for
``swa_attention``); the tiny model's logits, caches and gradients at
1e-4 of each value and of the largest one (tests/test_torch_llm.py's
``F32_MODEL``); in bf16 the logits within ``BF16_NORM`` of their norm
(tests/test_torch_llm.py's module docstring says why).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models import attention as jattn
from repro.models import transformer as jtr
from repro.serve import engine as jengine
from repro_torch.configs import base as tbase
from repro_torch.convert import lm_params_from_jax, train_state_from_jax
from repro_torch.kernels.flash_attention import (FlashAttentionFn,
                                                 flash_attention_plain)
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as ttr
from repro_torch.serve.engine import (DecodeEngine, EngineConfig, Request,
                                      _merge_slot_cache)
from repro_torch.train import checkpoint as tckpt
from test_models import tiny
from test_torch_llm import (BF16_NORM, F32_MODEL, _close, _flat,
                            _np_params, _port_cfg)

CPU = torch.device("cpu")
ATTN_TOL = dict(atol=2e-5, rtol=2e-5)
IMPLS = ("flash", "naive", "chunked_q")
# prompt lengths of the model tests: 27 > 2w runs the blocked swa branch
# with a padded tail (27 = 3 blocks of 8 + 3), 13 the naive one
TRAIN_S = 27


def _gemma3(dtype="float32", **over):
    """(JAX config, port config) of the tiny Gemma3."""
    jcfg = tiny(jbase.get_config("gemma3-4b"), dtype=dtype, **over)
    return jcfg, _port_cfg(jcfg)


def _qkv(rng, b, s, t, hq, hk, hd, scale=1.0):
    q = (scale * rng.normal(size=(b, s, hq, hd))).astype(np.float32)
    k = (scale * rng.normal(size=(b, t, hk, hd))).astype(np.float32)
    v = rng.normal(size=(b, t, hk, hd)).astype(np.float32)
    return q, k, v


def _jt(*arrays):
    return [jnp.asarray(a) for a in arrays], [torch.tensor(a) for a in arrays]


def _positions(b, s, offset=0):
    return np.broadcast_to(np.arange(s)[None] + offset, (b, s)).copy()


# ---------------------------------------------------------------------------
# The attention functions.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("softcap", [0.0, 2.0])
@pytest.mark.parametrize("s", [13, 43], ids=["naive-branch", "blocked"])
@pytest.mark.parametrize("w", [8, 16, 17])
def test_swa_attention_matches_reference(w, s, softcap):
    """GQA 4 over 2 heads; s = 43 runs the blocked branch with a padded
    tail at every w (43 = 5·8 + 3 = 2·16 + 11 = 2·17 + 9), s = 13 the
    naive branch (s <= 2w) masked by positions offset by 5."""
    rng = np.random.default_rng(w * 100 + s)
    q, k, v = _qkv(rng, 2, s, s, 4, 2, 16, scale=1.5)
    pos = _positions(2, s, offset=5)
    (jq, jk, jv, jp), (tq, tk, tv, tp) = _jt(q, k, v, pos)
    ref = jax.jit(functools.partial(jattn.swa_attention, window=w,
                                    softcap=softcap))(jq, jk, jv, jp, jp)
    got = tattn.swa_attention(tq, tk, tv, tp, tp, window=w, softcap=softcap)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **ATTN_TOL)
    # and the windowed naive attention, the function it blocks
    naive = tattn.naive_attention(tq, tk, tv, tp, tp, window=w,
                                  softcap=softcap)
    np.testing.assert_allclose(got.numpy(), naive.numpy(), **ATTN_TOL)


@pytest.mark.parametrize("softcap", [0.0, 3.0])
@pytest.mark.parametrize("window", [0, 8])
def test_naive_attention_matches_reference(window, softcap):
    """Queries at positions 7..26 over keys at 0..29 with two keys
    marked as padding (negative positions): the window and causal masks
    by positions, GQA, the soft-cap before the mask."""
    rng = np.random.default_rng(11)
    q, k, v = _qkv(rng, 2, 20, 30, 4, 2, 16, scale=1.5)
    q_pos = _positions(2, 20, offset=7)
    k_pos = _positions(2, 30)
    k_pos[:, 3:5] = -1
    (jq, jk, jv, jqp, jkp), (tq, tk, tv, tqp, tkp) = _jt(q, k, v, q_pos,
                                                         k_pos)
    ref = jattn.naive_attention(jq, jk, jv, jqp, jkp, causal=True,
                                window=window, softcap=softcap)
    got = tattn.naive_attention(tq, tk, tv, tqp, tkp, causal=True,
                                window=window, softcap=softcap)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **ATTN_TOL)


@pytest.mark.parametrize("window,softcap", [(0, 0.0), (8, 3.0)])
def test_chunked_q_attention_matches_reference(window, softcap):
    """Blocks of 16 q rows over 43 (a padded tail of 5), GQA."""
    rng = np.random.default_rng(12)
    q, k, v = _qkv(rng, 2, 43, 43, 4, 2, 16, scale=1.5)
    pos = _positions(2, 43, offset=2)
    (jq, jk, jv, jp), (tq, tk, tv, tp) = _jt(q, k, v, pos)
    ref = jattn.chunked_q_attention(jq, jk, jv, jp, jp, causal=True,
                                    window=window, softcap=softcap,
                                    block_q=16)
    got = tattn.chunked_q_attention(tq, tk, tv, tp, tp, causal=True,
                                    window=window, softcap=softcap,
                                    block_q=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **ATTN_TOL)


@pytest.mark.parametrize("softcap", [0.0, 3.0])
@pytest.mark.parametrize("window", [0, 8])
def test_decode_attention_matches_reference(window, softcap):
    """One token a sequence at lengths 0, 7, 12 and 19 over a cache of
    20: the window keeps keys in (lengths - window, lengths]."""
    rng = np.random.default_rng(13)
    q, k, v = _qkv(rng, 4, 1, 20, 4, 2, 16, scale=1.5)
    lengths = np.array([0, 7, 12, 19])
    (jq, jk, jv, jl), (tq, tk, tv, tl) = _jt(q, k, v, lengths)
    ref = jattn.decode_attention(jq, jk, jv, jl, window=window,
                                 softcap=softcap)
    got = tattn.decode_attention(tq, tk, tv, tl, window=window,
                                 softcap=softcap)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **ATTN_TOL)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_flash_plain_soft_cap_matches_reference(causal):
    """The kernels' plain version with a soft-cap that bites (scores of
    ~10 capped at 2) against the reference's ``naive_attention``, MHA,
    ragged S and T over the kernel's tiles; and the port's GQA
    ``flash_attention`` against the reference's blocked one."""
    rng = np.random.default_rng(14)
    q, k, v = _qkv(rng, 2, 70, 70, 4, 4, 32, scale=2.0)
    pos = _positions(2, 70)
    (jq, jk, jv, jp), (tq, tk, tv, _) = _jt(q, k, v, pos)
    ref = jattn.naive_attention(jq, jk, jv, jp, jp, causal=causal,
                                softcap=2.0)
    got = flash_attention_plain(tq, tk, tv, causal=causal, softcap=2.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **ATTN_TOL)
    uncapped = flash_attention_plain(tq, tk, tv, causal=causal)
    assert np.abs(uncapped.numpy() - np.asarray(ref)).max() > 1e-2
    g_ref = jattn.flash_attention(jq, jk[:, :, :2], jv[:, :, :2], jp, jp,
                                  causal=causal, softcap=2.0, block_k=16)
    g_got = tattn.flash_attention(tq, tk[:, :, :2], tv[:, :, :2],
                                  causal=causal, softcap=2.0)
    np.testing.assert_allclose(g_got.numpy(), np.asarray(g_ref), **ATTN_TOL)


def _capped_f64(q, k, v, softcap):
    sc = torch.einsum("bqhd,bkhd->bhqk", q, k) * q.shape[3] ** -0.5
    sc = softcap * torch.tanh(sc / softcap)
    keep = torch.ones(q.shape[1], k.shape[1], dtype=torch.bool).tril()
    sc = sc.masked_fill(~keep, float("-inf"))
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(sc, -1), v)


def test_flash_function_backward_with_soft_cap_matches_float64():
    """``FlashAttentionFn`` at a soft-cap of 2: the forward through the
    plain version, the backward through the recompute's ``tanh``, each
    of dq, dk, dv within 1e-5 of float64 autograd's (in norm)."""
    gen = torch.Generator().manual_seed(15)
    q, k, v, do = (torch.randn((1, 70, 2, 32), generator=gen) * c
                   for c in (2.0, 2.0, 1.0, 1.0))
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    out = FlashAttentionFn.apply(*ins, True, flash_attention_plain, 2.0)
    got = torch.autograd.grad(out, ins, do)
    wide = [t.double().requires_grad_() for t in (q, k, v)]
    ref_out = _capped_f64(*wide, 2.0)
    want = torch.autograd.grad(ref_out, wide, do.double())
    assert float((out.detach().double() - ref_out.detach()).abs().max()) \
        < 1e-5
    for name, g, w in zip("qkv", got, want):
        rel = float((g.double() - w).norm() / w.norm())
        assert rel < 1e-5, (name, rel)
    # a backward that ignores the cap is far off
    plain = torch.autograd.grad(FlashAttentionFn.apply(
        *ins, True, flash_attention_plain), ins, do)
    assert float((plain[0].double() - want[0]).norm() / want[0].norm()) > 0.1


# ---------------------------------------------------------------------------
# The tiny Gemma3.
# ---------------------------------------------------------------------------

def test_segments_specs_and_cache_match_reference():
    """The tiny layout's two segments and their per-position windows and
    rope_theta; at full width every spec path and shape (seg0: 5 groups
    of 6 positions, seg1: 4 local layers), the parameter counts of the
    34 layers and of the 8-layer training cut; the cache at the tiny
    layout, full length for the windowed layers."""
    jcfg, tcfg = _gemma3()
    segs = tcfg.layer_segments()
    assert [([(d.window, d.rope_theta) for d in descs], rep)
            for descs, rep in segs] == [
        ([(8, 1e4), (8, 1e4), (0, 1e6)], 1), ([(8, 1e4)], 1)]
    full_j, full_t = jbase.get_config("gemma3-4b"), tbase.get_config(
        "gemma3-4b")
    want = {"/".join(p.key for p in path): a.shape for path, a in
            jax.tree_util.tree_flatten_with_path(
                jtr.model_specs(full_j),
                is_leaf=lambda x: hasattr(x, "init"))[0]}
    got = {p: s.shape for p, s in _flat(ttr.model_specs(full_t)).items()}
    assert got == want
    assert got["segments/seg0/pos5/attn/wq"] == (5, 2560, 2048)
    assert got["segments/seg1/pos0/attn/wk"] == (4, 2560, 1024)
    assert ttr.count_params(full_t) == jtr.count_params(full_j) \
        == 3_879_907_840
    cut = dataclasses.replace(full_t, n_layers=8)
    assert [rep for _, rep in cut.layer_segments()] == [1, 2]
    assert ttr.count_params(cut) == 1_426_106_880
    jcache = {"/".join(p.key for p in path): a.shape for path, a in
              jax.tree_util.tree_flatten_with_path(
                  jtr.init_cache(jcfg, 3, 40))[0]}
    tcache = {p: tuple(t.shape) for p, t in
              _flat(ttr.init_cache(tcfg, 3, 40, device=CPU)).items()}
    assert tcache == jcache


@functools.cache
def _reference(dtype="float32"):
    """The reference's tiny Gemma3 at ``dtype`` on one set of inputs:
    its numpy parameters, the train logits of TRAIN_S tokens, and each
    prompt's prefill logits and cache, then three batched decode steps
    past the window."""
    jcfg, _ = _gemma3(dtype)
    np_params = _np_params(jcfg)
    jp = jax.tree.map(jnp.asarray, np_params)
    train_fn = jax.jit(functools.partial(jtr.forward, cfg=jcfg))
    prefill_fn = jax.jit(functools.partial(jtr.forward, cfg=jcfg,
                                           mode="prefill"))
    decode_fn = jax.jit(functools.partial(jtr.decode_step, cfg=jcfg))
    rng = np.random.default_rng(21)
    toks = rng.integers(0, jcfg.vocab, size=(2, TRAIN_S))
    train, _, _ = train_fn(jp, {"tokens": jnp.asarray(toks)})
    prompts = [rng.integers(0, jcfg.vocab, size=n) for n in (TRAIN_S, 13)]
    cache = jtr.init_cache(jcfg, 2, 40)
    prefills = []
    for slot, prompt in enumerate(prompts):
        lg, pc, _ = prefill_fn(jp, {"tokens": jnp.asarray(prompt[None])})
        prefills.append((lg, pc))
        cache = jengine._merge_slot_cache(cache, pc, slot, len(prompt))
    steps = rng.integers(0, jcfg.vocab, size=(3, 2, 1))
    lengths = np.array([len(p) for p in prompts])
    decodes = []
    for t in range(3):
        lg, cache = decode_fn(jp, cache, jnp.asarray(steps[t]),
                              jnp.asarray(lengths + t, jnp.int32))
        decodes.append(lg)
    return dict(np_params=np_params, toks=toks, train=train,
                prompts=prompts, prefills=prefills, steps=steps,
                lengths=lengths, decodes=decodes, cache=cache)


def _port_run(ref, tcfg, impl, params=None):
    tp = params or lm_params_from_jax(ref["np_params"], tcfg, CPU)
    flags = ttr.RunFlags(attn_impl=impl)
    train, _ = ttr.forward(tp, {"tokens": torch.tensor(ref["toks"])}, tcfg,
                           flags=flags)
    cache = ttr.init_cache(tcfg, 2, 40, device=CPU)
    prefills = []
    for slot, prompt in enumerate(ref["prompts"]):
        lg, pc = ttr.forward(tp, {"tokens": torch.tensor(prompt[None])},
                             tcfg, mode="prefill", flags=flags)
        prefills.append((lg, pc))
        _merge_slot_cache(cache, pc, slot, len(prompt))
    decodes = []
    for t in range(3):
        lg, cache = ttr.decode_step(tp, cache, torch.tensor(ref["steps"][t]),
                                    torch.tensor(ref["lengths"] + t), tcfg,
                                    flags)
        decodes.append(lg)
    return train, prefills, decodes, cache


@pytest.mark.parametrize("impl", IMPLS)
def test_tiny_gemma3_matches_reference(impl):
    """float32, at each ``attn_impl`` (the local layers run swa at all
    three): the train logits of 27 tokens (the blocked swa branch with a
    tail), each prompt's prefill logits and cache (27 and 13 tokens),
    then three batched decode steps whose windows slide past the first
    keys, and the cache they wrote."""
    ref = _reference()
    _, tcfg = _gemma3()
    train, prefills, decodes, cache = _port_run(ref, tcfg, impl)
    _close(train, ref["train"])
    for (tl, tpc), (jl, jpc) in zip(prefills, ref["prefills"]):
        _close(tl, jl)
        assert sorted(_flat(tpc)) == sorted(
            "/".join(p.key for p in path) for path, _ in
            jax.tree_util.tree_flatten_with_path(jpc)[0])
        for path, a in jax.tree_util.tree_flatten_with_path(jpc)[0]:
            _close(_flat(tpc)["/".join(p.key for p in path)], a)
    for tl, jl in zip(decodes, ref["decodes"]):
        _close(tl, jl)
    for path, a in jax.tree_util.tree_flatten_with_path(ref["cache"])[0]:
        _close(_flat(cache)["/".join(p.key for p in path)], a)


def test_tiny_gemma3_bf16_close_to_reference():
    """bfloat16, Gemma3's activation dtype: every logit of the run above
    within ``BF16_NORM`` of its norm, the padding columns masked."""
    ref = _reference("bfloat16")
    jcfg, tcfg = _gemma3("bfloat16")
    train, prefills, decodes, _ = _port_run(ref, tcfg, "flash")
    assert train.dtype == torch.bfloat16
    v = jcfg.vocab
    masked = torch.tensor(-1e30, dtype=torch.bfloat16).item()
    pairs = [(train, ref["train"])] + [
        (t[0], j[0]) for t, j in zip(prefills, ref["prefills"])] + list(
        zip(decodes, ref["decodes"]))
    for got, want in pairs:
        got = got.float().numpy()
        want = np.asarray(want, np.float32)
        assert (got[..., v:] == masked).all()
        got, want = got[..., :v], want[..., :v]
        assert np.linalg.norm(got - want) <= BF16_NORM * np.linalg.norm(want)


@pytest.mark.parametrize("softcap", [0.0, 5.0])
def test_global_layers_and_soft_capped_logits_match_reference(softcap):
    """A dense config with ``global_layers`` (Gemma-7B's tiny layout,
    global layers 0 and 3, local ones between: three segments) and, at
    a soft-cap of 5, the attention scores and the logits soft-capped
    (the logits reach ~50 unbounded): train, prefill and decode logits
    at f32 through the flash path."""
    jcfg = tiny(jbase.get_config("gemma-7b"), dtype="float32",
                local_window=8, global_layers=(0, 3), logit_softcap=softcap)
    tcfg = _port_cfg(jcfg)
    assert [rep for _, rep in tcfg.layer_segments()] == [1, 2, 1]
    np_params = _np_params(jcfg)
    jp = jax.tree.map(jnp.asarray, np_params)
    tp = lm_params_from_jax(np_params, tcfg, CPU)
    toks = np.random.default_rng(22).integers(0, jcfg.vocab, size=(2, 21))
    jl, _, _ = jax.jit(functools.partial(jtr.forward, cfg=jcfg))(
        jp, {"tokens": jnp.asarray(toks)})
    tl, _ = ttr.forward(tp, {"tokens": torch.tensor(toks)}, tcfg)
    _close(tl, jl)
    if softcap:
        live = tl[..., :jcfg.vocab]
        assert float(live.abs().max()) < softcap
    _, jc, _ = jax.jit(functools.partial(jtr.forward, cfg=jcfg,
                                         mode="prefill"))(
        jp, {"tokens": jnp.asarray(toks[:, :17])})
    jc = jax.tree.map(lambda a: jnp.pad(a, [(0, 0), (0, 0), (0, 4)]
                                        + [(0, 0)] * (a.ndim - 3)), jc)
    _, tc = ttr.forward(tp, {"tokens": torch.tensor(toks[:, :17])}, tcfg,
                        mode="prefill")
    tcache = ttr.init_cache(tcfg, 2, 21, device=CPU)
    for path, t in _flat(tc).items():
        _flat(tcache)[path][:, :, :17] = t
    lengths = np.array([17, 17])
    jd, _ = jax.jit(functools.partial(jtr.decode_step, cfg=jcfg))(
        jp, jc, jnp.asarray(toks[:, 17:18]), jnp.asarray(lengths, jnp.int32))
    td, _ = ttr.decode_step(tp, tcache, torch.tensor(toks[:, 17:18]),
                            torch.tensor(lengths), tcfg)
    _close(td, jd)


def _positions_case(kind):
    if kind == "offset":
        return np.stack([np.arange(12) + 3, np.arange(12) + 40])
    # two packed documents a row, restarting at 0
    return np.stack([np.r_[np.arange(7), np.arange(5)],
                     np.r_[np.arange(4), np.arange(8)]])


@pytest.mark.parametrize("impl,kind", [
    ("flash", "offset"), ("naive", "offset"), ("chunked_q", "offset"),
    ("naive", "packed"), ("chunked_q", "packed")])
def test_positions_in_the_batch_match_reference(impl, kind):
    """``batch["positions"]`` drive RoPE (at 1e4 and, on the global
    layer, 1e6) and the masks: an offset ``arange`` on every path (the
    kernel's index mask is the position mask there), packed documents
    on the paths that mask by positions (12 tokens <= 2w: the local
    layers' naive branch masks by positions too)."""
    jcfg, tcfg = _gemma3()
    np_params = _np_params(jcfg)
    jp = jax.tree.map(jnp.asarray, np_params)
    tp = lm_params_from_jax(np_params, tcfg, CPU)
    toks = np.random.default_rng(23).integers(0, jcfg.vocab, size=(2, 12))
    pos = _positions_case(kind)
    jl, _, _ = jtr.forward(jp, {"tokens": jnp.asarray(toks),
                                "positions": jnp.asarray(pos)}, jcfg,
                           flags=jtr.RunFlags(attn_impl=impl))
    tl, _ = ttr.forward(tp, {"tokens": torch.tensor(toks),
                             "positions": torch.tensor(pos)}, tcfg,
                        flags=ttr.RunFlags(attn_impl=impl))
    _close(tl, jl)
    # RoPE is relative: an offset leaves the function as it was, packing
    # changes it
    default, _ = ttr.forward(tp, {"tokens": torch.tensor(toks)}, tcfg,
                             flags=ttr.RunFlags(attn_impl=impl))
    if kind == "offset":
        _close(tl, default)
    else:
        assert float((tl - default).abs().max()) > 1e-2


def test_flash_refuses_positions_its_index_mask_is_not():
    """Packed positions at ``attn_impl="flash"`` raise, naming the paths
    that mask by positions; a wrong shape raises too."""
    _, tcfg = _gemma3()
    tp = ttr.init(tcfg, torch.Generator().manual_seed(0))
    toks = torch.zeros((2, 12), dtype=torch.int64)
    packed = torch.tensor(_positions_case("packed"))
    with pytest.raises(ValueError, match="'naive' or 'chunked_q'"):
        ttr.forward(tp, {"tokens": toks, "positions": packed}, tcfg)
    with pytest.raises(ValueError, match="shape"):
        ttr.forward(tp, {"tokens": toks, "positions": packed[:, :5]}, tcfg,
                    flags=ttr.RunFlags(attn_impl="naive"))


def _conditioned(np_params, d_model):
    """Each stacked matrix scaled from the reference's fan-in (the layer
    count) to its input width, the embedding to ``d_model**-0.5``."""
    def leaf(path, a):
        if a.ndim == 3:
            return a * np.float32(np.sqrt(a.shape[0] / a.shape[1]))
        if path[-1].key == "embed":
            return a * np.float32(d_model ** -0.5)
        return a
    return jax.tree_util.tree_map_with_path(leaf, np_params)


def test_loss_and_gradients_match_reference():
    """f32: ``loss_fn`` of the tiny Gemma3 over 2 x 27 tokens (the
    blocked swa branch) and every gradient against ``jax.grad`` of the
    reference's, each within 1e-5 of its largest element, on weights
    conditioned to fan-in = width (chip_smoke.py's ``condition``).  At
    the reference's init the gradient is ill-conditioned: the two
    frameworks' f32 sums put single elements 3.5e-4 of the leaf's
    largest apart even with every layer global (no window; read on the
    CPU), where the conditioned gradients agree to 1.1e-6."""
    ref = _reference()
    jcfg, tcfg = _gemma3()
    np_params = _conditioned(ref["np_params"], jcfg.d_model)
    jp = jax.tree.map(jnp.asarray, np_params)
    batch = {"tokens": jnp.asarray(ref["toks"])}
    loss = functools.partial(jtr.loss_fn, cfg=jcfg,
                             flags=jtr.RunFlags(remat=False))
    (jtotal, _), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jp, batch)
    tp = lm_params_from_jax(np_params, tcfg, CPU, torch.float32)
    leaves = [t.requires_grad_() for t in tckpt.tree_leaves(tp)]
    ttotal, _ = ttr.loss_fn(tp, {"tokens": torch.tensor(ref["toks"])}, tcfg)
    tgrads = torch.autograd.grad(ttotal, leaves)
    np.testing.assert_allclose(float(ttotal.detach()), float(jtotal),
                               rtol=1e-5)
    jflat = {"/".join(p.key for p in path): g for path, g in
             jax.tree_util.tree_flatten_with_path(jgrads)[0]}
    assert sorted(jflat) == sorted(_flat(tp))
    for path, got in zip(_flat(tp), tgrads):
        want = np.asarray(jflat[path])
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=path)


def test_train_state_from_jax_takes_both_segments():
    """A reference train state of the tiny Gemma3 (two segments) carries
    over: masters and moments, every path, f32."""
    from repro.train import train_state as jts
    jcfg, tcfg = _gemma3()
    jstate = jax.tree.map(np.asarray,
                          jts.init_train_state(jcfg, jax.random.PRNGKey(0)))
    state = train_state_from_jax(jstate, tcfg, CPU)
    flat = _flat(state["params"])
    assert {p.split("/")[1] for p in flat if p.startswith("segments")} == \
        {"seg0", "seg1"}
    for path, a in jax.tree_util.tree_flatten_with_path(
            jstate["params"])[0]:
        key = "/".join(p.key for p in path)
        assert flat[key].dtype == torch.float32
        np.testing.assert_array_equal(flat[key].numpy(), a)


ENGINE = dict(n_slots=2, max_len=40, max_new=6, temperature=0.0)
ENGINE_PROMPTS = (5, 30, 19)


@functools.cache
def _reference_engine():
    """The reference engine's greedy tokens and steps on the prompts of
    ``ENGINE_PROMPTS`` tokens (its flash attention)."""
    jcfg, _ = _gemma3()
    np_params = _np_params(jcfg, seed=1)
    je = jengine.DecodeEngine(jcfg, jax.tree.map(jnp.asarray, np_params),
                              jengine.EngineConfig(**ENGINE))
    rng = np.random.default_rng(24)
    prompts = [[int(t) for t in rng.integers(0, jcfg.vocab, size=n)]
               for n in ENGINE_PROMPTS]
    jreqs = [jengine.Request(rid=i, prompt=p) for i, p in enumerate(prompts)]
    je.run(jreqs)
    return np_params, prompts, [r.generated for r in jreqs], je.steps


@pytest.mark.parametrize("impl", ["flash", "naive"])
def test_engine_greedy_tokens_match_reference(impl):
    """float32: three requests of prompts of 5 to 30 tokens over two
    slots (both swa branches, a slot reused, windows sliding during
    decode): the port's
    engine at each ``attn_impl`` gives the same greedy tokens and steps
    as the reference's."""
    np_params, prompts, tokens, steps = _reference_engine()
    _, tcfg = _gemma3()
    te = DecodeEngine(tcfg, lm_params_from_jax(np_params, tcfg, CPU),
                      EngineConfig(**ENGINE),
                      flags=ttr.RunFlags(attn_impl=impl), device=CPU)
    treqs = [Request(rid=i, prompt=p) for i, p in enumerate(prompts)]
    te.run(treqs)
    assert all(r.done and len(r.generated) == 6 for r in treqs)
    assert [r.generated for r in treqs] == tokens
    assert te.steps == steps
