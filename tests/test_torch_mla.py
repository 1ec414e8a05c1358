"""The port's multi-head latent attention (MLA), MiniCPM3 and the flash
kernels' split head dims against the JAX package's, on the CPU.

The flash kernels take a value head dim ``dv`` apart from q's and k's
``dk``, as the Pallas kernel does: their plain version is held to
``flash_attention_pallas(interpret=True)`` and to the reference's
``naive_attention`` at MiniCPM3-4B's (96, 64) and its tiny preset's
(48, 32), with ragged S and T.  The model tests run the tiny preset of
``minicpm3-4b`` (``reduced_config(..., "tiny")``: 2 layers of d 128, 4
heads, q_lora 64, kv_lora 32, qk_nope 32 + qk_rope 16 against v 32) on
the same numpy inputs and the reference's parameters (converted by
``lm_params_from_jax``, the norm scales moved off their zero init); the
port's "flash" attention runs the CUDA kernels' plain version here.

Tolerances: the attention functions at 2e-5 (f32 against f32 summed in
another order, tests/test_torch_gemma3.py's ``ATTN_TOL``); the
backward at 1e-5 of float64's norm; an MLA layer's outputs and caches
(five products and two norms around the attention) and the model's
logits, caches and gradients at 1e-4 of each value and of the largest
one (tests/test_torch_llm.py's ``F32_MODEL``), the gradients at 1e-5 on
conditioned weights (tests/test_torch_gemma3.py says why); in bf16 the
logits within ``BF16_NORM`` of their norm.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.kernels.flash_attention import flash_attention_pallas
from repro.launch.train import reduced_config as j_reduced_config
from repro.models import attention as jattn
from repro.models import transformer as jtr
from repro.serve import engine as jengine
from repro_torch.configs import base as tbase
from repro_torch.convert import lm_params_from_jax, train_state_from_jax
from repro_torch.kernels.flash_attention import (HEAD_DIMS, SPLIT_HEAD_DIMS,
                                                 VARIANTS, FlashAttentionFn,
                                                 flash_attention_ffma,
                                                 flash_attention_plain,
                                                 flash_attention_wgmma,
                                                 kernel_tiles,
                                                 kernel_variant)
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as ttr
from repro_torch.serve.engine import (DecodeEngine, EngineConfig, Request,
                                      _merge_slot_cache)
from repro_torch.train import checkpoint as tckpt
from test_torch_gemma3 import ATTN_TOL, _conditioned
from test_torch_llm import (BF16_NORM, _close, _flat, _np_params,
                            _port_cfg)

CPU = torch.device("cpu")
ARCH = "minicpm3-4b"
# MiniCPM3-4B at full width: the reference's count_params, and the
# 16-layer training cut's
FULL_PARAMS = 4_262_025_728
TRAIN_CUT = (16, 1_378_978_304)
# the tiny model's runs: train logits of TRAIN_S tokens (a partial q and
# kv tile of the (48, 32) kernel's 64 x 64 tiles), prompts of PROMPTS
# tokens into a cache of MAX_LEN rows, DECODE_STEPS batched decode steps
TRAIN_S = 70
PROMPTS = (TRAIN_S, 13)
MAX_LEN = 80
DECODE_STEPS = 4


def _cfgs(dtype="float32"):
    """(JAX config, port config) of the tiny MiniCPM3 at ``dtype``."""
    jcfg = dataclasses.replace(j_reduced_config(ARCH, "tiny"), dtype=dtype)
    return jcfg, _port_cfg(jcfg)


def _split_qkv(rng, b, s, t, h, dk, dv, scale=1.0):
    q = (scale * rng.normal(size=(b, s, h, dk))).astype(np.float32)
    k = (scale * rng.normal(size=(b, t, h, dk))).astype(np.float32)
    v = rng.normal(size=(b, t, h, dv)).astype(np.float32)
    return q, k, v


def _path(path) -> str:
    return "/".join(p.key for p in path)


# ---------------------------------------------------------------------------
# The flash kernels at split head dims.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("dk,dv", SPLIT_HEAD_DIMS)
def test_flash_plain_split_head_dims_match_pallas(dk, dv, causal):
    """q, k of ``dk`` and v of ``dv``: the plain version (at its kernel's
    tiles) against the Pallas kernel in interpret mode at 128 rows in
    tiles of 32 (the Pallas kernel asserts divisibility), output
    ``(B, S, H, dv)``."""
    rng = np.random.default_rng(dk + dv)
    q, k, v = _split_qkv(rng, 2, 128, 128, 2, dk, dv, scale=1.5)
    ref = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal=causal, block_q=32,
                                 block_k=32, interpret=True)
    got = flash_attention_plain(torch.tensor(q), torch.tensor(k),
                                torch.tensor(v), causal=causal)
    assert tuple(got.shape) == (2, 128, 2, dv) == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **ATTN_TOL)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_flash_plain_at_wgmma_split_tiles_match_pallas(causal):
    """The plain version at the tiles of the wgmma kernel's bf16 (96, 64)
    instance (128 q rows, ``kernel_tiles``' kv rows) against the Pallas
    kernel in interpret mode at 256 rows in the same tiles, in f32 at
    ``ATTN_TOL``: the blocking the card's main path walks, output
    ``(B, S, H, 64)``."""
    bq, bk = kernel_tiles(torch.bfloat16, 96, 64)
    assert bq == 128 and kernel_variant(torch.bfloat16, 96, 64) == "wgmma"
    rng = np.random.default_rng(7)
    q, k, v = _split_qkv(rng, 1, 256, 256, 2, 96, 64, scale=1.5)
    ref = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal=causal, block_q=bq,
                                 block_k=bk, interpret=True)
    got = flash_attention_plain(torch.tensor(q), torch.tensor(k),
                                torch.tensor(v), causal=causal, block_q=bq,
                                block_k=bk)
    assert tuple(got.shape) == (1, 256, 2, 64) == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **ATTN_TOL)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("dk,dv", SPLIT_HEAD_DIMS)
def test_flash_plain_split_head_dims_ragged_match_naive(dk, dv, causal):
    """Ragged S = 70 and T = 101 (a partial q tile and a partial kv tile
    of the kernel's: BK is 64 at (48, 32), 32 at (96, 64)) against the
    reference's ``naive_attention``, which scales by ``dk**-0.5`` and
    reads ``dv`` from v; the causal mask top-left."""
    rng = np.random.default_rng(3 * dk + dv)
    q, k, v = _split_qkv(rng, 2, 70, 101, 3, dk, dv, scale=1.5)
    pos_q = np.broadcast_to(np.arange(70)[None], (2, 70))
    pos_k = np.broadcast_to(np.arange(101)[None], (2, 101))
    ref = jattn.naive_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), jnp.asarray(pos_q),
                                jnp.asarray(pos_k), causal=causal)
    got = flash_attention_plain(torch.tensor(q), torch.tensor(k),
                                torch.tensor(v), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **ATTN_TOL)
    # the head dim an MLA port is likeliest to mix up: dv**-0.5 in place
    # of dk**-0.5 is far off
    wrong = flash_attention_plain(torch.tensor(q) * (dk / dv) ** 0.5,
                                  torch.tensor(k), torch.tensor(v),
                                  causal=causal)
    assert np.abs(wrong.numpy() - np.asarray(ref)).max() > 1e-2


def _f64_attention(q, k, v):
    sc = torch.einsum("bqhd,bkhd->bhqk", q, k) * q.shape[3] ** -0.5
    keep = torch.ones(q.shape[1], k.shape[1], dtype=torch.bool).tril()
    sc = sc.masked_fill(~keep, float("-inf"))
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(sc, -1), v)


@pytest.mark.parametrize("dk,dv", SPLIT_HEAD_DIMS)
def test_flash_function_backward_at_split_head_dims(dk, dv):
    """``FlashAttentionFn`` at dk != dv: the forward through the plain
    version, the backward through ``recompute_attention``; dq and dk of
    ``dk`` wide, dv of ``dv`` wide, each within 1e-5 of float64
    autograd's in norm."""
    gen = torch.Generator().manual_seed(dk)
    q, k = (torch.randn((1, 70, 2, dk), generator=gen) * 1.5
            for _ in range(2))
    v, do = (torch.randn((1, 70, 2, dv), generator=gen) for _ in range(2))
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    out = FlashAttentionFn.apply(*ins, True, flash_attention_plain)
    got = torch.autograd.grad(out, ins, do)
    wide = [t.double().requires_grad_() for t in (q, k, v)]
    ref_out = _f64_attention(*wide)
    want = torch.autograd.grad(ref_out, wide, do.double())
    assert float((out.detach().double() - ref_out.detach()).abs().max()) \
        < 1e-5
    for name, g, w in zip("qkv", got, want):
        assert g.shape == w.shape
        rel = float((g.double() - w).norm() / w.norm())
        assert rel < 1e-5, (name, rel)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_variant_table_reads_dtype_dk_dv(dtype):
    """Every equal pair of ``HEAD_DIMS`` keeps its variant (the wgmma
    kernel at bf16 64, 80, 128 and 256, bf16 64 at its 128-row kv tile as
    (96, 64); the FFMA kernel elsewhere); bf16 (96, 64) runs on the
    wgmma kernel at its 128-row q tile, f32 (96, 64) and both (48, 32) on
    the FFMA kernel with the kv tile that the larger of dk and dv sets;
    ``kernel_variant(dtype, hd)`` is ``kernel_variant(dtype, hd, hd)``."""
    for hd in HEAD_DIMS:
        wgmma = dtype == torch.bfloat16 and hd in (64, 80, 128, 256)
        want = "wgmma" if wgmma else "ffma"
        assert kernel_variant(dtype, hd) == kernel_variant(dtype, hd, hd) \
            == VARIANTS[(dtype, hd, hd)] == want
        if want == "wgmma" and hd == 64:
            assert kernel_tiles(dtype, hd, hd) == kernel_tiles(dtype, 96, 64)
    for dk, dv in SPLIT_HEAD_DIMS:
        if dtype == torch.bfloat16 and (dk, dv) == (96, 64):
            assert kernel_variant(dtype, dk, dv) == "wgmma"
            assert kernel_tiles(dtype, dk, dv) == (128, 128)
        else:
            assert kernel_variant(dtype, dk, dv) == "ffma"
            assert kernel_tiles(dtype, dk, dv) == (64, 64 if dk <= 64
                                                   else 32)
    assert len(VARIANTS) == 2 * (len(HEAD_DIMS) + len(SPLIT_HEAD_DIMS))


@pytest.mark.parametrize("dk,dv", [(96, 32), (64, 96), (128, 64), (48, 48)])
def test_variant_table_refuses_pairs_no_kernel_takes(dk, dv):
    for dtype in (torch.float32, torch.bfloat16):
        with pytest.raises(ValueError, match="pairs"):
            kernel_variant(dtype, dk, dv)


def test_wgmma_refuses_split_head_dims_and_names_the_ffma_kernel():
    """The split geometries the wgmma kernel is not built for, (48, 32)
    at both dtypes and f32 (96, 64), refused before it looks at the
    device, without counting a launch, naming the FFMA kernel; a pair
    neither kernel takes is refused too; the FFMA launcher refuses a
    pair outside the table the same way."""
    before = flash_attention_wgmma.launches
    for dtype, dk, dv in ((torch.bfloat16, 48, 32), (torch.float32, 48, 32),
                          (torch.float32, 96, 64)):
        qk = torch.zeros((1, 8, 2, dk), dtype=dtype)
        with pytest.raises(ValueError, match="flash_attention_ffma"):
            flash_attention_wgmma(qk, qk, torch.zeros((1, 8, 2, dv),
                                                      dtype=dtype))
    q = torch.zeros((1, 8, 2, 128), dtype=torch.bfloat16)
    v = torch.zeros((1, 8, 2, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="wgmma kernel takes"):
        flash_attention_wgmma(q, q, v)
    assert flash_attention_wgmma.launches == before
    before = flash_attention_ffma.launches
    with pytest.raises(ValueError, match="pairs"):
        flash_attention_ffma(q, q, v)
    assert flash_attention_ffma.launches == before


# ---------------------------------------------------------------------------
# Specs, cache, counts.
# ---------------------------------------------------------------------------

def test_specs_cache_and_counts_match_reference():
    """Every spec path and shape of full-width MiniCPM3-4B; its parameter
    count and model FLOPs a token (specs only), and the 16-layer
    training cut's; the MLA cache's paths and shapes at the tiny
    preset."""
    full_j, full_t = jbase.get_config(ARCH), tbase.get_config(ARCH)
    want = {_path(path): a.shape for path, a in
            jax.tree_util.tree_flatten_with_path(
                jtr.model_specs(full_j),
                is_leaf=lambda x: hasattr(x, "init"))[0]}
    got = {p: s.shape for p, s in _flat(ttr.model_specs(full_t)).items()}
    assert got == want
    assert got["segments/seg0/pos0/attn/wkv_b"] == (62, 256, 40 * 128)
    assert got["segments/seg0/pos0/attn/wq_b"] == (62, 768, 40 * 96)
    assert ttr.count_params(full_t) == jtr.count_params(full_j) \
        == FULL_PARAMS
    assert ttr.model_flops_per_token(full_t) == \
        jtr.model_flops_per_token(full_j) == 6.0 * FULL_PARAMS
    layers, n = TRAIN_CUT
    assert ttr.count_params(dataclasses.replace(full_t, n_layers=layers)) \
        == jtr.count_params(dataclasses.replace(full_j,
                                                n_layers=layers)) == n
    jcfg, tcfg = _cfgs()
    jcache = {_path(path): a.shape for path, a in
              jax.tree_util.tree_flatten_with_path(
                  jtr.init_cache(jcfg, 3, 40))[0]}
    tcache = {p: tuple(t.shape) for p, t in
              _flat(ttr.init_cache(tcfg, 3, 40, device=CPU)).items()}
    assert tcache == jcache == {
        "seg0/pos0/attn/ckv": (2, 3, 40, 32),
        "seg0/pos0/attn/krope": (2, 3, 40, 16)}


# ---------------------------------------------------------------------------
# mla_apply, one layer.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def layer():
    """One layer's MLA parameters of the tiny preset (f32), its input of
    TRAIN_S tokens, and the reference's outputs: train, prefill (with
    its cache) and one decode step after the prompt's 13 first tokens
    into a cache of MAX_LEN rows."""
    jcfg, tcfg = _cfgs()
    desc = jcfg.layer_segments()[0][0][0]
    np_params = _np_params(jcfg)
    attn = {k: v[0] for k, v in
            np_params["segments"]["seg0"]["pos0"]["attn"].items()}
    for key in ("q_norm", "kv_norm"):
        attn[key] = attn[key] + 0.1 * np.random.default_rng(5).normal(
            size=attn[key].shape).astype(np.float32)
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, TRAIN_S, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(TRAIN_S)[None], (2, TRAIN_S)).copy()
    lengths = np.array([13, 40])
    cache = {"ckv": rng.normal(size=(2, MAX_LEN, jcfg.kv_lora_rank)),
             "krope": rng.normal(size=(2, MAX_LEN, jcfg.qk_rope_head_dim))}
    cache = {k: v.astype(np.float32) for k, v in cache.items()}

    @jax.jit
    def runs(p, x, pos, lengths, cache):
        run = functools.partial(jattn.mla_apply, p, cfg=jcfg, desc=desc)
        return {"train": run(x, positions=pos)[0],
                "prefill": run(x, positions=pos, mode="prefill"),
                "decode": run(x[:, :1], positions=lengths[:, None],
                              mode="decode", lengths=lengths, cache=cache)}
    ref = runs(*jax.tree.map(jnp.asarray, (attn, x, pos, lengths, cache)))
    return dict(cfg=tcfg, desc=desc, params={k: torch.tensor(v) for k, v in
                                             attn.items()},
                x=x, pos=pos, lengths=lengths, cache=cache, ref=ref)


@pytest.mark.parametrize("impl", ["flash", "naive"])
@pytest.mark.parametrize("mode", ["train", "prefill"])
def test_mla_apply_matches_reference(layer, mode, impl):
    """Train and prefill of TRAIN_S tokens at each ``attn_impl`` (the
    reference's flash at T <= its block is its naive attention): the
    output and, at prefill, the latent cache ``{"ckv", "krope"}``."""
    out, cache = tattn.mla_apply(
        layer["params"], torch.tensor(layer["x"]), layer["cfg"],
        layer["desc"], positions=torch.tensor(layer["pos"]), mode=mode,
        attn_impl=impl)
    want = layer["ref"][mode]
    if mode == "train":
        assert cache is None
        _close(out, want)
        return
    _close(out, want[0])
    assert sorted(cache) == sorted(want[1]) == ["ckv", "krope"]
    for key, t in cache.items():
        _close(t, want[1][key])


@pytest.mark.parametrize("impl", ["flash", "naive"])
def test_mla_absorbed_decode_matches_reference(layer, impl):
    """One token a row at lengths 13 and 40 over a latent cache of
    MAX_LEN random rows: the output, and the cache written in place at
    ``lengths`` (the rest untouched) against the reference's copy."""
    cache = {k: torch.tensor(v) for k, v in layer["cache"].items()}
    lengths = torch.tensor(layer["lengths"])
    out, new = tattn.mla_apply(
        layer["params"], torch.tensor(layer["x"][:, :1]), layer["cfg"],
        layer["desc"], positions=lengths[:, None], mode="decode",
        cache=cache, lengths=lengths, attn_impl=impl)
    want_out, want_cache = layer["ref"]["decode"]
    assert new is cache
    _close(out, want_out)
    for key, t in cache.items():
        _close(t, want_cache[key])


def test_absorbed_decode_equals_the_expanded_form(layer):
    """The decode's ``W_uk``/``W_uv`` split: a prefill of the prompt plus
    one token, its last row, equals the absorbed decode of that token
    after the prompt's prefill (f32, at the layer's 1e-4)."""
    p, cfg, desc = layer["params"], layer["cfg"], layer["desc"]
    x, s = torch.tensor(layer["x"][:1]), 40
    pos = torch.arange(s + 1)[None]
    full, _ = tattn.mla_apply(p, x[:, :s + 1], cfg, desc, positions=pos,
                              mode="prefill")
    _, pc = tattn.mla_apply(p, x[:, :s], cfg, desc, positions=pos[:, :s],
                            mode="prefill")
    cache = {k: torch.zeros((1, MAX_LEN, v.shape[-1])) for k, v in pc.items()}
    for k, v in pc.items():
        cache[k][:, :s] = v
    step, _ = tattn.mla_apply(p, x[:, s:s + 1], cfg, desc,
                              positions=pos[:, s:], mode="decode",
                              cache=cache, lengths=torch.tensor([s]))
    _close(step, full[:, -1:])


# ---------------------------------------------------------------------------
# The tiny MiniCPM3.
# ---------------------------------------------------------------------------

@functools.cache
def _reference(dtype="float32"):
    """The reference's tiny MiniCPM3 at ``dtype`` on one set of inputs:
    its numpy parameters, the train logits of TRAIN_S tokens, each
    prompt's prefill logits and cache, then DECODE_STEPS batched decode
    steps and the cache they wrote."""
    jcfg, _ = _cfgs(dtype)
    np_params = _np_params(jcfg)
    jp = jax.tree.map(jnp.asarray, np_params)
    prefill_fn = jax.jit(functools.partial(jtr.forward, cfg=jcfg,
                                           mode="prefill"))
    decode_fn = jax.jit(functools.partial(jtr.decode_step, cfg=jcfg))
    rng = np.random.default_rng(31)
    toks = rng.integers(0, jcfg.vocab, size=(2, TRAIN_S))
    train, _, _ = jax.jit(functools.partial(jtr.forward, cfg=jcfg))(
        jp, {"tokens": jnp.asarray(toks)})
    prompts = [rng.integers(0, jcfg.vocab, size=n) for n in PROMPTS]
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
    return dict(np_params=np_params, toks=toks, train=train,
                prompts=prompts, prefills=prefills, steps=steps,
                lengths=lengths, decodes=decodes, cache=cache)


def _port_run(ref, tcfg, impl):
    tp = lm_params_from_jax(ref["np_params"], tcfg, CPU)
    flags = ttr.RunFlags(attn_impl=impl)
    train, _ = ttr.forward(tp, {"tokens": torch.tensor(ref["toks"])}, tcfg,
                           flags=flags)
    cache = ttr.init_cache(tcfg, 2, MAX_LEN, device=CPU)
    prefills = []
    for slot, prompt in enumerate(ref["prompts"]):
        lg, pc = ttr.forward(tp, {"tokens": torch.tensor(prompt[None])},
                             tcfg, mode="prefill", flags=flags)
        prefills.append((lg, pc))
        _merge_slot_cache(cache, pc, slot, len(prompt))
    decodes = []
    for t in range(DECODE_STEPS):
        lg, cache = ttr.decode_step(tp, cache, torch.tensor(ref["steps"][t]),
                                    torch.tensor(ref["lengths"] + t), tcfg,
                                    flags)
        decodes.append(lg)
    return train, prefills, decodes, cache


@pytest.mark.parametrize("impl", ["flash", "naive"])
def test_tiny_minicpm3_matches_reference(impl):
    """float32, at each ``attn_impl``: the train logits of TRAIN_S
    tokens, each prompt's prefill logits and latent cache (merged into
    two slots by the engine's ``_merge_slot_cache``), DECODE_STEPS
    batched absorbed decode steps and the cache they wrote."""
    ref = _reference()
    _, tcfg = _cfgs()
    train, prefills, decodes, cache = _port_run(ref, tcfg, impl)
    _close(train, ref["train"])
    for (tl, tpc), (jl, jpc) in zip(prefills, ref["prefills"]):
        _close(tl, jl)
        jflat = {_path(p): a for p, a in
                 jax.tree_util.tree_flatten_with_path(jpc)[0]}
        assert sorted(_flat(tpc)) == sorted(jflat) == [
            "seg0/pos0/attn/ckv", "seg0/pos0/attn/krope"]
        for path, a in jflat.items():
            _close(_flat(tpc)[path], a)
    for tl, jl in zip(decodes, ref["decodes"]):
        _close(tl, jl)
    for path, a in jax.tree_util.tree_flatten_with_path(ref["cache"])[0]:
        _close(_flat(cache)[_path(path)], a)


def test_tiny_minicpm3_bf16_close_to_reference():
    """bfloat16, MiniCPM3's activation dtype: every logit of the run
    above within ``BF16_NORM`` of its norm, the padding columns
    masked."""
    ref = _reference("bfloat16")
    jcfg, tcfg = _cfgs("bfloat16")
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


def test_flash_refuses_packed_positions_on_mla_layers():
    """An MLA layer runs the flash kernel, which masks by index: packed
    positions raise at ``attn_impl="flash"`` and run on naive."""
    _, tcfg = _cfgs()
    tp = ttr.init(tcfg, torch.Generator().manual_seed(0))
    toks = torch.zeros((1, 12), dtype=torch.int64)
    packed = torch.tensor([[0, 1, 2, 3, 4, 0, 1, 2, 3, 4, 5, 6]])
    with pytest.raises(ValueError, match="'naive' or 'chunked_q'"):
        ttr.forward(tp, {"tokens": toks, "positions": packed}, tcfg)
    lg, _ = ttr.forward(tp, {"tokens": toks, "positions": packed}, tcfg,
                        flags=ttr.RunFlags(attn_impl="naive"))
    assert bool(torch.isfinite(lg).all())


def test_loss_and_gradients_match_reference():
    """f32: ``loss_fn`` of the tiny MiniCPM3 over 2 x TRAIN_S tokens and
    every gradient (the MLA leaves ``wq_a`` ... ``wkv_b`` among them)
    against ``jax.grad`` of the reference's, each within 1e-5 of its
    largest element, on weights conditioned to fan-in = width."""
    ref = _reference()
    jcfg, tcfg = _cfgs()
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
    jflat = {_path(p): g for p, g in
             jax.tree_util.tree_flatten_with_path(jgrads)[0]}
    assert sorted(jflat) == sorted(_flat(tp))
    assert {p.rsplit("/", 1)[1] for p in jflat if "/attn/" in p} == {
        "wq_a", "q_norm", "wq_b", "wkv_a", "kv_norm", "wkv_b", "wo"}
    for path, got in zip(_flat(tp), tgrads):
        want = np.asarray(jflat[path])
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=path)


def test_train_state_from_jax_takes_the_mla_leaves():
    """A reference train state of the tiny MiniCPM3 carries over: the
    masters of every path, the MLA leaves among them, in f32."""
    from repro.train import train_state as jts
    jcfg, tcfg = _cfgs()
    jstate = jax.tree.map(np.asarray,
                          jts.init_train_state(jcfg, jax.random.PRNGKey(0)))
    state = train_state_from_jax(jstate, tcfg, CPU)
    flat = _flat(state["params"])
    assert "segments/seg0/pos0/attn/wkv_b" in flat
    for path, a in jax.tree_util.tree_flatten_with_path(
            jstate["params"])[0]:
        key = _path(path)
        assert flat[key].dtype == torch.float32
        np.testing.assert_array_equal(flat[key].numpy(), a)


ENGINE = dict(n_slots=2, max_len=MAX_LEN, max_new=6, temperature=0.0)
ENGINE_PROMPTS = (5, 70, 19)


@functools.cache
def _reference_engine():
    """The reference engine's greedy tokens and steps on prompts of
    ``ENGINE_PROMPTS`` tokens."""
    jcfg, _ = _cfgs()
    np_params = _np_params(jcfg, seed=1)
    je = jengine.DecodeEngine(jcfg, jax.tree.map(jnp.asarray, np_params),
                              jengine.EngineConfig(**ENGINE))
    rng = np.random.default_rng(32)
    prompts = [[int(t) for t in rng.integers(0, jcfg.vocab, size=n)]
               for n in ENGINE_PROMPTS]
    jreqs = [jengine.Request(rid=i, prompt=p) for i, p in enumerate(prompts)]
    je.run(jreqs)
    return np_params, prompts, [r.generated for r in jreqs], je.steps


@pytest.mark.parametrize("impl", ["flash", "naive"])
def test_engine_greedy_tokens_match_reference(impl):
    """float32: three requests over two slots (a slot reused, its latent
    cache rows overwritten): the port's engine at each ``attn_impl``
    gives the reference engine's greedy tokens and steps."""
    np_params, prompts, tokens, steps = _reference_engine()
    _, tcfg = _cfgs()
    te = DecodeEngine(tcfg, lm_params_from_jax(np_params, tcfg, CPU),
                      EngineConfig(**ENGINE),
                      flags=ttr.RunFlags(attn_impl=impl), device=CPU)
    treqs = [Request(rid=i, prompt=p) for i, p in enumerate(prompts)]
    te.run(treqs)
    assert all(r.done and len(r.generated) == 6 for r in treqs)
    assert [r.generated for r in treqs] == tokens
    assert te.steps == steps
