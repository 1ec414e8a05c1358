"""The port's encoder (HuBERT) and VLM (InternVL2) against the JAX
package's, on the CPU, and the flash kernels' hd-80 geometry.

The model tests run the tiny presets of ``hubert-xlarge`` (2 layers of d
128, 4 heads over 2 kv heads of 32, features 128 wide, non-causal) and
``internvl2-26b`` (the same backbone, causal, a prefix of 16 image
embeddings 128 wide), plus the tiny encoder at HuBERT's head dim
(``"hd80"``: 2 heads of 80), on the same numpy inputs and the reference's
parameters (converted by ``lm_params_from_jax``, the norm scales moved
off their zero init); the port's "flash" attention runs the CUDA
kernels' plain version here.  The reference runs are jitted once a model
and shared.

Tolerances, as tests/test_torch_mla.py's: the attention functions at
2e-5 (f32 against f32 summed in another order); the model's logits and
caches at 1e-4 of each value and of the largest one; the loss within
1e-5 and each gradient within 1e-5 of its largest element on weights
conditioned to fan-in = width (tests/test_torch_gemma3.py says why).
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
from repro.models import common as jcommon
from repro.models import transformer as jtr
from repro.serve import engine as jengine
from repro_torch import obs as tobs
from repro_torch.configs import base as tbase
from repro_torch.convert import lm_params_from_jax
from repro_torch.data.pipeline import SyntheticLM, make_batch_fn
from repro_torch.kernels.flash_attention import (FFMA_GEOMETRIES,
                                                 VARIANTS, WGMMA_TILES,
                                                 check_tma_operand,
                                                 flash_attention_plain,
                                                 kernel_tiles,
                                                 kernel_variant)
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as tlaunch
from repro_torch.models import common as tcommon
from repro_torch.models import transformer as ttr
from repro_torch.serve.engine import DecodeEngine, EngineConfig, Request
from repro_torch.train import checkpoint as tckpt
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_state import init_train_state, make_train_step
from test_torch_gemma3 import ATTN_TOL, _conditioned
from test_torch_llm import _close, _flat, _np_params, _port_cfg

CPU = torch.device("cpu")
ENC, VLM = "hubert-xlarge", "internvl2-26b"
# the reference's count_params at full width
FULL_PARAMS = {ENC: 988_058_880, VLM: 19_882_383_360}
# the encoder's frames (a partial q and kv tile at every kernel's tiles),
# the VLM's two prompt lengths: above its 16 image tokens and below
FRAMES = 70
VLM_S = (40, 10)


def _path(path) -> str:
    return "/".join(p.key for p in path)


def _cfgs(name: str):
    """(JAX config, port config) at f32: ``name``'s tiny preset, or
    ``"hd80"``, the tiny encoder with 2 heads of 80."""
    if name == "hd80":
        jcfg = dataclasses.replace(j_reduced_config(ENC, "tiny"), n_heads=2,
                                   n_kv_heads=2, head_dim=80)
    else:
        jcfg = j_reduced_config(name, "tiny")
    jcfg = dataclasses.replace(jcfg, dtype="float32")
    return jcfg, _port_cfg(jcfg)


# ---------------------------------------------------------------------------
# The flash kernels at hd 80 (HuBERT-XLarge's 16 heads over 1280).
# ---------------------------------------------------------------------------

def _qkv(rng, b, s, t, h, hd, scale=1.5):
    return tuple((c * rng.normal(size=(b, n, h, hd))).astype(np.float32)
                 for n, c in ((s, scale), (t, scale), (t, 1.0)))


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["wgmma-tiles", "ffma-tiles"])
def test_flash_plain_hd80_matches_pallas(dtype, causal):
    """The plain version at the tiles of the kernel that runs ``dtype``
    at hd 80 (the wgmma kernel's 128 x 64 for bf16, the FFMA kernel's 64
    x 32 for f32) against the Pallas kernel in interpret mode in the
    same tiles over 256 rows, in f32 at ``ATTN_TOL``."""
    bq, bk = kernel_tiles(dtype, 80)
    rng = np.random.default_rng(80 + bk)
    q, k, v = _qkv(rng, 1, 256, 256, 2, 80)
    ref = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal=causal, block_q=bq,
                                 block_k=bk, interpret=True)
    got = flash_attention_plain(torch.tensor(q), torch.tensor(k),
                                torch.tensor(v), causal=causal, block_q=bq,
                                block_k=bk)
    assert tuple(got.shape) == (1, 256, 2, 80) == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **ATTN_TOL)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["wgmma-tiles", "ffma-tiles"])
@pytest.mark.parametrize("s,t", [(150, 133), (70, 40), (40, 200)])
def test_flash_plain_hd80_ragged_matches_naive(s, t, dtype, causal):
    """Ragged S and T (partial q and kv tiles of both kernels' tiles, S
    > T, T shorter than one kv tile, S < T) against the reference's
    ``naive_attention``, the causal mask top-left; B = 2, 4 heads."""
    bq, bk = kernel_tiles(dtype, 80)
    rng = np.random.default_rng(s + t)
    q, k, v = _qkv(rng, 2, s, t, 4, 80)
    pos_q = np.broadcast_to(np.arange(s)[None], (2, s))
    pos_k = np.broadcast_to(np.arange(t)[None], (2, t))
    ref = jattn.naive_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), jnp.asarray(pos_q),
                                jnp.asarray(pos_k), causal=causal)
    got = flash_attention_plain(torch.tensor(q), torch.tensor(k),
                                torch.tensor(v), causal=causal, block_q=bq,
                                block_k=bk)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **ATTN_TOL)


def test_variant_table_at_hd80():
    """bf16 hd 80 runs on the wgmma kernel at 128 q rows against 64 kv
    rows (two panels of 64 for q, k and v, as hd 128); f32 hd 80 on the
    FFMA kernel (64 x 32); the FFMA kernel stays built for bf16 hd 80,
    the wgmma instance's yardstick."""
    assert kernel_variant(torch.bfloat16, 80) == VARIANTS[
        (torch.bfloat16, 80, 80)] == "wgmma"
    assert WGMMA_TILES[(torch.bfloat16, 80, 80)] == (128, 64) \
        == kernel_tiles(torch.bfloat16, 80)
    assert kernel_variant(torch.float32, 80) == "ffma"
    assert kernel_tiles(torch.float32, 80) == (64, 32)
    assert {(torch.float32, 80, 80), (torch.bfloat16, 80, 80)} \
        <= FFMA_GEOMETRIES


def test_hubert_attention_operands_are_what_tma_reads():
    """q, k and v as HuBERT-XLarge's attention hands them to the kernel
    (a (B, S, 1280) projection viewed as 16 heads of 80, q and k after
    RoPE), in bf16: TMA takes their strides as they are (head rows of
    160 bytes), so the launch needs no copy."""
    b, s, h, hd = 1, 37, 16, 80
    x = torch.randn((b, s, h * hd)).bfloat16()
    pos = torch.arange(s)[None]
    cos, sin = tcommon.rope_angles(pos, hd, 1e4)
    v = x.reshape(b, s, h, hd)
    q = tcommon.apply_rope(v, cos, sin)
    dense = (s * h * hd, h * hd, hd)
    for name, a in (("q", q), ("k", q), ("v", v)):
        assert check_tma_operand(name, a) == dense


# ---------------------------------------------------------------------------
# layer_norm, specs, parameters.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_reference(dtype):
    """f32 statistics either way; f32 at 1e-6, bf16 at one rounding of
    the output (2^-7 of the value)."""
    rng = np.random.default_rng(3)
    x = (3 + 2 * rng.normal(size=(2, 5, 96))).astype(np.float32)
    scale, bias = rng.normal(size=(2, 96)).astype(np.float32)
    want = jcommon.layer_norm(jnp.asarray(x, dtype), jnp.asarray(scale),
                              jnp.asarray(bias))
    got = tcommon.layer_norm(torch.tensor(x).to(getattr(torch, dtype)),
                             torch.tensor(scale), torch.tensor(bias))
    assert got.dtype == getattr(torch, dtype)
    tol = 1e-6 if dtype == "float32" else 2 ** -7
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("name", [ENC, VLM])
def test_specs_and_counts_match_reference(name):
    """Every spec path and shape of the full-width config (the
    encoder's ``frontend_proj`` and 32,768-row ``pos_embed``, the VLM's
    ``img_proj``), its parameter count and model FLOPs a token, and the
    tiny preset's cache."""
    jcfg, tcfg = jbase.get_config(name), tbase.get_config(name)
    want = {_path(path): a.shape for path, a in
            jax.tree_util.tree_flatten_with_path(
                jtr.model_specs(jcfg),
                is_leaf=lambda x: hasattr(x, "init"))[0]}
    got = {p: s.shape for p, s in _flat(ttr.model_specs(tcfg)).items()}
    assert got == want
    extra = ({"frontend_proj": (512, 1280), "pos_embed": (32768, 1280)}
             if name == ENC else {"img_proj": (3200, 6144)})
    assert {k: got[k] for k in extra} == extra
    assert ttr.count_params(tcfg) == jtr.count_params(jcfg) \
        == FULL_PARAMS[name]
    assert ttr.model_flops_per_token(tcfg) == \
        jtr.model_flops_per_token(jcfg)
    jtiny, ttiny = _cfgs(name)
    jcache = {_path(p): a.shape for p, a in
              jax.tree_util.tree_flatten_with_path(
                  jtr.init_cache(jtiny, 2, 24))[0]}
    tcache = {p: tuple(t.shape) for p, t in
              _flat(ttr.init_cache(ttiny, 2, 24, device=CPU)).items()}
    assert tcache == jcache


# ---------------------------------------------------------------------------
# The tiny encoder.
# ---------------------------------------------------------------------------

def _encoder_batch(jcfg, seed=5):
    """Features, labels and an 8% label mask (the pipeline's), B = 2."""
    rng = np.random.default_rng(seed)
    return {"features": rng.normal(size=(2, FRAMES, jcfg.frontend_dim)
                                   ).astype(np.float32),
            "labels": rng.integers(0, jcfg.vocab, (2, FRAMES)
                                   ).astype(np.int32),
            "label_mask": (rng.random((2, FRAMES)) < 0.08
                           ).astype(np.float32)}


@functools.cache
def _encoder_reference(name: str):
    """The reference's tiny encoder ``name`` on one batch: its numpy
    parameters, the train logits, the prefill logits and cache, and on
    conditioned weights the loss and its gradients."""
    jcfg, _ = _cfgs(name)
    np_params = _np_params(jcfg)
    batch = _encoder_batch(jcfg)
    jp = jax.tree.map(jnp.asarray, np_params)
    jb = {"features": jnp.asarray(batch["features"])}
    train, _, _ = jax.jit(functools.partial(jtr.forward, cfg=jcfg))(jp, jb)
    prefill, cache, _ = jax.jit(functools.partial(
        jtr.forward, cfg=jcfg, mode="prefill"))(jp, jb)
    cond = _conditioned(np_params, jcfg.d_model)
    loss = functools.partial(jtr.loss_fn, cfg=jcfg,
                             flags=jtr.RunFlags(remat=False))
    (total, metrics), grads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(jax.tree.map(jnp.asarray, cond),
                             jax.tree.map(jnp.asarray, batch))
    return dict(np_params=np_params, cond=cond, batch=batch, train=train,
                prefill=prefill, cache=cache, total=total, metrics=metrics,
                grads=grads)


@pytest.mark.parametrize("impl", ["flash", "naive", "chunked_q"])
@pytest.mark.parametrize("name", [ENC, "hd80"])
def test_encoder_forward_matches_reference(name, impl):
    """Per-frame logits of FRAMES frames in ``mode="train"`` and
    ``"prefill"`` (with the prefill's k/v cache), non-causal, at each
    ``attn_impl``: the features through ``frontend_proj`` plus
    ``pos_embed``, RoPE on in the attention."""
    ref = _encoder_reference(name)
    _, tcfg = _cfgs(name)
    tp = lm_params_from_jax(ref["np_params"], tcfg, CPU)
    flags = ttr.RunFlags(attn_impl=impl)
    feats = {"features": torch.tensor(ref["batch"]["features"])}
    train, cache = ttr.forward(tp, feats, tcfg, flags=flags)
    assert cache is None
    _close(train, ref["train"])
    prefill, cache = ttr.forward(tp, feats, tcfg, mode="prefill",
                                 flags=flags)
    _close(prefill, ref["prefill"])
    jflat = {_path(p): a for p, a in
             jax.tree_util.tree_flatten_with_path(ref["cache"])[0]}
    assert sorted(_flat(cache)) == sorted(jflat) == [
        "seg0/pos0/attn/k", "seg0/pos0/attn/v"]
    for path, a in jflat.items():
        _close(_flat(cache)[path], a)


@pytest.mark.parametrize("name", [ENC, "hd80"])
def test_encoder_loss_and_gradients_match_reference(name):
    """f32: the masked-frame ``loss_fn`` (labels weighted by the 8% label
    mask) and every gradient against ``jax.value_and_grad`` of the
    reference's, on conditioned weights; its ``tokens`` metric is the
    mask's sum."""
    ref = _encoder_reference(name)
    _, tcfg = _cfgs(name)
    tp = lm_params_from_jax(ref["cond"], tcfg, CPU, torch.float32)
    leaves = [t.requires_grad_() for t in tckpt.tree_leaves(tp)]
    batch = {k: torch.tensor(v) for k, v in ref["batch"].items()}
    total, metrics = ttr.loss_fn(tp, batch, tcfg)
    grads = torch.autograd.grad(total, leaves, materialize_grads=True)
    np.testing.assert_allclose(float(total.detach()), float(ref["total"]),
                               rtol=1e-5)
    assert float(metrics["tokens"]) == float(ref["metrics"]["tokens"]) \
        == ref["batch"]["label_mask"].sum() > 0
    jflat = {_path(p): g for p, g in
             jax.tree_util.tree_flatten_with_path(ref["grads"])[0]}
    assert sorted(jflat) == sorted(_flat(tp))
    for path, got in zip(_flat(tp), grads):
        want = np.asarray(jflat[path])
        if path == "embed":     # the encoder reads no token embedding
            assert not got.any() and not want.any()
            continue
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=path)


def test_encoder_loss_without_a_mask_weighs_every_frame():
    """``label_mask`` absent: ones, as the reference's (the loss over
    all 2 x FRAMES frames)."""
    ref = _encoder_reference(ENC)
    jcfg, tcfg = _cfgs(ENC)
    batch = {k: v for k, v in ref["batch"].items() if k != "label_mask"}
    tp = lm_params_from_jax(ref["np_params"], tcfg, CPU)
    total, metrics = ttr.loss_fn(tp, {k: torch.tensor(v) for k, v in
                                      batch.items()}, tcfg)
    jtotal, jm = jtr.loss_fn(jax.tree.map(jnp.asarray, ref["np_params"]),
                             jax.tree.map(jnp.asarray, batch), jcfg)
    assert float(metrics["tokens"]) == float(jm["tokens"]) == 2 * FRAMES
    np.testing.assert_allclose(float(total), float(jtotal), rtol=1e-5)


def test_encoder_limits():
    """No decode (encoder-only, as the reference's); above the 32,768
    rows of ``pos_embed`` a ValueError naming the limit, where the
    reference fails on a shape."""
    _, tcfg = _cfgs(ENC)
    tp = ttr.init(tcfg, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="encoder-only"):
        ttr.forward(tp, {"tokens": torch.zeros((1, 1), dtype=torch.long)},
                    tcfg, mode="decode", lengths=torch.zeros(1),
                    cache={})
    feats = torch.zeros((1, ttr.POS_EMBED_ROWS + 1, tcfg.frontend_dim))
    with pytest.raises(ValueError, match="at most 32768 frames"):
        ttr.forward(tp, {"features": feats}, tcfg)


def test_encoder_train_step_on_the_pipeline_batch():
    """Two ``make_train_step`` steps of the tiny encoder on SyntheticLM's
    ``{features, labels, label_mask}``: finite losses over the mask's
    frames, every gradient finite and ``pos_embed``'s reaching only the
    rows of the frames."""
    _, tcfg = _cfgs(ENC)
    state = init_train_state(tcfg, torch.Generator().manual_seed(0))
    batch_fn = make_batch_fn(SyntheticLM(tcfg, 2, 48, seed=0), device=CPU)
    step = make_train_step(tcfg, AdamWConfig(total_steps=2),
                           ttr.RunFlags(attn_impl="flash", remat=True))
    data = batch_fn(0)
    _, _, grads = step.value_and_grad(state["params"], data)
    assert torch.isfinite(torch.cat([g.flatten() for g in
                                     tckpt.tree_leaves(grads)])).all()
    assert grads["pos_embed"][:48].abs().sum() > 0
    assert not grads["pos_embed"][48:].any()
    for i in range(2):
        state, m = step(state, batch_fn(i))
        assert np.isfinite(float(m["loss"])) and float(m["tokens"]) == \
            float(batch_fn(i)["label_mask"].sum())
    assert int(state["step"]) == 2


# ---------------------------------------------------------------------------
# The tiny VLM.
# ---------------------------------------------------------------------------

@functools.cache
def _vlm_reference():
    """The reference's tiny VLM: its numpy parameters, the image
    embeddings and tokens, and per prompt length of VLM_S the train
    logits with the image prefix, the prefill logits and cache with it,
    and the train logits without it; the loss with the prefix."""
    jcfg, _ = _cfgs(VLM)
    np_params = _np_params(jcfg)
    jp = jax.tree.map(jnp.asarray, np_params)
    rng = np.random.default_rng(11)
    img = rng.normal(size=(2, jcfg.img_tokens, jcfg.frontend_dim)
                     ).astype(np.float32)
    toks = rng.integers(0, jcfg.vocab, (2, max(VLM_S))).astype(np.int32)
    fwd = jax.jit(functools.partial(jtr.forward, cfg=jcfg))
    pre = jax.jit(functools.partial(jtr.forward, cfg=jcfg, mode="prefill"))
    runs = {}
    for s in VLM_S:
        batch = {"tokens": jnp.asarray(toks[:, :s]),
                 "img_embeds": jnp.asarray(img)}
        runs[s] = dict(train=fwd(jp, batch)[0], prefill=pre(jp, batch)[:2],
                       text=fwd(jp, {"tokens": batch["tokens"]})[0])
    loss = jtr.loss_fn(jp, {"tokens": jnp.asarray(toks),
                            "img_embeds": jnp.asarray(img)}, jcfg)[0]
    return dict(np_params=np_params, img=img, toks=toks, runs=runs,
                loss=loss)


@pytest.mark.parametrize("impl", ["flash", "naive"])
@pytest.mark.parametrize("s", VLM_S)
def test_vlm_forward_matches_reference(s, impl):
    """Tokens and image embeddings at S = 40 (the image replaces the
    first 16 positions) and S = 10 (below the prefix: the text alone, as
    the reference's): train logits, prefill logits and cache, and the
    text-only logits; at S = 40 the image moves the logits."""
    ref = _vlm_reference()
    _, tcfg = _cfgs(VLM)
    tp = lm_params_from_jax(ref["np_params"], tcfg, CPU)
    flags = ttr.RunFlags(attn_impl=impl)
    run = ref["runs"][s]
    toks = torch.tensor(ref["toks"][:, :s])
    batch = {"tokens": toks, "img_embeds": torch.tensor(ref["img"])}
    train, _ = ttr.forward(tp, batch, tcfg, flags=flags)
    _close(train, run["train"])
    prefill, cache = ttr.forward(tp, batch, tcfg, mode="prefill",
                                 flags=flags)
    _close(prefill, run["prefill"][0])
    for path, a in jax.tree_util.tree_flatten_with_path(run["prefill"][1]
                                                        )[0]:
        _close(_flat(cache)[_path(path)], a)
    text, _ = ttr.forward(tp, {"tokens": toks}, tcfg, flags=flags)
    _close(text, run["text"])
    moved = np.abs(np.asarray(run["train"]) - np.asarray(run["text"])).max()
    assert (moved > 1e-2) == (s >= tcfg.img_tokens)


def test_vlm_loss_and_params_match_reference():
    """The next-token loss with the image prefix; ``lm_params_from_jax``
    carries ``img_proj`` (and every other leaf) as it is."""
    ref = _vlm_reference()
    _, tcfg = _cfgs(VLM)
    tp = lm_params_from_jax(ref["np_params"], tcfg, CPU)
    np.testing.assert_array_equal(tp["img_proj"].numpy(),
                                  ref["np_params"]["img_proj"])
    total, _ = ttr.loss_fn(tp, {"tokens": torch.tensor(ref["toks"]),
                                "img_embeds": torch.tensor(ref["img"])},
                           tcfg)
    np.testing.assert_allclose(float(total), float(ref["loss"]), rtol=1e-5)


def test_encoder_params_carry_over():
    """``lm_params_from_jax`` carries the encoder's ``frontend_proj`` and
    ``pos_embed`` as they are, and refuses a tree without them."""
    ref = _encoder_reference(ENC)
    _, tcfg = _cfgs(ENC)
    tp = lm_params_from_jax(ref["np_params"], tcfg, CPU)
    for key in ("frontend_proj", "pos_embed"):
        np.testing.assert_array_equal(tp[key].numpy(),
                                      ref["np_params"][key])
    short = {k: v for k, v in ref["np_params"].items() if k != "pos_embed"}
    with pytest.raises(ValueError, match="pos_embed"):
        lm_params_from_jax(short, tcfg, CPU)


ENGINE = dict(n_slots=2, max_len=48, max_new=5, temperature=0.0)
ENGINE_PROMPTS = (5, 30, 19)


def test_vlm_engine_greedy_tokens_match_reference():
    """float32: three text requests over two slots (a slot reused)
    through the port's ``DecodeEngine`` give the reference engine's
    greedy tokens and steps (the reference's engine serves the VLM on
    text, as the port's)."""
    jcfg, tcfg = _cfgs(VLM)
    np_params = _np_params(jcfg, seed=1)
    je = jengine.DecodeEngine(jcfg, jax.tree.map(jnp.asarray, np_params),
                              jengine.EngineConfig(**ENGINE))
    rng = np.random.default_rng(32)
    prompts = [[int(t) for t in rng.integers(0, jcfg.vocab, size=n)]
               for n in ENGINE_PROMPTS]
    jreqs = [jengine.Request(rid=i, prompt=p) for i, p in enumerate(prompts)]
    je.run(jreqs)
    te = DecodeEngine(tcfg, lm_params_from_jax(np_params, tcfg, CPU),
                      EngineConfig(**ENGINE), device=CPU)
    treqs = [Request(rid=i, prompt=p) for i, p in enumerate(prompts)]
    te.run(treqs)
    assert all(r.done and len(r.generated) == 5 for r in treqs)
    assert [r.generated for r in treqs] == [r.generated for r in jreqs]
    assert te.steps == je.steps


# ---------------------------------------------------------------------------
# The CLIs.
# ---------------------------------------------------------------------------

def test_serve_cli_serves_the_vlm_and_refuses_the_encoder(capsys):
    """``launch/serve.py`` on the CPU: the tiny VLM's text requests
    finish; the encoder has no decode and exits, as the reference's."""
    _, reqs = tserve.main(["--arch", VLM, "--device", "cpu", "--requests",
                           "2", "--max-new", "3"])
    assert all(r.done and len(r.generated) == 3 for r in reqs)
    with pytest.raises(SystemExit, match="encoder-only"):
        tserve.main(["--arch", ENC, "--device", "cpu"])


@pytest.mark.parametrize("name", [ENC, VLM])
def test_train_cli_trains_the_encoder_and_the_vlm(name, tmp_path, capsys):
    """``launch/train.py`` on the CPU, two steps of the tiny preset on
    SyntheticLM's batches (the encoder's frames, labels and mask; the
    VLM's tokens and image embeddings), a checkpoint at the end; the
    ``train.*`` gauges it records are dropped after."""
    try:
        loop, _ = tlaunch.main(["--arch", name, "--device", "cpu",
                                "--steps", "2", "--batch", "2", "--seq",
                                "24", "--ckpt-dir", str(tmp_path)])
        assert loop.steps == 2
        assert all(np.isfinite(m["loss"]) for m in loop.metrics_history)
        assert tckpt.all_steps(str(tmp_path)) == [2]
        assert "[train] done" in capsys.readouterr().out
    finally:
        tobs.registry.reset()
