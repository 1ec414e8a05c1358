"""The port's LLM training path against the JAX package's, on the CPU.

AdamW and its schedules, int8 compression, the data pipeline, the
differentiable flash attention, ``loss_fn`` and its gradients, three
``make_train_step`` steps (every remat, scan, accumulation and transform
option), the train CLI and the restart demo, at the reference tests'
tiny size (``TINY`` of tests/test_train.py: 2 layers, d 32, vocab 64).
Both packages get the same numpy inputs; the port's "flash" attention
runs the kernel's plain version here.

Tolerances:
* f32 elementwise copies (the optimizer, the schedules): 1e-6.
* The attention's dq, dk, dv against ``jax.grad`` of the reference's
  blocked ``flash_attention``: 1e-5, f32.
* ``loss_fn`` at f32: the loss within 1e-5 of its value, each gradient
  within 1e-5 of its largest element; at bf16 the loss within
  ``BF16_LOSS`` of its value and each gradient within ``BF16_NORM`` of
  its norm.  The frameworks round GELU and the norms at other places
  (tests/test_torch_llm.py), and the bf16 backward rounds every
  cotangent: through the port's naive attention, which rounds ``p`` as
  the reference does, the worst leaf of this test reads 4.4e-2 (flash:
  3.7e-2).
* Three train steps at f32: the reference's own allowance in
  ``test_grad_accum_equivalence`` (elements off by more than 2e-5 +
  2e-5·|b| in under 2e-3 of each leaf: a gradient of ~0 whose sign flips
  between two summation orders becomes a ±lr step under Adam).  The
  first step's metrics within 2e-5; the later steps' within 1e-3, as
  they read parameters that such knife-edge elements moved by ±lr.
  With the int8 transform each step's metrics within 1e-4: its
  ``grad_norm`` reads the quantized gradients, where one knife-edge
  element moves by a whole int8 level.
* SyntheticLM and int8 quantization: bit for bit.
"""

import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.data import pipeline as jpipe
from repro.launch.train import reduced_config as j_reduced_config
from repro.models import attention as jattn
from repro.models import transformer as jtr
from repro.train import compress as jcompress
from repro.train import optimizer as jopt
from repro.train import train_state as jts
from repro_torch import obs as tobs
from repro_torch.configs import base as tbase
from repro_torch.convert import lm_params_from_jax, train_state_from_jax
from repro_torch.data import pipeline as tpipe
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as tlaunch
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as ttr
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import compress as tcompress
from repro_torch.train import optimizer as topt
from repro_torch.train.loop import LoopConfig, TrainLoop
from repro_torch.train.train_state import init_train_state, make_train_step
from test_train import TINY as J_TINY_BF16

# the reference tests' tiny config at f32 (Gemma's activation dtype,
# bf16, is the one the bf16 cases take)
J_TINY = dataclasses.replace(J_TINY_BF16, dtype="float32")

CPU = torch.device("cpu")
BF16_NORM = 6e-2
BF16_LOSS = 1e-3
STEPS = 3


@pytest.fixture(autouse=True, scope="module")
def _port_metrics_dropped_after():
    """The port's ``TrainLoop`` here records the LLM step's ``train.*``
    gauges in the process-wide registry; they are dropped after this
    file, so that a later file in the same process that compares gauge
    names with the reference's starts from none."""
    yield
    tobs.registry.reset()


def _port_cfg(jcfg, **over):
    return dataclasses.replace(tbase.ArchConfig(**dataclasses.asdict(jcfg)),
                               **over)


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _flat(tree, prefix=""):
    """``{path: leaf}`` in sorted-key order, the order of
    ``jax.tree.leaves`` and of the port's ``tree_leaves``."""
    out = {}
    for k, v in sorted(tree.items()):
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: v})
    return out


def _np_params(jcfg, seed=0) -> dict:
    """The reference's initial parameters as numpy, the norm scales
    moved off their zero init."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        a = np.asarray(a, np.float32)
        if getattr(path[-1], "key", None) in ("ln_mix", "ln_mlp",
                                              "final_norm"):
            a = a + 0.1 * rng.normal(size=a.shape).astype(np.float32)
        return a
    return jax.tree_util.tree_map_with_path(
        leaf, jtr.init(jcfg, jax.random.PRNGKey(seed)))


def _tokens(shape, seed=1):
    return np.random.default_rng(seed).integers(
        0, J_TINY.vocab, shape).astype(np.int32)


# ---------------------------------------------------------------------------
# The optimizer.
# ---------------------------------------------------------------------------

def _random_tree(rng):
    return {"w": rng.normal(size=(5, 7)).astype(np.float32),
            "blk": {"b": rng.normal(size=(7,)).astype(np.float32),
                    "k": rng.normal(size=(2, 3, 4)).astype(np.float32)}}


@pytest.mark.parametrize("clip,decay", [(0.0, 0.0), (1.0, 0.1), (0.5, 0.0)])
def test_adamw_update_matches_reference(clip, decay):
    rng = np.random.default_rng(0)
    cfg = dict(peak_lr=1e-2, warmup_steps=2, total_steps=10,
               grad_clip=clip, weight_decay=decay)
    jcfg, tcfg = jopt.AdamWConfig(**cfg), topt.AdamWConfig(**cfg)
    params = _random_tree(rng)
    jp = jax.tree.map(jnp.asarray, params)
    tp = tckpt.tree_map(torch.tensor, params)
    js, ts = jopt.adamw_init(jp), topt.adamw_init(tp)
    for _ in range(3):
        grads = jax.tree.map(lambda a: 3 * rng.normal(size=a.shape)
                             .astype(np.float32), params)
        jp, js, jstats = jopt.adamw_update(
            jp, jax.tree.map(jnp.asarray, grads), js, jcfg)
        tp_out, ts, tstats = topt.adamw_update(
            tp, tckpt.tree_map(torch.tensor, grads), ts, tcfg)
        assert tp_out is tp
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tstats[k]), float(jstats[k]),
                                       rtol=1e-6)
    assert ts["count"].dtype == torch.int32 and int(ts["count"]) == 3
    for name, tree, ref in (("params", tp, jp), ("mu", ts["mu"], js["mu"]),
                            ("nu", ts["nu"], js["nu"])):
        for (path, got), want in zip(_flat(tree).items(),
                                     jax.tree.leaves(ref)):
            np.testing.assert_allclose(_np(got), np.asarray(want),
                                       rtol=1e-6, atol=1e-6,
                                       err_msg=f"{name} {path}")


def test_schedules_match_reference():
    cfg = dict(peak_lr=2.0, warmup_steps=10, total_steps=100,
               min_lr_ratio=0.1)
    jcfg, tcfg = jopt.AdamWConfig(**cfg), topt.AdamWConfig(**cfg)
    for make in ("cosine_schedule", "linear_warmup"):
        jlr, tlr = getattr(jopt, make)(jcfg), getattr(topt, make)(tcfg)
        for step in (0, 1, 10, 55, 100, 120):
            want = float(jlr(jnp.asarray(step, jnp.int32)))
            got = tlr(torch.tensor(step, dtype=torch.int32))
            assert got.dtype == torch.float32
            np.testing.assert_allclose(float(got), want, rtol=1e-6,
                                       err_msg=f"{make} at {step}")


# ---------------------------------------------------------------------------
# Compression.
# ---------------------------------------------------------------------------

def test_int8_quantization_and_error_feedback_bit_for_bit():
    rng = np.random.default_rng(3)
    x = (rng.normal(size=1000) * 0.01).astype(np.float32)
    x[:4] = [0.0, 127 * 1e-3, -63.5 * 1e-3, 0.5 * 1e-3]  # ties and zero
    jq, js = jcompress.quantize_int8(jnp.asarray(x))
    tq, ts = tcompress.quantize_int8(torch.tensor(x))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert ts.item() == float(js)
    np.testing.assert_array_equal(
        tcompress.dequantize_int8(tq, ts).numpy(),
        np.asarray(jcompress.dequantize_int8(jq, js)))

    tmpl = {"a": np.zeros((8, 4), np.float32), "b": np.zeros(5, np.float32)}
    jtf, jinit = jcompress.make_int8_grad_transform(
        jax.tree.map(jnp.asarray, tmpl))
    tfb = tcompress.ErrorFeedbackState(tckpt.tree_map(torch.tensor, tmpl))
    jerr = jinit()
    for _ in range(3):
        g = jax.tree.map(lambda a: (rng.normal(size=a.shape) * 0.01)
                         .astype(np.float32), tmpl)
        jout, jerr = jtf(jax.tree.map(jnp.asarray, g), jerr)
        tout = tfb(tckpt.tree_map(torch.tensor, g))
        for k in tmpl:
            np.testing.assert_array_equal(tout[k].numpy(),
                                          np.asarray(jout[k]))
            np.testing.assert_array_equal(tfb.err[k].numpy(),
                                          np.asarray(jerr[k]))


# ---------------------------------------------------------------------------
# Data.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["gemma-7b", "internvl2-26b",
                                  "hubert-xlarge"])
def test_synthetic_lm_bit_for_bit(arch):
    jcfg = j_reduced_config(arch, "tiny")
    tcfg = tlaunch.reduced_config(arch, "tiny")
    for seed, step, batch, micro in ((0, 0, 2, 1), (5, 3, 4, 1),
                                     (7, 11, 4, 2), (2**40, 1, 6, 3)):
        ref = jpipe.SyntheticLM(jcfg, batch, 16, seed, micro)(step)
        got = tpipe.SyntheticLM(tcfg, batch, 16, seed, micro)(step)
        assert got.keys() == ref.keys()
        for k in ref:
            assert got[k].dtype == ref[k].dtype
            np.testing.assert_array_equal(got[k], ref[k])


def test_memmap_tokens_and_batch_fn(tmp_path):
    path = str(tmp_path / "toks.bin")
    np.arange(10000, dtype=np.uint16).tofile(path)
    tcfg = _port_cfg(J_TINY)
    for micro in (1, 2):
        ref = jpipe.MemmapTokens(path, J_TINY, 4, 16, microbatches=micro)
        got = tpipe.MemmapTokens(path, tcfg, 4, 16, microbatches=micro)
        for step in (0, 1, 200):
            np.testing.assert_array_equal(got(step)["tokens"],
                                          ref(step)["tokens"])
    fn = tpipe.make_batch_fn(tpipe.SyntheticLM(tcfg, 2, 8), device="cpu")
    batch = fn(4)
    assert batch["tokens"].device == CPU
    np.testing.assert_array_equal(
        batch["tokens"].numpy(), jpipe.SyntheticLM(J_TINY, 2, 8)(4)["tokens"])
    with pytest.raises(ValueError, match="need the mesh"):
        tpipe.make_batch_fn(fn, shardings=object(), device="cpu")


def test_prefetcher_order():
    src = tpipe.SyntheticLM(_port_cfg(J_TINY), batch=1, seq_len=8, seed=0)
    pf = tpipe.Prefetcher(tpipe.make_batch_fn(src, device="cpu"),
                          start_step=3, depth=2)
    got = [pf.get() for _ in range(4)]
    pf.stop()
    assert [s for s, _ in got] == [3, 4, 5, 6]
    for step, batch in got:
        np.testing.assert_array_equal(batch["tokens"].numpy(),
                                      src(step)["tokens"])


# ---------------------------------------------------------------------------
# The differentiable flash attention.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_flash_attention_gradients_match_reference(causal):
    """dq, dk, dv of the port's flash attention (plain forward, the
    Function's recompute backward) against ``jax.grad`` of the
    reference's ``flash_attention`` with ``block_k=16``: S 48 runs its
    blocked online softmax.  GQA 4:2, f32."""
    rng = np.random.default_rng(0)
    b, s, hq, hk, hd = 2, 48, 4, 2, 32
    q = rng.normal(size=(b, s, hq, hd)).astype(np.float32)
    k = rng.normal(size=(b, s, hk, hd)).astype(np.float32)
    v = rng.normal(size=(b, s, hk, hd)).astype(np.float32)
    ct = rng.normal(size=(b, s, hq, hd)).astype(np.float32)
    pos = jnp.broadcast_to(jnp.arange(s)[None], (b, s))

    def jloss(q, k, v):
        out = jattn.flash_attention(q, k, v, pos, jnp.arange(s),
                                    causal=causal, block_k=16)
        return jnp.sum(out * ct)
    want = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(q, k, v)
    ins = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    out = tattn.flash_attention(*ins, causal=causal)
    got = torch.autograd.grad(out, ins, torch.tensor(ct))
    for name, g, w in zip("qkv", got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-5, err_msg=f"d{name}")


def test_flash_attention_function_dispatch(monkeypatch):
    """The forward is the function looked up in models/attention at call
    time; under no_grad the Function adds no backward."""
    from repro_torch.kernels import flash_attention as fa
    calls = []

    def spy(q, k, v, causal=True):
        calls.append(causal)
        return fa.flash_attention_plain(q, k, v, causal=causal)
    monkeypatch.setattr(tattn, "flash_attention_plain", spy)
    q = torch.randn(1, 8, 2, 16, requires_grad=True)
    out = tattn.flash_attention(q, q.detach(), q.detach(), causal=False)
    assert calls == [False] and out.grad_fn is not None
    with torch.no_grad():
        assert tattn.flash_attention(q, q, q).grad_fn is None
    assert calls == [False, True]


# ---------------------------------------------------------------------------
# The loss.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_and_gradients_match_reference(dtype):
    jcfg = dataclasses.replace(J_TINY, dtype=dtype)
    tcfg = _port_cfg(jcfg)
    np_params = _np_params(jcfg)
    tokens = _tokens((2, 16))
    jp = jax.tree.map(jnp.asarray, np_params)
    loss = functools.partial(jtr.loss_fn, cfg=jcfg,
                             flags=jtr.RunFlags(remat=False))
    (jtotal, jm), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jp, {"tokens": jnp.asarray(tokens)})
    tp = lm_params_from_jax(np_params, tcfg, CPU, torch.float32)
    leaves = [t.requires_grad_() for t in tckpt.tree_leaves(tp)]
    ttotal, tm = ttr.loss_fn(tp, {"tokens": torch.tensor(tokens)}, tcfg)
    tgrads = torch.autograd.grad(ttotal, leaves)
    assert tm.keys() == jm.keys()
    assert float(tm["tokens"]) == float(jm["tokens"]) == 2 * 15
    loss_tol = 1e-5 if dtype == "float32" else BF16_LOSS
    np.testing.assert_allclose(float(ttotal.detach()), float(jtotal),
                               rtol=loss_tol)
    np.testing.assert_allclose(float(tm["loss"].detach()),
                               float(jm["loss"]), rtol=loss_tol)
    for path, got, want in zip(_flat(tp), tgrads, jax.tree.leaves(jgrads)):
        got, want = _np(got), np.asarray(want)
        if dtype == "float32":
            np.testing.assert_allclose(got, want, rtol=1e-5,
                                       atol=1e-5 * np.abs(want).max(),
                                       err_msg=path)
        else:
            rel = np.linalg.norm(got - want) / np.linalg.norm(want)
            assert rel <= BF16_NORM, (path, rel)


def test_encoder_loss_on_the_pipeline_batch_matches_reference():
    """The tiny encoder's masked-frame loss on SyntheticLM's ``{features,
    labels, label_mask}`` (the same batch in both packages, bit for bit)
    against the reference's ``loss_fn``, f32, within 1e-5; its
    ``tokens`` metric is the mask's sum."""
    jcfg = dataclasses.replace(j_reduced_config("hubert-xlarge", "tiny"),
                               dtype="float32")
    tcfg = _port_cfg(jcfg)
    batch = jpipe.SyntheticLM(jcfg, 2, 40, seed=3)(0)
    np_params = _np_params(jcfg)
    jtotal, jm = jtr.loss_fn(jax.tree.map(jnp.asarray, np_params),
                             jax.tree.map(jnp.asarray, batch), jcfg)
    ttotal, tm = ttr.loss_fn(lm_params_from_jax(np_params, tcfg, CPU),
                             {k: torch.tensor(v) for k, v in batch.items()},
                             tcfg)
    assert float(tm["tokens"]) == float(jm["tokens"]) \
        == batch["label_mask"].sum()
    np.testing.assert_allclose(float(ttotal), float(jtotal), rtol=1e-5)


def test_model_flops_per_token_matches_reference():
    for name in ("gemma-7b", "qwen1.5-32b"):
        assert ttr.model_flops_per_token(tbase.get_config(name)) == \
            jtr.model_flops_per_token(jbase.get_config(name))


# ---------------------------------------------------------------------------
# The train step.
# ---------------------------------------------------------------------------

OPT = dict(peak_lr=1e-2, warmup_steps=2, total_steps=10)
# (port flags, grad_accum, int8 transform); the reference runs each
# (grad_accum, transform) once: remat and scan do not change its values
STEP_CASES = {
    "remat": (dict(), 1, False),
    "no_remat": (dict(remat=False), 1, False),
    "dots": (dict(remat_policy="dots"), 1, False),
    "no_scan": (dict(scan_layers=False), 1, False),
    "accum2": (dict(), 2, False),
    "int8": (dict(), 1, True),
}


def _batches(accum):
    toks = _tokens((STEPS, 4, 16), seed=2)
    return [t.reshape(accum, 4 // accum, 16) if accum > 1 else t
            for t in toks]


@functools.lru_cache(maxsize=None)
def _reference_steps(accum, int8):
    """The reference's three steps, jitted; with ``int8`` its transform's
    residuals are threaded through the jitted step (what
    ``ErrorFeedbackState`` carries between calls)."""
    state = jts.init_train_state(J_TINY, jax.random.PRNGKey(0))
    state["params"] = jax.tree.map(jnp.asarray, _np_params(J_TINY))
    np_state = jax.tree.map(np.asarray, state)
    transform, init_err = jcompress.make_int8_grad_transform(
        state["params"])

    def step(state, err, batch):
        carried = {}

        def hook(grads):
            out, carried["err"] = transform(grads, err)
            return out
        fn = jts.make_train_step(J_TINY, jopt.AdamWConfig(**OPT),
                                 jtr.RunFlags(remat=False), grad_accum=accum,
                                 grad_transform=hook if int8 else None)
        state, m = fn(state, batch)
        return state, carried.get("err", err), m
    step = jax.jit(step)
    err = init_err()
    states, errs, metrics = [np_state], [jax.tree.map(np.asarray, err)], []
    for tokens in _batches(accum):
        state, err, m = step(state, err, {"tokens": jnp.asarray(tokens)})
        states.append(jax.tree.map(np.asarray, state))
        errs.append(jax.tree.map(np.asarray, err))
        metrics.append({k: float(v) for k, v in m.items()})
    return states, errs, metrics


def _knife_edge_close(got, want, what):
    got, want = _np(got), np.asarray(want, np.float32)
    mismatched = np.abs(got - want) > (2e-5 + 2e-5 * np.abs(want))
    assert mismatched.mean() < 2e-3, (what, mismatched.mean())


def _check_state(state, want, what):
    for name, tree, ref in (("params", state["params"], want["params"]),
                            ("mu", state["opt"]["mu"], want["opt"]["mu"]),
                            ("nu", state["opt"]["nu"], want["opt"]["nu"])):
        for (path, got), w in zip(_flat(tree).items(), jax.tree.leaves(ref)):
            assert got.dtype == torch.float32
            _knife_edge_close(got, w, f"{what} {name} {path}")


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_train_steps_match_reference(case):
    """Three steps from one converted state.  With the int8 transform
    each step starts from the reference's state and residuals of that
    step: a gradient element on a rounding boundary of its int8 level
    moves by a whole level, which Adam turns into a ±lr step, and the
    next steps' quantization of the moved parameters cascades, so only
    one step at a time is comparable."""
    over, accum, int8 = STEP_CASES[case]
    states, errs, want_metrics = _reference_steps(accum, int8)
    tcfg = _port_cfg(J_TINY)
    state = train_state_from_jax(states[0], tcfg, CPU)
    transform = tcompress.ErrorFeedbackState(state["params"]) if int8 \
        else None
    step = make_train_step(tcfg, topt.AdamWConfig(**OPT),
                           ttr.RunFlags(**over), grad_accum=accum,
                           grad_transform=transform)
    for i, tokens in enumerate(_batches(accum)):
        if int8 and i:
            state = train_state_from_jax(states[i], tcfg, CPU)
            transform.err = tckpt.tree_map(torch.tensor, errs[i])
        out, m = step(state, {"tokens": torch.tensor(tokens)})
        assert out is state
        assert m.keys() == want_metrics[i].keys()
        for k, v in want_metrics[i].items():
            rtol = 1e-4 if int8 else 2e-5 if i == 0 else 1e-3
            np.testing.assert_allclose(float(m[k]), v, rtol=rtol,
                                       err_msg=f"step {i} {k}")
        if int8:
            _check_state(state, states[i + 1], f"{case} step {i}")
    assert int(state["step"]) == int(state["opt"]["count"]) == STEPS
    assert state["step"].dtype == state["opt"]["count"].dtype == torch.int32
    _check_state(state, states[-1], case)


def test_training_reduces_loss():
    tcfg = _port_cfg(J_TINY)
    step = make_train_step(tcfg, topt.AdamWConfig(peak_lr=5e-3,
                                                  warmup_steps=5,
                                                  total_steps=60),
                           ttr.RunFlags(remat=False))
    state = init_train_state(tcfg, torch.Generator().manual_seed(0))
    batch = {"tokens": torch.tensor(_tokens((4, 32)))}
    losses = []
    for _ in range(30):
        state, m = step(state, batch)     # memorize one batch
        losses.append(float(m["total_loss"]))
    assert losses[-1] < losses[0] * 0.8, losses[::10]


def test_init_train_state_is_f32_on_the_generators_device():
    cfg = tlaunch.reduced_config("gemma-7b", "tiny")
    assert cfg.activation_dtype == torch.bfloat16
    state = init_train_state(cfg, torch.Generator().manual_seed(0))
    leaves = tckpt.tree_leaves(state["params"])
    assert sum(t.numel() for t in leaves) == ttr.count_params(cfg)
    assert all(t.dtype == torch.float32 and t.device == CPU for t in
               leaves + tckpt.tree_leaves(state["opt"]["mu"]))
    assert state["step"].dtype == torch.int32 and int(state["step"]) == 0


def test_make_train_step_refuses_shardings():
    cfg = _port_cfg(J_TINY)
    for kw in ("compute_shardings", "master_shardings"):
        with pytest.raises(ValueError, match=r"RunFlags\(mesh"):
            make_train_step(cfg, topt.AdamWConfig(), **{kw: object()})


def test_train_state_from_jax_validates_paths_and_shapes():
    np_state = jax.tree.map(np.asarray, jts.init_train_state(
        J_TINY, jax.random.PRNGKey(0)))
    tcfg = _port_cfg(J_TINY)
    state = train_state_from_jax(np_state, tcfg, CPU)
    assert state["opt"]["count"].dtype == torch.int32
    bad = jax.tree.map(lambda a: a, np_state)
    bad["opt"]["nu"]["segments"]["seg0"]["pos0"]["attn"]["wq"] = \
        np.zeros((2, 3))
    with pytest.raises(ValueError, match="nu/segments/seg0/pos0/attn/wq"):
        train_state_from_jax(bad, tcfg, CPU)
    with pytest.raises(ValueError, match="train state"):
        train_state_from_jax({"params": np_state["params"]}, tcfg, CPU)


# ---------------------------------------------------------------------------
# The loop, the CLI and the restart demo.
# ---------------------------------------------------------------------------

def test_loop_keeps_its_replay_copy_on_the_host(tmp_path):
    """TrainLoop's step-0 copy (what a restart with no checkpoint
    restores) is a host copy, not a second device copy of the state, and
    a restart restores it."""
    tcfg = _port_cfg(J_TINY)
    state = init_train_state(tcfg, torch.Generator().manual_seed(0))
    start = tckpt.tree_map(lambda t: t.clone(), state)
    step = make_train_step(tcfg, topt.AdamWConfig(**OPT),
                           ttr.RunFlags(remat=False))
    fn = tpipe.make_batch_fn(tpipe.SyntheticLM(tcfg, 2, 8), device="cpu")
    fired = []

    def inject(s):
        if s == 1 and not fired:
            fired.append(s)
            return True
        return False
    loop = TrainLoop(LoopConfig(total_steps=2, ckpt_dir=str(tmp_path),
                                ckpt_every=100, log_every=100),
                     step, fn, state, failure_injector=inject,
                     log_fn=lambda s: None)
    loop.run()
    assert loop.restarts == 1 and loop.steps == 3
    for copy, orig, live in zip(tckpt.tree_leaves(loop._initial_state),
                                tckpt.tree_leaves(start),
                                tckpt.tree_leaves(state)):
        assert copy.device == CPU and not copy.is_pinned()
        assert copy.untyped_storage().data_ptr() != \
            live.untyped_storage().data_ptr()
        assert torch.equal(copy, orig)


def test_train_cli_writes_checkpoints_on_the_cpu(tmp_path, capsys):
    loop, state = tlaunch.main(["--arch", "gemma-7b", "--device", "cpu",
                                "--steps", "3", "--batch", "2", "--seq",
                                "16", "--ckpt-dir", str(tmp_path),
                                "--ckpt-every", "2"])
    assert tckpt.all_steps(str(tmp_path)) == [2, 3]
    restored = tckpt.restore(state, str(tmp_path))
    for a, b in zip(tckpt.tree_leaves(restored), tckpt.tree_leaves(state)):
        assert torch.equal(a, b)
    out = capsys.readouterr().out
    assert "[train] done" in out and "device=cpu" in out


def test_train_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _port_cfg(J_TINY)
    src = tpipe.SyntheticLM(cfg, 2, 8)
    for call in (lambda: tlaunch.main(["--arch", "gemma-7b"]),
                 lambda: tpipe.make_batch_fn(src),
                 lambda: init_train_state(
                     cfg, types.SimpleNamespace(device=torch.device("cuda"))),
                 lambda: train_state_from_jax({}, cfg)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_reduced_config_lives_in_the_train_launcher():
    assert tserve.reduced_config is tlaunch.reduced_config
    assert "reduced_config" in tserve.__all__


def test_elastic_restart_replays_on_the_cpu(capsys):
    from repro_torch import elastic_restart
    assert elastic_restart.main(["--device", "cpu"]) == 0.0
    out = capsys.readouterr().out
    # the reshard half: saved on (2, 1), restored on (1, 2) and on one
    # device bit for bit, the next step as one device's
    assert "restarts=1" in out and "restored on (1, 2): bits equal " \
        "True; on one device: bits equal True" in out
