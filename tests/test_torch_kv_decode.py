"""The port's deep-cache decode path against the JAX package, on the CPU:
the int8 KV cache, ``flash_decode`` and the sharding rules.

* ``init_cache(kv_dtype="int8")``: every leaf's path, shape and dtype
  equal the reference's at the tiny layouts of tests/test_models.py
  (``tiny``) of an attention, a sliding-window, an MLA, a hybrid and an
  SSM config; the int8 cache's bytes under 0.62 of the bf16 one's, as
  ``tests/test_models.py::test_int8_kv_decode`` asserts.
* Decode, that test's model (``tiny(qwen1.5-32b, float32,
  n_kv_heads=4)``, the reference's parameters carried across): 20 steps
  from an empty cache, bf16 and int8, the port's logits within 1e-4
  (max abs) of the reference's at every step; the int8 codes equal
  except on at most 0.1% of the entries, and those by 1 (the two
  frameworks' k and v differ in their last bits, so a value on a
  rounding boundary can round either way); the scales within 1e-6
  relative; the reference test's bands (bf16 < 2e-3, int8 < 1.0 off the
  full-sequence forward) held by both; then one more step from the
  reference's own cache brought over by ``cache_from_jax``.
* ``flash_decode``: the partials of 1, 2, 4 and 8 shards combined in one
  process (``flash_decode_combine`` without a group runs the same max
  and sums over a shard axis) against the reference's
  ``decode_attention`` and its ``flash_decode`` on a (1, 1) mesh, at
  2e-5 (the reference test's tolerance and inputs: B 2, T 64, H 2, hd
  16, lengths 13 and 40), with GQA (4 q over 2 kv heads) and a window.
* ``sharding/rules.py``: ``spec_for_axes``, ``param_shardings``,
  ``opt_state_shardings``, ``batch_sharding`` and ``cache_shardings``
  (int8 and bf16, sequence-sharded or not) equal the reference's
  ``PartitionSpec``s on ``jax.sharding.AbstractMesh`` for every config
  over meshes (2, 2), (16, 16) and (2, 16, 16), with ``fsdp`` and
  ``allow_uneven`` both ways (no devices); ``model_axes`` and
  ``spec_shapes`` equal the reference's for every config.

The seq-sharded ``decode_step`` on two gloo ranks is held against the
reference in tests/test_torch_mesh.py.
"""

import dataclasses
import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from test_models import tiny

from repro.configs import base as jbase
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import transformer as jtr
from repro.sharding import rules as jrules
from repro_torch.configs import base as tbase
from repro_torch.convert import cache_from_jax, lm_params_from_jax
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon
from repro_torch.models import transformer as ttr
from repro_torch.sharding import rules as trules

CPU = torch.device("cpu")
STEPS = 20
LOGITS_TOL = 1e-4
CODE_FLIPS = 1e-3
# the scales: 1e-6 at the first layer, whose k and v come from the same
# embeddings in both frameworks; deeper layers carry the two frameworks'
# f32 differences (their f32 caches' k and v differ by 2.5e-6 to 5e-6 of
# the largest value at layers 1-3, measured on the CPU), held at 1e-5
SCALE_RTOL = {"first layer": 1e-6, "every layer": 1e-5}
DECODE_TOL = dict(atol=2e-5, rtol=2e-5)
CACHE_ARCHS = ("qwen1.5-32b", "gemma3-4b", "minicpm3-4b", "hymba-1.5b",
               "mamba2-2.7b")
MESHES = (((2, 2), ("data", "model")), ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")))
RULES = [dict(fsdp=f, allow_uneven=u)
         for f, u in itertools.product((False, True), repeat=2)]


def _port_cfg(jcfg):
    return tbase.ArchConfig(**dataclasses.asdict(jcfg))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: v})
    return out


def _dtype_name(a) -> str:
    return str(a.dtype).removeprefix("torch.")


def _nbytes(tree) -> int:
    return sum(a.numel() * a.element_size() if isinstance(a, torch.Tensor)
               else a.nbytes for a in _flat(tree).values())


# ---------------------------------------------------------------------------
# The int8 cache's layout.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", CACHE_ARCHS)
def test_int8_cache_layout_matches_reference(arch):
    jcfg = tiny(jbase.get_config(arch))
    tcfg = _port_cfg(jcfg)
    for kvd in ("bf16", "int8"):
        ref = _flat(jtr.init_cache(jcfg, 2, 24, kv_dtype=kvd))
        got = _flat(ttr.init_cache(tcfg, 2, 24, kv_dtype=kvd, device=CPU))
        assert {k: (tuple(v.shape), _dtype_name(v)) for k, v in got.items()} \
            == {k: (tuple(v.shape), _dtype_name(v)) for k, v in ref.items()}
        assert all(not v.any() for v in got.values())
    if arch == "qwen1.5-32b":
        c8 = ttr.init_cache(tcfg, 2, 24, kv_dtype="int8", device=CPU)
        c16 = ttr.init_cache(tcfg, 2, 24, kv_dtype="bf16", device=CPU)
        assert _nbytes(c8) < 0.62 * _nbytes(c16)
        assert _nbytes(c8) == _nbytes(jtr.init_cache(jcfg, 2, 24,
                                                     kv_dtype="int8"))
    with pytest.raises(ValueError, match="kv_dtype"):
        ttr.init_cache(tcfg, 2, 24, kv_dtype="fp8", device=CPU)


def test_quantize_kv_rounds_half_to_even_and_clips():
    """One scale a token over its heads and head dim; codes rounded half
    to even (the reference's ``jnp.round``), clipped to ±127; an all-zero
    token keeps the floor scale 1e-8; dequantization rounds once in the
    activation dtype."""
    x = torch.zeros((2, 1, 2, 4))
    x[0, 0, 0] = torch.tensor([127.0, 0.5, 1.5, -2.5])
    codes, scales = tattn.quantize_kv(x)
    assert scales.shape == (2, 1, 1, 1) and scales.dtype == torch.float32
    assert codes.dtype == torch.int8
    assert codes[0, 0, 0].tolist() == [127, 0, 2, -2]
    assert scales[0].item() == 1.0 and scales[1].item() == np.float32(1e-8)
    assert not codes[1].any()
    deq = tattn.dequantize_kv(codes, scales, torch.bfloat16)
    assert deq.dtype == torch.bfloat16
    assert deq[0, 0, 0].tolist() == [127.0, 0.0, 2.0, -2.0]


# ---------------------------------------------------------------------------
# Decode from an int8 cache, against the reference.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def decode_runs():
    """test_models' int8 decode model: the reference's 20 steps from an
    empty cache at both kv dtypes (one jitted step), its full-sequence
    forward, its caches after the 20 steps and its step 21 from them;
    the port's 20 steps on the same parameters."""
    jcfg = tiny(jbase.get_config("qwen1.5-32b"), dtype="float32",
                n_kv_heads=4)
    tcfg = _port_cfg(jcfg)
    params = jtr.init(jcfg, jax.random.PRNGKey(0))
    toks = jax.random.randint(jax.random.PRNGKey(1), (2, STEPS + 1), 0,
                              jcfg.vocab)
    ref_full = np.asarray(jtr.forward(params, {"tokens": toks[:, :STEPS]},
                                      jcfg, mode="train")[0])
    step = jax.jit(functools.partial(jtr.decode_step, cfg=jcfg))
    tparams = lm_params_from_jax(jax.tree.map(np.asarray, params), tcfg,
                                 CPU, torch.float32)
    ttoks = torch.tensor(np.asarray(toks)).long()
    runs = {}
    for kvd in ("bf16", "int8"):
        cache = jtr.init_cache(jcfg, 2, 24, kv_dtype=kvd)
        tcache = ttr.init_cache(tcfg, 2, 24, kv_dtype=kvd, device=CPU)
        ref, got = [], []
        for t in range(STEPS):
            lg, cache = step(params, cache, toks[:, t:t + 1],
                             jnp.full((2,), t, jnp.int32))
            ref.append(np.asarray(lg))
            with torch.no_grad():
                tl, tcache = ttr.decode_step(tparams, tcache,
                                             ttoks[:, t:t + 1],
                                             torch.full((2,), t), tcfg)
            got.append(tl.numpy())
        np_cache = jax.tree.map(np.asarray, cache)
        nxt = np.asarray(step(params, cache, toks[:, STEPS:],
                              jnp.full((2,), STEPS, jnp.int32))[0])
        runs[kvd] = dict(ref=np.stack(ref), got=np.stack(got),
                         ref_cache=np_cache, cache=tcache, next=nxt)
    return dict(jcfg=jcfg, tcfg=tcfg, params=tparams, toks=ttoks,
                full=ref_full, runs=runs)


@pytest.mark.parametrize("kvd", ["bf16", "int8"])
def test_decode_logits_match_reference_every_step(decode_runs, kvd):
    run = decode_runs["runs"][kvd]
    err = np.abs(run["got"] - run["ref"]).max(axis=(1, 2))
    assert err.max() <= LOGITS_TOL, err
    # the reference test's bands against the full-sequence forward, held
    # by both packages
    band = {"bf16": 2e-3, "int8": 1.0}[kvd]
    full = decode_runs["full"].transpose(1, 0, 2)
    for logits in (run["ref"], run["got"]):
        assert np.abs(logits - full).max() < band


def test_int8_codes_and_scales_match_reference(decode_runs):
    run = decode_runs["runs"]["int8"]
    got, ref = _flat(run["cache"]), _flat(run["ref_cache"])
    assert set(got) == set(ref)
    flips = total = 0
    for path, r in ref.items():
        g = got[path].numpy()
        if path.endswith(("k_s", "v_s")):
            np.testing.assert_allclose(g[0], r[0], atol=0,
                                       rtol=SCALE_RTOL["first layer"])
            np.testing.assert_allclose(g, r, atol=0,
                                       rtol=SCALE_RTOL["every layer"])
            continue
        d = np.abs(g.astype(np.int32) - r.astype(np.int32))
        assert d.max() <= 1, path
        flips += int((d > 0).sum())
        total += d.size
    assert flips <= CODE_FLIPS * total, (flips, total)


@pytest.mark.parametrize("kvd", ["bf16", "int8"])
def test_decode_goes_on_from_a_reference_cache(decode_runs, kvd):
    """The reference's cache after 20 steps, carried across by
    ``cache_from_jax``, decodes step 21 as the reference does."""
    run = decode_runs["runs"][kvd]
    cache = cache_from_jax(run["ref_cache"], decode_runs["tcfg"], CPU)
    assert {k: (tuple(v.shape), v.dtype) for k, v in _flat(cache).items()} \
        == {k: (tuple(v.shape), v.dtype)
            for k, v in _flat(run["cache"]).items()}
    with torch.no_grad():
        lg, _ = ttr.decode_step(decode_runs["params"], cache,
                                decode_runs["toks"][:, STEPS:],
                                torch.full((2,), STEPS), decode_runs["tcfg"])
    assert np.abs(lg.numpy() - run["next"]).max() <= LOGITS_TOL
    if kvd == "int8":
        # a leaf of another dtype than the port's cache holds there
        attn = dict(run["ref_cache"]["seg0"]["pos0"]["attn"])
        attn["v"] = attn["v"].astype(np.float32)
        with pytest.raises(ValueError, match="expected torch.int8"):
            cache_from_jax({"seg0": {"pos0": {"attn": attn}}},
                           decode_runs["tcfg"], CPU)


# ---------------------------------------------------------------------------
# flash_decode: emulated shards against the reference.
# ---------------------------------------------------------------------------

FLASH_CASES = {"mha": (2, 2, 0), "gqa 4 over 2": (4, 2, 0),
               "window 16": (2, 2, 16)}


@pytest.fixture(scope="module")
def flash_refs():
    """Per case: the inputs, the reference's ``decode_attention`` and its
    ``flash_decode`` on a (1, 1) mesh."""
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    out = {}
    for name, (hq, hk, window) in FLASH_CASES.items():
        rng = np.random.default_rng(0)
        b, t, hd = 2, 64, 16
        q = rng.normal(size=(b, 1, hq, hd)).astype(np.float32)
        k = rng.normal(size=(b, t, hk, hd)).astype(np.float32)
        v = rng.normal(size=(b, t, hk, hd)).astype(np.float32)
        lens = np.asarray([13, 40])
        dense = jattn.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), jnp.asarray(lens),
                                       window=window)
        with mesh:
            fd = jax.jit(lambda *a, w=window: jattn.flash_decode(
                *a, mesh=mesh, window=w))(q, k, v, lens)
        out[name] = dict(x=[torch.tensor(a) for a in (q, k, v, lens)],
                         window=window, dense=np.asarray(dense),
                         flash=np.asarray(fd))
    return out


@pytest.mark.parametrize("shards", [1, 2, 4, 8])
@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_decode_shards_match_reference(flash_refs, case, shards):
    ref = flash_refs[case]
    q, k, v, lens = ref["x"]
    t = k.shape[1] // shards
    parts = [tattn.flash_decode_partials(q, k[:, i * t:(i + 1) * t],
                                         v[:, i * t:(i + 1) * t], lens,
                                         i * t, ref["window"])
             for i in range(shards)]
    out = tattn.flash_decode_combine(*(torch.stack(p) for p in zip(*parts)))
    b, _, hq, hd = q.shape
    got = out.permute(0, 3, 1, 2, 4).reshape(b, 1, hq, hd).numpy()
    np.testing.assert_allclose(got, ref["dense"], **DECODE_TOL)
    np.testing.assert_allclose(got, ref["flash"], **DECODE_TOL)
    whole = tattn.flash_decode(q, k, v, lens, window=ref["window"]).numpy()
    np.testing.assert_allclose(whole, ref["flash"], **DECODE_TOL)
    if shards > 1:
        # the partials summed without their rescaling to the global max
        # are off
        m, den, num = (torch.stack(p) for p in zip(*parts))
        wrong = (num.sum(0) / den.sum(0)[..., None])
        wrong = wrong.permute(0, 3, 1, 2, 4).reshape(b, 1, hq, hd).numpy()
        assert np.abs(wrong - ref["dense"]).max() > 1e-2


# ---------------------------------------------------------------------------
# Sharding rules, model_axes and spec_shapes.
# ---------------------------------------------------------------------------

def _spec(named) -> tuple:
    return tuple(named.spec)


def _jtree(tree) -> dict:
    """A reference tree of NamedShardings as nested dicts of spec
    tuples."""
    return {k: (_jtree(v) if isinstance(v, dict) else _spec(v))
            for k, v in tree.items()}


def _axes_tree(tree) -> dict:
    return {k: (_axes_tree(v) if isinstance(v, dict) else tuple(v))
            for k, v in tree.items()}


def _records(tree) -> dict:
    """A reference shapes tree as the port's ShapeDtype records."""
    return {k: (_records(v) if isinstance(v, dict) else
                tcommon.ShapeDtype(tuple(v.shape), torch.float32))
            for k, v in tree.items()}


@pytest.mark.parametrize("arch", jbase.list_configs())
def test_model_axes_and_spec_shapes_match_reference(arch):
    jcfg, tcfg = jbase.get_config(arch), tbase.get_config(arch)
    assert ttr.model_axes(tcfg) == _axes_tree(jtr.model_axes(jcfg))
    ref = jcommon.spec_shapes(jtr.model_specs(jcfg))
    got = tcommon.spec_shapes(ttr.model_specs(tcfg))
    assert _flat(got) == {k: tcommon.ShapeDtype(tuple(v.shape),
                                                torch.float32)
                          for k, v in _flat(ref).items()}


@pytest.mark.parametrize("arch", jbase.list_configs())
def test_param_and_opt_shardings_match_reference(arch):
    jcfg = jbase.get_config(arch)
    axes = jtr.model_axes(jcfg)
    shapes = jcommon.spec_shapes(jtr.model_specs(jcfg))
    taxes, tshapes = ttr.model_axes(_port_cfg(jcfg)), _records(shapes)
    for (sizes, names), kw in itertools.product(MESHES, RULES):
        mesh = AbstractMesh(sizes, names)
        jr, tr_ = jrules.Rules(**kw), trules.Rules(**kw)
        assert trules.param_shardings(mesh, taxes, tshapes, tr_) == \
            _jtree(jrules.param_shardings(mesh, axes, shapes, jr)), \
            (sizes, kw)
        assert trules.opt_state_shardings(mesh, taxes, tshapes, tr_) == \
            _jtree(jrules.opt_state_shardings(mesh, axes, shapes, jr)), \
            (sizes, kw)


@pytest.mark.parametrize("arch", [a for a in jbase.list_configs()
                                  if jbase.get_config(a).supports_decode])
def test_cache_shardings_match_reference(arch):
    jcfg = jbase.get_config(arch)
    for kvd, batch in itertools.product(("bf16", "int8"), (1, 32)):
        shapes = jax.eval_shape(lambda: jtr.init_cache(jcfg, batch, 64,
                                                       kv_dtype=kvd))
        for (sizes, names), seq in itertools.product(MESHES, (False, True)):
            mesh = AbstractMesh(sizes, names)
            assert trules.cache_shardings(mesh, _records(shapes),
                                          seq_shard=seq) == \
                _jtree(jrules.cache_shardings(mesh, shapes, seq_shard=seq)), \
                (kvd, batch, sizes, seq)


def test_spec_for_axes_and_batch_sharding_match_reference():
    """The reference tests' FakeMesh cases, then every small case over the
    three meshes: ``spec_for_axes`` on each logical axis pair and dims,
    ``batch_sharding`` on each layout and batch size; the port reads a
    ``(data, model)`` pair as a mesh too."""
    class FakeMesh:
        shape = {"data": 4, "model": 4}
    assert trules.spec_for_axes(("embed", "mlp"), (64, 128), FakeMesh(),
                                trules.Rules()) == (None, "model")
    assert trules.spec_for_axes(("embed", "mlp"), (64, 128), (4, 4),
                                trules.Rules(fsdp=True)) == ("data", "model")
    logical = (None, "embed", "mlp", "heads", "vocab", "layers")
    for (sizes, names), kw in itertools.product(MESHES, RULES):
        mesh = AbstractMesh(sizes, names)
        jr, tr_ = jrules.Rules(**kw), trules.Rules(**kw)
        for axes in itertools.product(logical, repeat=2):
            for shape in ((64, 128), (48, 50), (2, 16)):
                assert trules.spec_for_axes(axes, shape, mesh, tr_) == \
                    tuple(jrules.spec_for_axes(axes, shape, mesh, jr))
        # a sequence dim over data beside a batch over data is no spec
        # (the reference's NamedSharding refuses it): with a sequence
        # dim, batch 1, as its long-context decode
        for ndim, bdim, sdim, bs in [
                (n, 0, None, b) for n, b in itertools.product(
                    (2, 3), (None, 1, 2, 4, 32, 64))] + [(2, 0, 1, 1),
                                                         (3, 0, 1, 1)]:
            want = jrules.batch_sharding(mesh, ndim, jr, batch_dim=bdim,
                                         seq_axis_dim=sdim, seq_axis="data",
                                         batch_size=bs)
            assert trules.batch_sharding(mesh, ndim, tr_, batch_dim=bdim,
                                         seq_axis_dim=sdim, seq_axis="data",
                                         batch_size=bs) == _spec(want)


def test_local_block_cuts_a_rank_s_rows():
    """``local_block`` under ``cache_shardings(seq_shard=True)``: each
    data rank's block of the sequence, concatenated in rank order, is
    the global cache; a dim the axis does not divide raises."""
    tcfg = _port_cfg(tiny(jbase.get_config("qwen1.5-32b")))
    cache = ttr.init_cache(tcfg, 2, 64, kv_dtype="int8", device=CPU)
    for leaf in _flat(cache).values():
        leaf.copy_(torch.arange(leaf.numel()).reshape(leaf.shape)
                   .to(leaf.dtype))
    specs = trules.cache_shardings((4, 1), cache, seq_shard=True)
    assert specs["seg0"]["pos0"]["attn"]["k"] == (None, None, "data",
                                                  "model")
    for path, leaf in _flat(cache).items():
        spec = _flat(specs)[path]
        blocks = [trules.local_block(leaf, spec, (4, 1),
                                     {"data": d, "model": 0})
                  for d in range(4)]
        assert all(b.shape[2] == 16 for b in blocks)
        assert torch.equal(torch.cat(blocks, dim=2), leaf)
    with pytest.raises(ValueError, match="divide"):
        trules.local_block(torch.zeros(2, 6), (None, "data"), (4, 1),
                           {"data": 0})
