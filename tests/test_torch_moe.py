"""The port's mixture-of-experts layer, OLMoE-1B-7B and Llama-4-Scout
against the JAX package's, on the CPU.

``moe_apply`` (dispatch by index) and ``moe_apply_plain`` (the
reference's one-hot einsums) are held to ``repro.models.moe.moe_apply``
on the same numpy inputs at the tiny presets of ``olmoe-1b-7b`` (8
experts, top-2, expert d_ff 64) and ``llama4-scout-17b-a16e`` (8
experts, top-1, one shared expert): one group, several groups (B = 2,
S = 256), ``capacity_factor`` 0.25 (drops certain) and a router with
duplicated columns (ties certain: three tied experts at top-2, two at
top-1), where ``torch.topk``'s tie order would send tokens elsewhere.
The whole tiny models run on the reference's parameters (converted by
``lm_params_from_jax``): logits, caches, decode steps, the loss with
its aux terms and every gradient, and the engine's greedy tokens with
more slots than requests, so that idle slots compete for capacity.

Tolerances: a layer in f32 at 1e-5 of each value and of the largest
(two f32 summation orders); in bf16 within ``BF16_NORM`` of the norm
(tests/test_torch_llm.py says why); the models at ``F32_MODEL``; the
gradients at 1e-5 of each leaf's largest element on weights conditioned
to fan-in = width (tests/test_torch_gemma3.py says why).
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
from repro.models import moe as jmoe
from repro.models import transformer as jtr
from repro.serve import engine as jengine
from repro_torch.configs import base as tbase
from repro_torch.convert import lm_params_from_jax
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as tlaunch
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttr
from repro_torch.serve.engine import (DecodeEngine, EngineConfig, Request,
                                      _merge_slot_cache)
from repro_torch.train import checkpoint as tckpt
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_state import init_train_state, make_train_step
from test_torch_llm import BF16_NORM, _close, _flat, _np_params, _port_cfg

CPU = torch.device("cpu")
ARCHS = ["olmoe-1b-7b", "llama4-scout-17b-a16e"]
F32_LAYER = 1e-5
# parameters at full width (the reference's count_params) and the depth
# cuts chip_smoke.py drives: OLMoE trained at 4 of 16 layers, Llama-4-
# Scout served at 8 of 48
FULL_PARAMS = {"olmoe-1b-7b": 6_919_620_608,
               "llama4-scout-17b-a16e": 107_771_827_200}
CUTS = {"olmoe-1b-7b": (4, 1_884_833_792),
        "llama4-scout-17b-a16e": (8, 19_687_756_800)}
# the layer's cases: (B, S, capacity_factor, tied experts)
CASES = {"one_group": (1, 64, None, 0), "groups": (2, 256, None, 0),
         "drops": (2, 256, 0.25, 0), "ties": (2, 256, None, 1)}
# tied router columns: three experts at OLMoE's top-2, two at Llama-4-
# Scout's top-1, each the first one's column made the largest by 3x
# (torch.topk on the CPU breaks these ties by the data: of a tie at
# columns 1 and 2 of 8 at k = 1 it picks 1, the lower, every time; at 2
# and 6 either)
TIED = {"olmoe-1b-7b": (1, 2, 3), "llama4-scout-17b-a16e": (2, 6)}


def _cfgs(arch, dtype="float32"):
    jcfg = dataclasses.replace(j_reduced_config(arch, "tiny"), dtype=dtype)
    return jcfg, _port_cfg(jcfg)


def _layer_params(arch, tied: bool) -> dict:
    jcfg, _ = _cfgs(arch)
    np_params = {k: np.asarray(v, np.float32) for k, v in
                 jcommon.init_params(jax.random.PRNGKey(7),
                                     jmoe.moe_specs(jcfg)).items()}
    if tied:
        cols = TIED[arch]
        router = np_params["router"].copy()
        router[:, list(cols)] = 3 * router[:, [cols[0]]]
        np_params["router"] = router
    return np_params


@functools.cache
def _reference_layer(arch, case, dtype):
    """The reference's ``moe_apply`` on one case: (params, x, y, aux) as
    numpy (f32)."""
    b, s, cf, tied = CASES[case]
    jcfg, _ = _cfgs(arch, dtype)
    np_params = _layer_params(arch, bool(tied))
    x = np.random.default_rng(11).normal(size=(b, s, jcfg.d_model)
                                         ).astype(np.float32)
    jdt = jcfg.activation_dtype
    fn = jax.jit(functools.partial(jmoe.moe_apply, cfg=jcfg,
                                   capacity_factor=cf))
    y, aux = fn(jax.tree.map(lambda a: jnp.asarray(a, jdt), np_params),
                jnp.asarray(x, jdt))
    return np_params, x, np.asarray(y, np.float32), {
        k: np.asarray(v, np.float32) for k, v in aux.items()}


def _port_layer(fn, arch, case, dtype):
    np_params, x, _, _ = _reference_layer(arch, case, dtype)
    _, tcfg = _cfgs(arch, dtype)
    dt = tcfg.activation_dtype
    params = {k: torch.tensor(v).to(dt) for k, v in np_params.items()}
    return fn(params, torch.tensor(x).to(dt), tcfg,
              capacity_factor=CASES[case][2])


@pytest.mark.parametrize("fn", [tmoe.moe_apply, tmoe.moe_apply_plain],
                         ids=["moe_apply", "plain"])
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_layer_f32_matches_reference(arch, case, fn):
    """f32: ``y`` and the three aux entries within 1e-5 of the
    reference's."""
    _, _, y_ref, aux_ref = _reference_layer(arch, case, "float32")
    y, aux = _port_layer(fn, arch, case, "float32")
    assert y.dtype == torch.float32 and y.shape == y_ref.shape
    np.testing.assert_allclose(y.numpy(), y_ref, rtol=F32_LAYER,
                               atol=F32_LAYER * np.abs(y_ref).max())
    assert sorted(aux) == sorted(aux_ref)
    for key, want in aux_ref.items():
        assert aux[key].dtype == torch.float32
        np.testing.assert_allclose(aux[key].numpy(), want, rtol=F32_LAYER,
                                   atol=1e-7, err_msg=key)


@pytest.mark.parametrize("fn", [tmoe.moe_apply, tmoe.moe_apply_plain],
                         ids=["moe_apply", "plain"])
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_layer_bf16_close_to_reference(arch, case, fn):
    """bf16 (the router rounded to it before the f32 softmax): ``y``
    within ``BF16_NORM`` of the reference's norm, the aux terms (f32 on
    both sides, from bf16 logits) at 1e-5."""
    _, _, y_ref, aux_ref = _reference_layer(arch, case, "bfloat16")
    y, aux = _port_layer(fn, arch, case, "bfloat16")
    assert y.dtype == torch.bfloat16
    y = y.float().numpy()
    assert np.linalg.norm(y - y_ref) <= BF16_NORM * np.linalg.norm(y_ref)
    for key, want in aux_ref.items():
        np.testing.assert_allclose(aux[key].numpy(), want, rtol=1e-5,
                                   atol=1e-7, err_msg=key)


@pytest.mark.parametrize("arch", ARCHS)
def test_the_cases_route_as_described(arch):
    """The drops case drops pairs, the ties case has tied probabilities at
    the top-k boundary, and the others keep every pair but a few."""
    _, tcfg = _cfgs(arch)
    k = tcfg.top_k
    for case, (b, s, cf, tied) in CASES.items():
        np_params, x, _, _ = _reference_layer(arch, case, "float32")
        sg = min(tmoe.DEFAULT_GROUP, b * s)
        logits = tmoe.router_logits(
            {"router": torch.tensor(np_params["router"])},
            torch.tensor(x).reshape(-1, sg, tcfg.d_model))
        cap = tmoe.expert_capacity(sg, k, cf or tcfg.capacity_factor,
                                   tcfg.n_experts)
        r = tmoe.route(logits, k, cap)
        probs = r.probs.sort(dim=-1, descending=True).values
        boundary_ties = (probs[..., k - 1] == probs[..., k]).float().mean()
        dropped = 1 - r.keep.float().mean()
        if case == "ties":
            assert boundary_ties > 0.2, boundary_ties
        else:
            assert boundary_ties == 0
        if case == "drops":
            assert dropped > 0.5, dropped
        else:
            assert dropped < 0.25, dropped


@pytest.mark.parametrize("arch", ARCHS)
def test_ties_fail_with_torch_topk(arch, monkeypatch):
    """The ties case is a real check: with ``torch.topk`` in place of the
    stable sort the port sends tokens to other experts than the
    reference and ``y`` misses the f32 tolerance by far."""
    _, _, y_ref, _ = _reference_layer(arch, "ties", "float32")
    monkeypatch.setattr(tmoe, "top_k",
                        lambda p, k: torch.topk(p, k, dim=-1).indices)
    y, _ = _port_layer(tmoe.moe_apply, arch, "ties", "float32")
    assert np.abs(y.numpy() - y_ref).max() > 100 * F32_LAYER * \
        np.abs(y_ref).max()


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("arch", ARCHS)
def test_route_equals_route_plain_bit_for_bit(arch, case):
    """The routing by stable sort and flat cumsum against the plain
    form's ``argmax`` rounds and one-hot arithmetic: experts, positions
    and keep masks equal, gates and probabilities bit for bit."""
    np_params, x, _, _ = _reference_layer(arch, case, "bfloat16")
    _, tcfg = _cfgs(arch, "bfloat16")
    b, s, cf, _ = CASES[case]
    sg = min(tmoe.DEFAULT_GROUP, b * s)
    logits = tmoe.router_logits(
        {"router": torch.tensor(np_params["router"]).bfloat16()},
        torch.tensor(x).bfloat16().reshape(-1, sg, tcfg.d_model))
    cap = tmoe.expert_capacity(sg, tcfg.top_k, cf or tcfg.capacity_factor,
                               tcfg.n_experts)
    got = tmoe.route(logits, tcfg.top_k, cap)
    want = tmoe.route_plain(logits, tcfg.top_k, cap)
    for name, a, w in zip(got._fields, got, want):
        assert torch.equal(a, w), name


def test_group_size_must_divide_the_tokens():
    """S = 300 at B = 1: groups of 256 do not divide 300 tokens; the
    reference asserts, the port raises ``ValueError`` naming the rule,
    on both forms and through the model's prefill."""
    jcfg, tcfg = _cfgs("olmoe-1b-7b")
    np_params = _layer_params("olmoe-1b-7b", False)
    x = np.zeros((1, 300, jcfg.d_model), np.float32)
    with pytest.raises(AssertionError):
        jmoe.moe_apply(jax.tree.map(jnp.asarray, np_params), jnp.asarray(x),
                       jcfg)
    params = {k: torch.tensor(v) for k, v in np_params.items()}
    for fn in (tmoe.moe_apply, tmoe.moe_apply_plain):
        with pytest.raises(ValueError, match="multiple of it"):
            fn(params, torch.tensor(x), tcfg)
    tp = ttr.init(tcfg, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="divide the 300 tokens"):
        ttr.forward(tp, {"tokens": torch.zeros((1, 300), dtype=torch.long)},
                    tcfg, mode="prefill")
    # 512 tokens (two groups) and 255 (one) are taken
    for s in (512, 255):
        ttr.forward(tp, {"tokens": torch.zeros((1, s), dtype=torch.long)},
                    tcfg, mode="prefill", last_logit_only=True)


@pytest.mark.parametrize("term", ["y", "aux"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_gradients_match_reference_and_replay(arch, term):
    """f32, with drops (``capacity_factor`` 0.5, two groups): the
    gradients of ``sum(y·w)`` and of ``load_balance_loss +
    router_z_loss`` wrt x and every weight against ``jax.grad`` of the
    reference's at 1e-5 of each leaf's largest; the backward run twice
    gives the same bits (the dispatch's both directions are gathers).
    At top-1 the renormalised gate is p / p = 1, whose derivative is 0:
    the router's gradient of ``sum(y·w)`` is then what each framework's
    f32 rounding of that 0 leaves (2.3e-4 here, in both), so the
    router is held there on the aux terms alone."""
    jcfg, tcfg = _cfgs(arch)
    np_params = _layer_params(arch, False)
    rng = np.random.default_rng(12)
    x = rng.normal(size=(2, 256, jcfg.d_model)).astype(np.float32)
    w = rng.normal(size=x.shape).astype(np.float32)

    def jloss(p, x):
        y, aux = jmoe.moe_apply(p, x, jcfg, capacity_factor=0.5)
        if term == "y":
            return jnp.sum(y * w)
        return aux["load_balance_loss"] + aux["router_z_loss"]
    jg = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
        jax.tree.map(jnp.asarray, np_params), jnp.asarray(x))

    def tgrads():
        p = {k: torch.tensor(v, requires_grad=True)
             for k, v in np_params.items()}
        xt = torch.tensor(x, requires_grad=True)
        y, aux = tmoe.moe_apply(p, xt, tcfg, capacity_factor=0.5)
        loss = (y * torch.tensor(w)).sum() if term == "y" else \
            aux["load_balance_loss"] + aux["router_z_loss"]
        names = sorted(p)
        grads = torch.autograd.grad(loss, [p[n] for n in names] + [xt],
                                    allow_unused=term == "aux")
        return dict(zip(names + ["x"], grads))
    got, again = tgrads(), tgrads()
    want = dict(jg[0], x=jg[1])
    assert sorted(got) == sorted(want)
    held = {"router", "x"} if term == "aux" else set(got) - (
        {"router"} if tcfg.top_k == 1 else set())
    for name in held:
        g = got[name]
        assert torch.equal(g, again[name]), name
        ref = np.asarray(want[name])
        assert np.abs(ref).max() > 0, name
        np.testing.assert_allclose(g.numpy(), ref, rtol=1e-5,
                                   atol=1e-5 * np.abs(ref).max(),
                                   err_msg=name)


# ---------------------------------------------------------------------------
# Specs and counts at full width.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_specs_and_counts_match_reference(arch):
    """Every spec path, shape, axes and initializer at full width; the
    parameter count, model FLOPs a token (6·N_active) and the depth
    cut's count; the tiny preset's config."""
    jcfg, tcfg = jbase.get_config(arch), tbase.get_config(arch)
    want = {"/".join(p.key for p in path): (s.shape, s.axes, s.init,
                                            s.scale)
            for path, s in jax.tree_util.tree_flatten_with_path(
                jtr.model_specs(jcfg),
                is_leaf=lambda x: isinstance(x, jcommon.PSpec))[0]}
    got = {p: (s.shape, s.axes, s.init, s.scale)
           for p, s in _flat(ttr.model_specs(tcfg)).items()}
    assert got == want
    mlp = {p.rsplit("/", 1)[1] for p in got if "/mlp/" in p}
    assert mlp == ({"router", "wi", "wg", "wo"} if not tcfg.n_shared_experts
                   else {"router", "wi", "wg", "wo", "shared_wi",
                         "shared_wg", "shared_wo"})
    assert ttr.count_params(tcfg) == jtr.count_params(jcfg) == \
        FULL_PARAMS[arch]
    assert ttr.model_flops_per_token(tcfg) == \
        jtr.model_flops_per_token(jcfg) < 6.0 * FULL_PARAMS[arch]
    layers, n = CUTS[arch]
    assert ttr.count_params(dataclasses.replace(tcfg, n_layers=layers)) \
        == jtr.count_params(dataclasses.replace(jcfg, n_layers=layers)) == n
    assert dataclasses.asdict(tserve.reduced_config(arch, "tiny")) == \
        dataclasses.asdict(j_reduced_config(arch, "tiny"))


# ---------------------------------------------------------------------------
# The tiny models.
# ---------------------------------------------------------------------------

TRAIN_S = 64
PROMPTS = (TRAIN_S, 13)
MAX_LEN = 80
DECODE_STEPS = 4


@functools.cache
def _reference(arch):
    """The reference's tiny model in f32: its numpy parameters, the train
    logits and aux of 2 x TRAIN_S tokens, each prompt's prefill logits
    and cache, DECODE_STEPS batched decode steps and their cache."""
    jcfg, _ = _cfgs(arch)
    np_params = _np_params(jcfg)
    jp = jax.tree.map(jnp.asarray, np_params)
    rng = np.random.default_rng(31)
    toks = rng.integers(0, jcfg.vocab, size=(2, TRAIN_S))
    train, _, aux = jax.jit(functools.partial(jtr.forward, cfg=jcfg))(
        jp, {"tokens": jnp.asarray(toks)})
    prefill_fn = jax.jit(functools.partial(jtr.forward, cfg=jcfg,
                                           mode="prefill"))
    decode_fn = jax.jit(functools.partial(jtr.decode_step, cfg=jcfg))
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
    return dict(np_params=np_params, toks=toks, train=train, aux=aux,
                prompts=prompts, prefills=prefills, steps=steps,
                lengths=lengths, decodes=decodes, cache=cache)


def _jflat(tree) -> dict:
    return {"/".join(p.key for p in path): a for path, a in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("impl", ["flash", "naive"])
@pytest.mark.parametrize("arch", ARCHS)
def test_tiny_model_matches_reference(arch, impl):
    """f32, at each ``attn_impl``: the train logits and the summed aux
    terms, each prompt's prefill logits and cache (merged into two slots
    by the engine's ``_merge_slot_cache``), DECODE_STEPS batched decode
    steps (both slots one routing group) and the cache they wrote."""
    ref = _reference(arch)
    _, tcfg = _cfgs(arch)
    tp = lm_params_from_jax(ref["np_params"], tcfg, CPU)
    flags = ttr.RunFlags(attn_impl=impl)
    train, none, aux = ttr.forward(tp, {"tokens": torch.tensor(ref["toks"])},
                                   tcfg, flags=flags, return_aux=True)
    assert none is None
    _close(train, ref["train"])
    for key in ("load_balance_loss", "router_z_loss"):
        assert float(aux[key]) > 0
        np.testing.assert_allclose(float(aux[key]), float(ref["aux"][key]),
                                   rtol=F32_LAYER, err_msg=key)
    cache = ttr.init_cache(tcfg, 2, MAX_LEN, device=CPU)
    for slot, (prompt, (jl, jpc)) in enumerate(zip(ref["prompts"],
                                                   ref["prefills"])):
        lg, pc = ttr.forward(tp, {"tokens": torch.tensor(prompt[None])},
                             tcfg, mode="prefill", flags=flags)
        _close(lg, jl)
        for path, a in _jflat(jpc).items():
            _close(_flat(pc)[path], a)
        _merge_slot_cache(cache, pc, slot, len(prompt))
    for t in range(DECODE_STEPS):
        lg, cache = ttr.decode_step(tp, cache, torch.tensor(ref["steps"][t]),
                                    torch.tensor(ref["lengths"] + t), tcfg,
                                    flags)
        _close(lg, ref["decodes"][t])
    for path, a in _jflat(ref["cache"]).items():
        _close(_flat(cache)[path], a)


def _conditioned(np_params, d_model):
    """Each stacked matrix scaled from the reference's fan-in (the layer
    count) to its input width (the experts' ``(L, E, in, out)`` too), the
    embedding to ``d_model**-0.5``; the router keeps its own scale."""
    def leaf(path, a):
        key = path[-1].key
        if key == "router":
            return a
        if a.ndim in (3, 4):
            return a * np.float32(np.sqrt(a.shape[0] / a.shape[-2]))
        if key == "embed":
            return a * np.float32(d_model ** -0.5)
        return a
    return jax.tree_util.tree_map_with_path(leaf, np_params)


@pytest.mark.parametrize("remat", [False, True], ids=["no_remat", "remat"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_reference(arch, remat):
    """f32: ``loss_fn`` (the cross-entropy plus 0.01·aux_lb + 1e-3·aux_z)
    of the tiny model over 2 x TRAIN_S tokens, its metrics, and every
    gradient (the router's through the gates and the aux terms) against
    ``jax.grad`` of the reference's, each within 1e-5 of its largest
    element, on conditioned weights; under remat the aux sum passes
    through the checkpoint."""
    ref = _reference(arch)
    jcfg, tcfg = _cfgs(arch)
    np_params = _conditioned(ref["np_params"], jcfg.d_model)
    loss = functools.partial(jtr.loss_fn, cfg=jcfg,
                             flags=jtr.RunFlags(remat=False))
    (jtotal, jm), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jax.tree.map(jnp.asarray, np_params),
        {"tokens": jnp.asarray(ref["toks"])})
    tp = lm_params_from_jax(np_params, tcfg, CPU, torch.float32)
    leaves = [t.requires_grad_() for t in tckpt.tree_leaves(tp)]
    total, m = ttr.loss_fn(tp, {"tokens": torch.tensor(ref["toks"])}, tcfg,
                           ttr.RunFlags(remat=remat))
    grads = torch.autograd.grad(total, leaves)
    np.testing.assert_allclose(float(total.detach()), float(jtotal),
                               rtol=F32_LAYER)
    assert sorted(m) == sorted(jm)
    for key in ("loss", "aux_lb", "aux_z"):
        np.testing.assert_allclose(float(m[key].detach()), float(jm[key]),
                                   rtol=F32_LAYER, err_msg=key)
    assert float(m["aux_lb"].detach()) > 0 and float(m["aux_z"].detach()) > 0
    jflat = _jflat(jgrads)
    assert sorted(jflat) == sorted(_flat(tp))
    for path, got in zip(_flat(tp), grads):
        want = np.asarray(jflat[path])
        assert np.abs(want).max() > 0, path
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=path)


ENGINE = dict(n_slots=4, max_len=MAX_LEN, max_new=6, temperature=0.0)
ENGINE_PROMPTS = (5, 64, 19)


@functools.cache
def _reference_engine(arch):
    """The reference engine's greedy tokens, steps and each step's
    logits on ENGINE_PROMPTS over ENGINE's four slots (one always
    idle)."""
    jcfg, _ = _cfgs(arch)
    np_params = _np_params(jcfg, seed=1)
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
    """float32: three requests in four slots, so an idle slot routes with
    the active ones in every decode step's group (capacity 1 an expert
    at this size): the port's engine gives the reference engine's greedy
    tokens and steps, and every step's logits close."""
    np_params, prompts, tokens, steps, jlogits = _reference_engine(arch)
    _, tcfg = _cfgs(arch)
    k = tcfg.top_k
    assert tmoe.expert_capacity(ENGINE["n_slots"], k, tcfg.capacity_factor,
                                tcfg.n_experts) == 1
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


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_reports_the_aux_terms(arch):
    """``make_train_step`` on the tiny model: ``aux_lb`` and ``aux_z`` in
    the step's metrics, finite and nonzero, and ``total_loss`` = loss +
    0.01·aux_lb + 1e-3·aux_z; two replays of a step from one state give
    the same bits."""
    cfg = tlaunch.reduced_config(arch, "tiny")
    step = make_train_step(cfg, AdamWConfig(peak_lr=1e-3, warmup_steps=1,
                                            total_steps=4))
    batch = {"tokens": torch.tensor(np.random.default_rng(3).integers(
        0, cfg.vocab, size=(2, 128)))}
    runs = []
    for _ in range(2):
        state = init_train_state(cfg, torch.Generator().manual_seed(0))
        state, m = step(state, batch)
        runs.append((state, m))
    (state, m), (again, _) = runs
    assert float(m["aux_lb"]) > 0 and float(m["aux_z"]) > 0
    np.testing.assert_allclose(
        float(m["total_loss"]),
        float(m["loss"]) + 0.01 * float(m["aux_lb"])
        + 1e-3 * float(m["aux_z"]), rtol=1e-6)
    for a, b in zip(tckpt.tree_leaves(state), tckpt.tree_leaves(again)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_clis_run_the_tiny_preset(arch, tmp_path):
    """``python -m repro_torch.launch.train`` and ``.serve`` at the tiny
    preset on the CPU."""
    loop, metrics = tlaunch.main(["--arch", arch, "--preset", "tiny",
                                  "--steps", "2", "--batch", "2", "--seq",
                                  "32", "--device", "cpu", "--ckpt-dir",
                                  str(tmp_path)])
    assert loop.steps == 2
    _, reqs = tserve.main(["--arch", arch, "--preset", "tiny", "--requests",
                           "3", "--max-new", "4", "--device", "cpu"])
    assert all(r.done and len(r.generated) == 4 for r in reqs)
