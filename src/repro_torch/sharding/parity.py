"""Rank-side runners of sharded GAN programs and of the LLM's
sequence-sharded decode, for parity checks.

A parent process writes a list of cases with ``torch.save`` (parameters
and inputs included), starts the ranks with
:func:`repro_torch.launch.mesh.spawn` running :func:`run`, and holds
what each rank wrote against an unsharded reference it computed itself
(``tests/test_torch_mesh.py`` against the JAX package on the CPU,
``chip_smoke.py``'s mesh phase against the port's one-device path on
the card).  Each case is a dict with a ``name`` and a ``kind``:

* ``forward``: a sharded :class:`~repro_torch.program.Program`'s
  ``apply`` on the global batch;
* ``grad``: the gradients of ``sum(forward(params, x)**2)`` by
  parameter and by ``x``;
* ``train``: ``TrainLoop`` steps of a sharded
  ``make_gan_train_step`` (optionally from a checkpoint, with a
  checkpoint every step and an injected failure that makes every rank
  restore and replay);
* ``server``: a sharded ``GanServer``'s ``generate`` stream, and the
  error of a ``batch_size`` that does not divide over ``data``;
  ``server_submit``: its ``generate`` and ``submit`` calls mixed, on
  every rank in the same order, then ``close`` on every rank;
* ``engine``: a sharded ``GanEngine``'s answers on rank 0, and the
  error of buckets that do not divide; ``engine_fault``: a fault
  planted in rank 0's scheduler, after which every rank's engine
  stops;
* ``ring``: both ring matmuls on the rank's shards;
* ``forms``: :func:`~repro_torch.launch.mesh.make_local_mesh`'s forms
  and errors at this world size;
* ``cli``: ``python -m repro_torch.program --mesh``'s output;
* ``lm_cli``: ``python -m repro_torch.launch.train --mesh``'s, run by
  these ranks;
* ``decode``: an LLM's ``decode_step`` with the cache's sequence split
  over the mesh's ``data`` ranks (``RunFlags(mesh=...,
  seq_shard_decode=True)``): the rank's block of a global cache (given,
  or filled by one-device prefills of ``prompts``, :func:`decode_inputs`)
  decoded ``steps`` times, each step's logits and each attention layer's
  input and ``flash_decode`` output recorded (:func:`attention_oracle`
  runs the same inputs through the one-device attention), and the
  collectives counted; ``fault="no corr"`` plants a combine that sums the partials
  without rescaling them to the global max.  ``lm_decode`` is the same
  runner on any mesh: the parameters cut by the serving rules (the
  ``model`` axis splits heads, ``d_ff`` and vocab), and without
  ``seq_shard`` the batch-sharded decode (each ``data`` rank its slots);
* ``lm_prefill``: an LLM's prefill on the rank's blocks of the
  parameters and rows of the batch: its logits (the rank's vocab
  columns) and cache (its slots and heads);
* ``lm_train``: the LLM's ``make_train_step`` with the reference's
  ``build_cell`` shardings (:func:`~repro_torch.launch.train.
  train_shardings`) on a ``(data, model)`` mesh, or a ``(pod, data,
  model)`` one where ``mesh`` has three sizes, through ``TrainLoop`` (``ckpt_every`` and
  ``fail_at`` as ``train``'s) or step by step: each step's metrics,
  and the state gathered whole (``return_state``) or held against a
  checkpoint of the one-device state (``ref_dir``) by each updated
  leaf's update; ``fault`` plants one of :data:`FAULTS`: ``wo``'s
  partials not summed over ``model`` (``"wo not summed"``), the
  gradient norm of the rank's blocks only (``"local norm"``), the
  gradients summed, not averaged, over ``data`` (``"grads summed"``),
  each pod's gradients never averaged over the pods (``"pods not
  averaged"``), the MoE combine not summed over ``model``, MLA's ``q_norm`` RMS over
  each rank's half of ``q_lora``, the SSM gated norm over each rank's
  half of ``d_inner``, ``aux_lb`` as the mean of the data ranks'
  products, or a rank's last padded heads taken for its real ones ("pad
  head kept"); ``one_device`` in place of ``ref_dir`` (``{"steps": n,
  "key": k}`` and, for a bf16 case, ``"f32_steps": 1``) has the rank run
  the one-device steps itself first, once for the cases of one ``key``
  (:func:`_one_device`: no checkpoint written), and hold its updates
  against them;
* ``reshard``: a checkpoint restored onto this mesh through
  ``train_step.state_specs`` (the elastic reshard), gathered and held
  bit for bit against the saved arrays, then ``lm_train``'s steps from
  it.

Every case records the GANAX kernels' launches (on the card) by route,
dtype and Cout during the case, the flash kernels' by ``(dtype, dk,
dv)`` and the heads of each call of the model's ``flash_attention``,
its collectives, how many it staged through host memory and how many
went through the shared-card IPC buffers; the LLM cases each MoE
layer's routing of the rank's rows (:func:`routings`).  Rank ``r``
writes ``rank<r>.pt`` in the output directory: ``{name: result}``.
Importing this module touches no process group; everything runs inside
:func:`run`.
"""

from __future__ import annotations

import contextlib
import gc
import io
import math
import os
import time
import warnings

import torch
import torch.distributed as dist

__all__ = ["run", "condition", "decode_inputs", "fill_cache", "recording",
           "routings", "attention_oracle", "update_stats", "FAULTS"]


def _cfg(case: dict):
    from repro_torch.models.gan import GanConfig
    return GanConfig(case["model"], channel_scale=case.get("scale", 1.0),
                     dtype=case.get("dtype", "float32"),
                     backend=case.get("backend"))


def _on(tree, dev):
    """A copy of ``tree`` on ``dev``: cases that share a loaded tensor
    (``torch.save`` keeps the sharing) must not see each other's
    in-place updates."""
    if isinstance(tree, dict):
        return {k: _on(v, dev) for k, v in tree.items()}
    return tree.to(dev, copy=True) if isinstance(tree, torch.Tensor) \
        else tree


def _cpu(tree):
    """A host copy of ``tree`` that later in-place updates do not
    reach."""
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_cpu(v) for v in tree]
    return tree.detach().to("cpu", copy=True) \
        if isinstance(tree, torch.Tensor) else tree


def _kernels():
    from repro_torch.kernels.ganax_conv import (ganax_conv3d_cuda,
                                                ganax_conv_cuda)
    return {"ganax_conv": ganax_conv_cuda, "ganax_conv3d": ganax_conv3d_cuda}


def _flash_kernels():
    from repro_torch.kernels.flash_attention import (flash_attention_ffma,
                                                     flash_attention_wgmma)
    return {"flash_attention_wgmma": flash_attention_wgmma,
            "flash_attention_ffma": flash_attention_ffma}


def _staged() -> int:
    """Collectives staged through host memory so far in this process."""
    from repro_torch import obs
    return sum(v for k, v in obs.snapshot()["counters"].items()
               if k.startswith("mesh.staged"))


def _error(fn) -> str | None:
    """The message of the ``ValueError`` ``fn`` raises (None: none)."""
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


def _program(case, dev, differentiable):
    from repro_torch.program import Program
    return Program.build(_cfg(case), case.get("batch", 8),
                         case.get("role", "generator"), device=dev,
                         differentiable=differentiable, mesh=case["mesh"],
                         cout_shard_min_bytes=case.get("min_bytes"))


def _forward(case, dev):
    prog = _program(case, dev, differentiable=False)
    params, x = _on(case["params"], dev), _on(case["x"], dev)
    out = prog.apply(params, x)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(case.get("timed", 0)):
        prog.apply(params, x)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / max(1, case.get("timed", 0))
    return {"out": out, "ms": ms, "mesh": prog.mesh_str,
            "devices": prog.device_count,
            "shardings": [le.sharding for le in prog.spec.layers],
            "batch_error": _error(lambda: prog.apply(params, x[:1]))
            if prog.spec.mesh[0] > 1 else None}


def _grad(case, dev):
    prog = _program(case, dev, differentiable=True)
    params = {k: v.to(dev).requires_grad_(True)
              for k, v in case["params"].items()}
    net = prog.network(params)
    x = case["x"].to(dev).requires_grad_(True)
    out = prog.forward(params, x)
    names = list(net.params)
    grads = torch.autograd.grad((out.float() ** 2).sum(),
                                [net.params[k] for k in names] + [x])
    return {"out": out, "grads": dict(zip(names, grads[:-1])),
            "dx": grads[-1]}


def _fail_once(case):
    """The failure injector of a train case: step ``fail_at`` fails
    once."""
    failed = []

    def inject(i: int) -> bool:
        if case.get("fail_at") == i and not failed:
            failed.append(i)
            return True
        return False
    return inject


def _train(case, dev, out_dir):
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.loop import (LoopConfig, TrainLoop,
                                        make_gan_train_step)
    cfg = _cfg(case)
    batch = case["z"].shape[0]
    state = (_on(case["g_params"], dev), _on(case["d_params"], dev))
    if case.get("init_from"):
        state = ckpt.restore(state, case["init_from"])
        state = (_on(state[0], dev), _on(state[1], dev))
    step, (gen, disc) = make_gan_train_step(
        cfg, batch, *state, g_lr=case.get("lr", 2e-4), device=dev,
        mesh=case["mesh"])
    data = {"z": case["z"].to(dev), "real": case["real"].to(dev)}
    steps = case.get("steps", 1)
    ckpt_dir = os.path.join(out_dir, case["name"] + "_ckpt")
    loop = TrainLoop(
        LoopConfig(total_steps=steps, ckpt_dir=ckpt_dir, ckpt_every=1,
                   log_every=1),
        step, lambda i: data, (gen.params, disc.params),
        failure_injector=_fail_once(case), log_fn=lambda s: None)
    t0 = time.perf_counter()
    loop.run()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return {"g": dict(gen.params), "d": dict(disc.params),
            "metrics": loop.metrics_history,
            "restarts": loop.restarts, "ckpt_dir": ckpt_dir,
            "mesh": None if step.mesh is None
            else tuple(int(v) for v in step.mesh.shape),
            "replicated": step.state_shardings is not None,
            "s": time.perf_counter() - t0}


def _server(case, dev):
    from repro_torch.serve.gan import GanServer
    cfg = _cfg(case)
    srv = GanServer(cfg, _on(case["params"], dev),
                    batch_size=case["batch_size"], seed=case["seed"],
                    device=dev, mesh=case["mesh"])
    images = [srv.generate(n) for n in case["requests"]]
    return {"images": images, "mesh": srv.program.mesh_str,
            "batch_error": _error(lambda: GanServer(
                cfg, _on(case["params"], dev), batch_size=1,
                device=dev, mesh=case["mesh"]))}


def _server_submit(case, dev):
    """``case["calls"]``, ``("generate", n)`` or ``("submit", n)``, on a
    sharded ``GanServer``: a submit's future is read only after the
    later calls are made (requests queue behind each other).  The answers
    in call order (a follower's are ``None`` once the engine took over),
    then every rank closes its server."""
    from repro_torch.serve.gan import GanServer
    srv = GanServer(_cfg(case), _on(case["params"], dev),
                    batch_size=case["batch_size"], seed=case["seed"],
                    device=dev, mesh=case["mesh"])
    answers = [srv.generate(n) if how == "generate" else srv.submit(n)
               for how, n in case["calls"]]
    images = [a if a is None or isinstance(a, torch.Tensor)
              else a.result(120) for a in answers]
    srv.close(timeout=120)
    return {"images": images, "mesh": srv.program.mesh_str,
            "leader": srv._engine.leader,
            "stopped": not srv._engine._thread.is_alive()}


def _engine(case, dev):
    from repro_torch.serve.gan_engine import GanEngine
    cfg = _cfg(case)
    params = _on(case["params"], dev)
    t0 = time.perf_counter()
    with GanEngine(cfg, params, buckets=case["buckets"], seed=case["seed"],
                   device=dev, mesh=case["mesh"]) as eng:
        images = None
        if eng.leader:
            # one request at a time: the buckets drawn, and so the
            # stream, do not depend on how a burst coalesces
            images = [eng.submit(n).result(120) for n in case["requests"]]
    s = time.perf_counter() - t0
    return {"images": images, "s": s,
            "bucket_error": _error(lambda: GanEngine(
                cfg, params, buckets=(1,) + tuple(case["buckets"]),
                warmup=False, device=dev, mesh=case["mesh"]))}


def _engine_fault(case, dev):
    """A fault planted in rank 0's scheduler (its first batch's answer
    raises): rank 0's request fails with it, and every rank's engine
    stops and closes."""
    from repro_torch.serve.gan_engine import GanEngine
    eng = GanEngine(_cfg(case), _on(case["params"], dev),
                    buckets=case["buckets"], seed=case["seed"], device=dev,
                    mesh=case["mesh"], warmup=False)
    error = None
    if eng.leader:
        def planted(batch):
            raise RuntimeError("planted fault in rank 0's scheduler")
        eng._resolve = planted
        try:
            eng.submit(case["requests"][0]).result(120)
        except RuntimeError as e:
            error = str(e)
    eng.close(timeout=120)
    return {"error": error, "stopped": not eng._thread.is_alive()}


def _ring(case, dev):
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.sharding.collective_matmul import (
        ring_allgather_matmul, ring_matmul_reducescatter)
    from repro_torch.sharding.collectives import rows
    mesh = make_local_mesh(*case["mesh"], device_type=dev.type)
    g = mesh.get_group("model")
    p, i = dist.get_world_size(g), dist.get_rank(g)
    x, w, x2, w2 = (case[k].to(dev) for k in ("x", "w", "x2", "w2"))
    lo, hi = rows(x.shape[0], p, i)
    nlo, nhi = rows(w.shape[1], p, i)
    y = ring_allgather_matmul(x[lo:hi], w[:, nlo:nhi], mesh, "model")
    klo, khi = rows(x2.shape[1], p, i)
    y2 = ring_matmul_reducescatter(x2[:, klo:khi], w2[klo:khi], mesh,
                                   "model")
    return {"y": y, "y_cols": (nlo, nhi), "y2": y2,
            "y2_rows": rows(x2.shape[0], p, i)}


def _forms(case, dev):
    from repro_torch.launch.mesh import make_local_mesh
    got = {}
    for key, kw in case["forms"].items():
        try:
            got[key] = tuple(int(v) for v in
                             make_local_mesh(**kw, device_type=dev.type)
                             .shape)
        except ValueError as e:
            got[key] = str(e)
    return got


def _cli(case, dev):
    from repro_torch.program.__main__ import main
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(case["argv"])
    return {"stdout": buf.getvalue()}


def _lm_cli(case, dev):
    """``repro_torch.launch.train``'s main on ``case["argv"]`` as one of
    the ``--mesh`` ranks it spawns (this process group's), each call of
    the model's ``flash_attention`` recorded as ``lm_train``'s are."""
    from repro_torch.launch.train import main
    buf = io.StringIO()
    calls: list = []
    with contextlib.redirect_stdout(buf), _flash_heads(calls):
        main(case["argv"], _rank_device=dev.type)
    return {"stdout": buf.getvalue(), "flash": calls}


def fill_cache(cfg, params, prompts, max_len: int, kv_dtype: str, dev
               ) -> dict:
    """A ``len(prompts)``-slot cache of ``max_len`` rows, each slot filled
    by a one-device prefill of its prompt (the attention and MLA rows,
    the SSM state after the prompt); an int8 cache gets each prefill's
    k/v rows quantized by ``quantize_kv``, a layer at a time.  Each
    prefill's cache is freed before the next."""
    from repro_torch.models import transformer as tr
    from repro_torch.models.attention import quantize_kv
    from repro_torch.serve.engine import _merge_slot_cache
    cache = tr.init_cache(cfg, len(prompts), max_len, kv_dtype=kv_dtype,
                          device=dev)
    with torch.no_grad():
        for slot, prompt in enumerate(prompts):
            toks = torch.as_tensor(prompt, device=dev).long()[None]
            _, pcache = tr.forward(params, {"tokens": toks}, cfg,
                                   mode="prefill", last_logit_only=True)
            s = toks.shape[1]
            for si, seg in pcache.items():
                for pos, blk in seg.items():
                    if kv_dtype != "int8" or "k" not in blk.get("attn", {}):
                        _merge_slot_cache(cache[si][pos], blk, slot, s)
                        continue
                    if "ssm" in blk:
                        _merge_slot_cache(cache[si][pos]["ssm"], blk["ssm"],
                                          slot, s, state=True)
                    c, p = cache[si][pos]["attn"], blk["attn"]
                    for name in ("k", "v"):
                        for li in range(p[name].shape[0]):
                            codes, scales = quantize_kv(p[name][li, 0])
                            c[name][li, slot, :s] = codes
                            c[f"{name}_s"][li, slot, :s] = scales
            del pcache
    return cache


def condition(params: dict, d_model: int) -> None:
    """In place: each stacked matrix scaled from the reference's fan-in
    (the layer count) to its input width (a MoE block's stacked experts,
    ``(L, E, in, out)``, too; its router keeps its own scale, 0.02, not a
    fan-in), the embedding from 1 to ``d_model**-0.5``: weights whose
    activations and attention scores stay of order 1 through the depth,
    where the reference's init saturates the softmax."""
    import math

    from repro_torch.train.checkpoint import tree_items
    with torch.no_grad():
        for path, t in tree_items(params).items():
            if path.endswith("router"):
                continue
            if t.ndim in (3, 4):
                t.mul_(math.sqrt(t.shape[0] / t.shape[-2]))
            elif path == "embed":
                t.mul_(d_model ** -0.5)


# a rank's drawn model, kept from one decode case to the next
_MODEL: dict = {}


def decode_inputs(case: dict, dev, memo: dict | None = None):
    """``(cfg, params, global cache, tokens (steps, B, 1), lengths (B,))``
    of a ``decode`` case on ``dev``: the config from ``case["cfg"]`` (an
    ``ArchConfig``'s fields); the parameters given (``params``) or drawn
    on ``dev`` from ``seed``, with ``condition`` set then conditioned
    (:func:`condition`; kept in ``memo`` for the next case of the same
    config, seed and conditioning); the cache given (``cache``) or filled
    from ``prompts`` (:func:`fill_cache`, ``max_len`` rows,
    ``kv_dtype``)."""
    from repro_torch.configs.base import ArchConfig
    from repro_torch.models import transformer as tr
    cfg = ArchConfig(**case["cfg"])
    memo = {} if memo is None else memo
    if "params" in case:
        params = _on(case["params"], dev)
    else:
        key = (repr(cfg), case["seed"], case.get("condition", False))
        if key not in memo:
            memo.clear()
            memo[key] = tr.init(cfg, torch.Generator(dev).manual_seed(
                case["seed"]))
            if key[2]:
                condition(memo[key], cfg.d_model)
        params = memo[key]
    cache = _on(case["cache"], dev) if "cache" in case else fill_cache(
        cfg, params, case["prompts"], case["max_len"], case["kv_dtype"], dev)
    return (cfg, params, cache, case["tokens"].to(dev),
            case["lengths"].to(dev))


def _combine_without_corr(m, den, num, group=None):
    """The planted fault of ``decode`` cases: the partials summed as
    they are, each still relative to its own shard's max."""
    from repro_torch.models.attention import _shard_reduce
    den_g = _shard_reduce(den, "sum", group)
    num_g = _shard_reduce(num, "sum", group)
    return (num_g / den_g.clamp_min(1e-30)[..., None])[0]


def recording(module, name: str, calls: list, arg: int | None = None):
    """Inside: ``module.name`` appends a host copy of each call's first
    output to ``calls``, or with ``arg`` of its positional argument
    ``arg`` (an attention block's input: ``attention_apply``'s ``x`` is
    argument 1)."""
    fn = getattr(module, name)

    def recorded(*args, **kwargs):
        out = fn(*args, **kwargs)
        t = args[arg] if arg is not None else \
            out[0] if isinstance(out, tuple) else out
        calls.append(t.detach().to("cpu", copy=True))
        return out
    return _swapped(module, name, recorded)


def attention_oracle(case: dict, dev, layer_inputs: list,
                     memo: dict | None = None) -> list:
    """The one-device attention of a ``decode`` case, layer by layer on
    the inputs a rank recorded (``layer_inputs``: each attention layer's
    normed input, step by step in the forward's order): each layer's
    ``attention_apply`` over the case's global cache, which the calls
    write as the rank's did, so every call sees the rank's call's
    inputs.  Returns each call's ``decode_attention`` output (host
    copies, before ``wo``), the counterpart of the rank's
    ``flash_decode`` outputs, in the same order.  ``memo`` as
    :func:`decode_inputs`'s."""
    from repro_torch.models import attention
    from repro_torch.models import transformer as tr
    cfg, params, cache, _, lengths = decode_inputs(case, dev, memo)
    params = tr._cast_params(params, cfg.activation_dtype)
    layers = []
    for si, (descs, rep) in enumerate(cfg.layer_segments()):
        seg = zip(tr._unstack(params["segments"][f"seg{si}"], rep),
                  tr._unstack(cache[f"seg{si}"], rep))
        layers += [(lp[f"pos{di}"]["attn"], lc[f"pos{di}"]["attn"], desc)
                   for lp, lc in seg for di, desc in enumerate(descs)]
    outs: list = []
    with recording(attention, "decode_attention", outs), torch.no_grad():
        for i, h in enumerate(layer_inputs):
            lp, lc, desc = layers[i % len(layers)]
            ln = lengths + i // len(layers)
            attention.attention_apply(lp, h.to(dev), cfg, desc,
                                      positions=ln[:, None], mode="decode",
                                      cache=lc, lengths=ln)
    return outs


@contextlib.contextmanager
def _swapped(module, name: str, fn):
    saved = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, saved)


def _collectives(name: str = "mesh.collectives") -> int:
    """The process's count of ``name`` (every ``op`` label) so far."""
    from repro_torch import obs
    return sum(v for k, v in obs.snapshot()["counters"].items()
               if k.startswith(name))


def _serving(cfg, params, mesh):
    """The rank's blocks of serving weights (the reference's serving
    rules: tensor-parallel over ``model``, replicated over ``data``)."""
    from repro_torch.models import transformer as tr
    from repro_torch.models.common import spec_shapes
    from repro_torch.sharding import rules
    specs = rules.param_shardings(mesh, tr.model_axes(cfg),
                                  spec_shapes(tr.model_specs(cfg)))
    return rules.shard_tree(params, specs, mesh)


def _rows(t, mesh, dim: int):
    """The rank's rows of a batch tensor on ``dim`` (``batch_sharding``)."""
    from repro_torch.sharding import rules
    spec = rules.batch_sharding(mesh, t.ndim, batch_dim=dim,
                                batch_size=t.shape[dim])
    return rules.local_block(t, spec, mesh, rules.mesh_coords(mesh))


def _decode(case, dev):
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import attention
    from repro_torch.models import transformer as tr
    from repro_torch.sharding import rules
    cfg, params, cache, tokens, lengths = decode_inputs(case, dev, _MODEL)
    mesh = make_local_mesh(*case["mesh"], device_type=dev.type)
    coords = rules.mesh_coords(mesh)
    seq = case.get("seq_shard", True)
    local = rules.shard_tree(cache, rules.cache_shardings(
        mesh, cache, seq_shard=seq), mesh)
    del cache
    if case["mesh"][1] > 1:
        params = _serving(cfg, params, mesh)
    if not seq:
        tokens = _rows(tokens, mesh, 1)
        # the planted fault: every rank takes the first slots' lengths
        lengths = lengths[:tokens.shape[1]] \
            if case.get("fault") == "lengths not cut" \
            else _rows(lengths, mesh, 0)
    flags = tr.RunFlags(mesh=mesh, seq_shard_decode=seq)
    inputs, attn, logits, routes = [], [], [], []
    fault = _swapped(attention, "flash_decode_combine",
                     _combine_without_corr) \
        if case.get("fault") == "no corr" else _fault(case) \
        if case.get("fault") in FAULTS else contextlib.nullcontext()
    before = _collectives()
    with recording(attention, "attention_apply", inputs, arg=1), \
            recording(attention, "flash_decode", attn), fault, \
            routings(routes), torch.no_grad():
        for i in range(tokens.shape[0]):
            lg, local = tr.decode_step(params, local, tokens[i],
                                       lengths + i, cfg, flags)
            logits.append(lg)
    return {"logits": torch.stack(logits), "inputs": inputs, "attn": attn,
            "routing": routes,
            "cache": None if case.get("drop_cache") else local,
            "coords": coords,
            "collectives": _collectives() - before}


def _lm_params(case: dict, cfg, dev, dtype: torch.dtype | None = None
              ) -> dict:
    """A case's whole parameters on ``dev``: given (``params``), or drawn
    from ``seed`` as ``init_train_state`` draws them (f32 masters; in
    ``dtype`` when given), conditioned where ``condition`` is set."""
    from repro_torch.models import transformer as tr
    from repro_torch.models.common import init_tree
    if "params" in case:
        return _on(case["params"], dev)
    params = init_tree(torch.Generator(dev).manual_seed(case["seed"]),
                       tr.model_specs(cfg), dtype or torch.float32)
    if case.get("condition"):
        condition(params, cfg.d_model)
    return params


def _lm_batch(batch: dict, mesh, dev, accum: int) -> dict:
    return {k: _rows(v, mesh, 1 if accum > 1 else 0).to(dev, copy=True)
            for k, v in batch.items()}


def _flash_heads(calls: list):
    """Inside: ``models.attention.flash_attention`` records each call's
    ``(dtype, dk, dv, heads)``."""
    from repro_torch.models import attention
    fn = attention.flash_attention

    def recorded(q, k, v, **kw):
        calls.append((str(q.dtype).removeprefix("torch."), q.shape[-1],
                      v.shape[-1], q.shape[2]))
        return fn(q, k, v, **kw)
    return _swapped(attention, "flash_attention", recorded)


def routings(calls: list):
    """Inside: each call of ``models.moe.route_rows`` appends host copies
    of its tokens' ``(idx, pos, keep)`` (T, k) to ``calls``: a rank's
    rows' routing, layer by layer in the forward's order."""
    from repro_torch.models import moe
    fn = moe.route_rows

    def recorded(*args, **kwargs):
        out = fn(*args, **kwargs)
        calls.append(tuple(t.detach().to("cpu", copy=True)
                           for t in (out[0].idx, out[0].pos, out[0].keep)))
        return out
    return _swapped(moe, "route_rows", recorded)


def _lm_prefill(case, dev):
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import transformer as tr
    from repro_torch.configs.base import ArchConfig
    cfg = ArchConfig(**case["cfg"])
    mesh = make_local_mesh(*case["mesh"], device_type=dev.type)
    params = _serving(cfg, _lm_params(case, cfg, dev, cfg.activation_dtype),
                      mesh)
    calls: list = []
    flags = tr.RunFlags(mesh=mesh)
    routes: list = []
    with _flash_heads(calls), _fault(case), routings(routes), \
            torch.no_grad():
        if "prompts" in case:
            # one prefill a prompt: each prompt's last logits (the rank's
            # vocab columns), no cache kept
            logits = [tr.forward(params, {"tokens": torch.as_tensor(
                p, device=dev).long()[None]}, cfg, mode="prefill",
                flags=flags, last_logit_only=True)[0][0, -1]
                for p in case["prompts"]]
            cache = None
        else:
            # the batch's other arrays (a VLM's img_embeds) cut as tokens
            batch = {k: _rows(v, mesh, 0).to(dev) for k, v in
                     dict(case.get("extra", {}), tokens=case["tokens"])
                     .items()}
            logits, cache = tr.forward(params, batch, cfg, mode="prefill",
                                       flags=flags)
    return {"logits": logits, "cache": cache, "flash": calls,
            "routing": routes,
            "coords": {a: mesh.get_local_rank(a) for a in ("data", "model")}}


def _halves_norm(q, scale, eps, parts):
    """``q_norm``'s RMS of each rank's block of ``q_lora`` alone."""
    from repro_torch.models.common import rms_norm
    return torch.cat([rms_norm(a, b, eps) for a, b in zip(
        q.chunk(parts, dim=-1), scale.chunk(parts))], dim=-1)


def _mean_of_products(me, ce, e, data):
    """``aux_lb`` as the data ranks' mean of their own ``E·Σ me·ce``."""
    from repro_torch.sharding.collectives import all_reduce
    own = e * (me * ce).sum()
    if data is None:
        return own
    return all_reduce(own.detach(), data.group, "data") / data.size \
        + (own - own.detach())


# the planted faults of lm_train cases: fault -> (module, name, a
# function of the original giving its replacement)
FAULTS = {
    # wo's partials left on each rank, never summed over model
    "wo not summed": ("repro_torch.models.attention", "reduce_from_model",
                      lambda orig: lambda x, group, axis="model": x),
    # the clip's norm of the rank's own blocks only
    "local norm": ("repro_torch.train.optimizer", "global_norm",
                   lambda orig: lambda tree, specs=None, mesh=None:
                   orig(tree)),
    # the data ranks' gradients summed, not averaged
    "grads summed": ("repro_torch.train.train_state", "average_over_data",
                     lambda orig: lambda g, c, m, group, n:
                     orig(g, c, m, group, 1)),
    # each pod's gradients kept, never averaged over the pods
    "pods not averaged": ("repro_torch.train.train_state",
                          "average_over_pods",
                          lambda orig: lambda g, group, n: g),
    # the MoE combine left on each rank: only its own experts' outputs
    "moe combine not summed": (
        "repro_torch.models.moe", "reduce_from_model",
        lambda orig: lambda x, group, axis="model": x),
    # MLA's q_norm RMS over each rank's half of q_lora
    "q_norm over a half": ("repro_torch.models.attention", "_lora_norm",
                           lambda orig: _halves_norm),
    # the SSM gated norm's mean of squares over the rank's d_inner only
    "ssm norm over a half": (
        "repro_torch.models.ssm", "_norm_over_model",
        lambda orig: lambda y, scale, eps, width, tp: orig(
            y, scale, eps, y.shape[-1], None)),
    # aux_lb as the mean of the data ranks' products
    "aux_lb mean of products": ("repro_torch.models.moe", "_load_balance",
                                lambda orig: _mean_of_products),
    # the pad head kept: a rank's last n heads of its padded block taken
    # for its n real ones (the pad among them, a real head dropped)
    "pad head kept": ("repro_torch.models.attention", "_real_heads",
                      lambda orig: lambda out, n: out[:, :,
                                                      out.shape[2] - n:])}


def _fault(case):
    import importlib
    if not case.get("fault"):
        return contextlib.nullcontext()
    module, name, make = FAULTS[case["fault"]]
    module = importlib.import_module(module)
    return _swapped(module, name, make(getattr(module, name)))


def update_stats(state: dict, init: dict, ref: dict) -> dict:
    """Per leaf of ``params``, ``(Σ (Δ - Δ_ref)², Σ Δ_ref²)`` over this
    rank's blocks, ``Δ`` the update ``state - init`` and ``Δ_ref`` the
    reference's ``ref - init`` (all blocks of one layout): summed over
    the ranks they give each leaf's ``||Δ - Δ_ref|| / ||Δ_ref||`` (every
    distinct block is held by equally many ranks)."""
    from repro_torch.train.checkpoint import tree_items
    refs, inits = tree_items(ref), tree_items(init)
    out = {}
    for path, p in tree_items(state).items():
        sums = torch.zeros(2, dtype=torch.float64, device=p.device)
        # in pieces of 2^24 elements, on the rank's device, f32 (the
        # differences of near values are exact), summed in float64
        for a, i, w in zip(*(t.reshape(-1).split(1 << 24) for t in (
                p, inits[path], refs[path]))):
            i = i.to(p.device)
            d, r = a.float() - i.float(), w.to(p.device).float() - i.float()
            sums += torch.stack([((d - r) ** 2).sum(dtype=torch.float64),
                                 (r ** 2).sum(dtype=torch.float64)])
        out[path] = tuple(float(v) for v in sums)
    return out


def _lm_step(case, cfg, mesh):
    from repro_torch.launch.train import train_shardings
    from repro_torch.models import transformer as tr
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_state import make_train_step
    compute, master = train_shardings(cfg, mesh)
    return make_train_step(
        cfg, AdamWConfig(**case["opt"]),
        tr.RunFlags(mesh=mesh, **case.get("flags", {})),
        grad_accum=case.get("grad_accum", 1), compute_shardings=compute,
        master_shardings=master)


def _lm_run(case, mesh, step, state, dev, first: int = 0,
            init: dict | None = None, one: dict | None = None):
    """``case["batches"][first:]`` through ``TrainLoop`` (``ckpt_every``
    set) or step by step; then the results: metrics, the state whole or
    its updates against ``ref_dir`` or ``one`` (:func:`_one_device`'s:
    ``ref`` and ``ref2``, the rank's blocks of the one-device
    parameters), flash calls.  The updates are from ``init`` (the rank's
    blocks of the parameters; default: the state's as the run
    starts)."""
    from repro_torch.sharding import rules
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.loop import LoopConfig, TrainLoop
    accum = case.get("grad_accum", 1)
    batches = [_lm_batch(b, mesh, dev, accum) for b in case["batches"]]
    against = case.get("ref_dir") or one
    if against:                 # on the host: the rank's device is shared
        init = {k: v.to("cpu", copy=True) for k, v in
                ckpt.tree_items(init or state["params"]).items()}
    calls: list = []
    routes: list = []
    metrics = []
    laps = _laps(dev)
    with _flash_heads(calls), _fault(case), routings(routes):
        if case.get("ckpt_every"):
            loop = TrainLoop(
                LoopConfig(total_steps=len(batches),
                           ckpt_dir=case["ckpt_dir"],
                           ckpt_every=case["ckpt_every"], async_ckpt=False,
                           log_every=1),
                step, lambda i: batches[i], state,
                failure_injector=_fail_once(case), log_fn=lambda s: None)
            loop.run(first)
            metrics = [{k: v for k, v in m.items() if k != "step"}
                       for m in loop.metrics_history]
            restarts = loop.restarts
        else:
            restarts = 0
            for i, b in enumerate(batches[first:], first):
                _, m = step(state, b)
                metrics.append({k: float(v) for k, v in m.items()})
                laps(f"step {i}")
                if case.get("save_at") == i:
                    ckpt.save(state, case["save_dir"], i + 1, mesh=mesh,
                              shardings=step.state_specs)
                    laps("save")
    res = {"metrics": metrics, "flash": calls, "restarts": restarts,
           "routing": routes,
           "coords": rules.mesh_coords(mesh), "laps": laps.seconds}
    if case.get("return_state"):
        res["state"] = rules.gather_tree(state, step.state_specs, mesh)
    if against:
        ref = one.pop("ref") if one else ckpt.restore(
            state["params"], case["ref_dir"],
            shardings=step.state_specs["params"], mesh=mesh)
        flat = ckpt.tree_unflatten(state["params"], list(init.values()))
        res["updates"] = update_stats(state["params"], flat, ref)
        if one and "ref2" in one:
            # the bf16 step's f32 counterpart
            res["updates2"] = update_stats(state["params"], flat,
                                           one.pop("ref2"))
        if one:
            res["one_device"] = one
        del ref, flat, init
        laps("against the reference")
    if case.get("save_dir") and case.get("save_at") is None:
        # the whole state, or (``save_params``) the parameters alone
        part = case.get("save_params", False)
        ckpt.save(state["params"] if part else state, case["save_dir"],
                  len(case["batches"]), mesh=mesh,
                  shardings=step.state_specs["params"] if part
                  else step.state_specs)
        laps("save")
    return res


def _laps(dev):
    """``laps(name)`` records the seconds since the last call (the device
    synchronised) in ``laps.seconds``."""
    last = [time.perf_counter()]
    seconds: dict = {}

    def laps(name: str) -> None:
        if dev.type == "cuda":
            torch.cuda.synchronize()
        now = time.perf_counter()
        seconds[name] = seconds.get(name, 0.0) + now - last[0]
        last[0] = now
    laps.seconds = seconds
    return laps


def _zero_blocks(tree: dict, specs: dict, mesh, device) -> dict:
    """Zero blocks on ``device`` of ``tree``'s whole leaves (tensors of
    any device, ``meta`` included) as ``specs`` cut them on ``mesh``."""
    from repro_torch.sharding import rules
    coords = rules.mesh_coords(mesh)
    return {k: (_zero_blocks(v, specs[k], mesh, device)
                if isinstance(v, dict) else torch.zeros(
                    rules.local_block(v, specs[k], mesh, coords).shape,
                    dtype=v.dtype, device=device))
            for k, v in tree.items()}


def _state_blocks(params: dict, step, mesh, device) -> dict:
    """A train state of ``step``'s layout: the rank's blocks of the whole
    ``params`` (on ``meta``: zeros of their shapes), zero moments, step
    0."""
    from repro_torch.sharding import rules
    specs = step.state_specs
    blocks = _zero_blocks(params, specs["params"], mesh, device) \
        if next(iter(_leaves(params))).is_meta \
        else rules.shard_tree(params, specs["params"], mesh)

    def zero():
        return torch.zeros((), dtype=torch.int32, device=device)
    return {"params": blocks,
            "opt": {name: _zero_blocks(params, specs["opt"][name], mesh,
                                       device) for name in ("mu", "nu")}
            | {"count": zero()}, "step": zero()}


def _leaves(tree: dict):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


# a rank's one-device runs, kept on the host from one ``one_device``
# case to the next of the same ``key``
_ONE_DEVICE: dict = {}


def _one_device_run(case, cfg, dev, steps: int) -> dict:
    """``steps`` one-device steps of ``cfg`` from the case's drawn
    parameters on its batches, without a mesh, or the longest such run
    of the case's ``one_device["key"]`` kept from an earlier case (the
    cases of one config share their weights, batches and optimizer):
    host copies of the parameters after each step (``params``), each
    step's metrics, each MoE layer's routing (:func:`routings`) in the
    first step."""
    from repro_torch.models import transformer as tr
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.train.train_state import make_train_step
    key = (case["one_device"].get("key"), str(cfg.dtype))
    if key not in _ONE_DEVICE or len(_ONE_DEVICE[key]["params"]) < steps:
        if key[0] not in {k[0] for k in _ONE_DEVICE}:
            _ONE_DEVICE.clear()
        params = _lm_params(case, cfg, dev)
        state = {"params": params, "opt": adamw_init(params),
                 "step": torch.zeros((), dtype=torch.int32, device=dev)}
        step = make_train_step(cfg, AdamWConfig(**case["opt"]),
                               tr.RunFlags(**case.get("flags", {})))
        run = {"params": [], "metrics": [], "routing": []}
        for i, b in enumerate(case["batches"][:steps]):
            with routings(run["routing"] if i == 0 else []):
                _, m = step(state, {k: v.to(dev) for k, v in b.items()})
            run["metrics"].append({k: float(v) for k, v in m.items()})
            run["params"].append(ckpt.tree_map(
                lambda t: t.to("cpu", copy=True), state["params"]))
        del state, step, params
        _ONE_DEVICE[key] = run
    return _ONE_DEVICE[key]


def _one_device(case, cfg, dev, specs: dict, mesh) -> dict | None:
    """The one-device steps a ``one_device`` case is held against, run on
    this rank before its mesh steps (:func:`_one_device_run`: the card's
    machine meters the checkpoints a parent would write for the ranks):
    the rank's blocks of the parameters after ``steps`` steps (``ref``),
    the steps' metrics, the routing; with ``f32_steps`` (a bf16 case)
    also the f32 steps' blocks (``ref2``) and, a leaf, ``||Δ - Δ_f32|| /
    ||Δ_f32||`` of the one-device update (``exact``).  None without
    ``one_device``."""
    import dataclasses

    from repro_torch.sharding import rules
    from repro_torch.train import checkpoint as ckpt
    plan = case.get("one_device")
    if not plan:
        return None
    n = plan["steps"]
    run = _one_device_run(case, cfg, dev, n)

    def blocks(tree):
        return rules.shard_tree(ckpt.tree_map(lambda t: t.to(dev), tree),
                                specs, mesh)
    params = run["params"][n - 1]
    out = {"ref": blocks(params), "metrics": run["metrics"][:n],
           "routing": run["routing"]}
    if plan.get("f32_steps"):
        f32 = _one_device_run(case, dataclasses.replace(cfg, dtype="float32"),
                              dev, plan["f32_steps"])["params"][
            plan["f32_steps"] - 1]
        init = ckpt.tree_items(_lm_params(case, cfg, dev))
        wide = ckpt.tree_items(f32)

        def norm(t):
            return torch.linalg.vector_norm(t.float(), dtype=torch.float64)
        out["exact"] = {
            path: float(norm(a.to(dev) - wide[path].to(dev))
                        / norm(wide[path].to(dev) - init[path])
                        .clamp_min(1e-300))
            for path, a in ckpt.tree_items(params).items()}
        out["ref2"] = blocks(f32)
        del init, wide
    # the case's counts and peak are its mesh steps'
    for k in _flash_kernels().values():
        k.launches = 0
        k.launches_by_geometry.clear()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    return out


def _lm_mesh(case, dev):
    """The case's mesh: ``(data, model)`` (:func:`~repro_torch.launch.
    mesh.make_local_mesh`), or ``(pod, data, model)``, the multi-pod
    production mesh's axes, over the first ranks."""
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.launch.mesh import make_local_mesh
    shape = tuple(case["mesh"])
    if len(shape) == 2:
        return make_local_mesh(*shape, device_type=dev.type)
    return DeviceMesh(dev.type, torch.arange(math.prod(shape)).reshape(
        shape), mesh_dim_names=("pod", "data", "model"))


def _lm_train(case, dev):
    from repro_torch.configs.base import ArchConfig
    cfg = ArchConfig(**case["cfg"])
    mesh = _lm_mesh(case, dev)
    step = _lm_step(case, cfg, mesh)
    one = _one_device(case, cfg, dev, step.state_specs["params"], mesh)
    state = _state_blocks(_lm_params(case, cfg, dev), step, mesh, dev)
    return _lm_run(case, mesh, step, state, dev, one=one)


def _reshard(case, dev):
    """``case["from_dir"]`` (a checkpoint of the whole state, the latest
    step) restored onto this mesh (the elastic reshard), each block held
    bit for bit against its part of the saved arrays; then
    ``lm_train``'s steps from it."""
    from repro_torch.configs.base import ArchConfig
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import transformer as tr
    from repro_torch.sharding import rules
    from repro_torch.train import checkpoint as ckpt
    cfg = ArchConfig(**case["cfg"])
    mesh = make_local_mesh(*case["mesh"], device_type=dev.type)
    step = _lm_step(case, cfg, mesh)
    meta = ckpt.tree_map(lambda s_: torch.empty(s_.shape, device="meta"),
                         tr.model_specs(cfg))
    laps = _laps(dev)
    state = ckpt.restore(_state_blocks(meta, step, mesh, dev),
                         case["from_dir"], shardings=step.state_specs,
                         mesh=mesh)
    laps("restore")
    saved = ckpt.arrays(case["from_dir"])
    coords = rules.mesh_coords(mesh)
    specs = dict(zip(ckpt.tree_items(state),
                     rules.spec_leaves(step.state_specs)))
    with warnings.catch_warnings():         # read-only memory maps
        warnings.simplefilter("ignore", UserWarning)
        equal = [torch.equal(t.cpu(), rules.local_block(
            torch.from_numpy(saved[key]), specs[key], mesh, coords))
            for key, t in ckpt.tree_items(state).items()]
    laps("bits")
    one = _one_device(case, cfg, dev, step.state_specs["params"], mesh)
    init = rules.shard_tree(_lm_params(case, cfg, dev),
                            step.state_specs["params"], mesh) \
        if case.get("ref_dir") or one else None
    res = _lm_run(case, mesh, step, state, dev, first=int(state["step"]),
                  init=init, one=one)
    res["laps"] = dict(laps.seconds, **res["laps"])
    res.update(bits_equal=all(equal), leaves=len(equal),
               restored_step=ckpt.latest_step(case["from_dir"]))
    return res


_KINDS = {"forward": _forward, "grad": _grad, "server": _server,
          "server_submit": _server_submit, "engine": _engine,
          "engine_fault": _engine_fault, "ring": _ring, "forms": _forms,
          "cli": _cli, "decode": _decode, "lm_decode": _decode,
          "lm_prefill": _lm_prefill, "lm_train": _lm_train,
          "lm_cli": _lm_cli, "reshard": _reshard}


def run(case_file: str, out_dir: str, device: str = "cuda",
        threads: int | None = None) -> None:
    """Run every case of ``case_file`` on this rank (on ``device``:
    ``"cpu"``, or ``"cuda"`` for the rank's card) and write
    ``<out_dir>/rank<r>.pt``.  ``threads`` caps the rank's intra-op
    threads (ranks that share a host's cores)."""
    if threads is not None:
        torch.set_num_threads(int(threads))
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if device == "cuda" else torch.device("cpu")
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction \
            = False
        torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction \
            = False
    kernels = _kernels()
    flash = _flash_kernels()
    results = {}
    for case in torch.load(case_file, weights_only=True):
        # every count at 0 just before the case, read just after it
        for k in kernels.values():
            k.launches = 0
            for counts in (k.launches_by_route, k.launches_by_dtype,
                           k.launches_by_cout):
                counts.clear()
        for k in flash.values():
            k.launches = 0
            k.launches_by_geometry.clear()
        staged = _staged()
        counted = _collectives(), _collectives("mesh.ipc")
        kind = case["kind"]
        if kind not in ("decode", "lm_decode"):
            _MODEL.clear()      # the decode cases' model leaves the card
        if kind not in ("lm_train", "reshard"):
            _ONE_DEVICE.clear()     # as _MODEL: the train cases' runs
        if dev.type == "cuda":
            gc.collect()        # a cycle holding tensors must not stay
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            held = torch.cuda.memory_allocated(dev) / 1e9
        t0 = time.perf_counter()
        res = _train(case, dev, out_dir) if kind == "train" \
            else _KINDS[kind](case, dev)
        res["wall_s"] = time.perf_counter() - t0
        res["launches"] = {name: {"route": dict(k.launches_by_route),
                                  "dtype": dict(k.launches_by_dtype),
                                  "cout": dict(k.launches_by_cout)}
                           for name, k in kernels.items()}
        res["flash_launches"] = {
            name: {"/".join(str(v).removeprefix("torch.") for v in geo): n
                   for geo, n in k.launches_by_geometry.items()}
            for name, k in flash.items()}
        res["staged"] = _staged() - staged
        res.setdefault("collectives", _collectives() - counted[0])
        res["ipc"] = _collectives("mesh.ipc") - counted[1]
        if dev.type == "cuda":
            res["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
            res["held_gb"] = held
            print(f"[parity rank {dist.get_rank()}] {case['name']}: {held:.2f} "
                  f"GB held at the start, peak {res['peak_gb']:.2f} GB, "
                  f"{res['wall_s']:.1f} s", flush=True)
        results[case["name"]] = _cpu(res)
    torch.save(results, os.path.join(out_dir, f"rank{dist.get_rank()}.pt"))

