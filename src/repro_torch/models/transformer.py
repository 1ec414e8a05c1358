"""Model assembly for every family of the LLM stack (the port of
``repro.models.transformer``): the causal configs ``gemma-7b``,
``qwen1.5-32b``, ``gemma3-4b``, whose 5:1
local:global pattern runs sliding-window layers beside global ones at
their own ``rope_theta``, ``minicpm3-4b``, whose blocks mix by
multi-head latent attention (MLA), the mixture-of-experts configs
``olmoe-1b-7b`` and ``llama4-scout-17b-a16e``, whose blocks' MLP is
``models/moe.py``'s routed experts, the attention-free ``mamba2-2.7b``,
whose blocks mix by ``models/ssm.py``'s Mamba2 mixer alone, and the
hybrid ``hymba-1.5b``, whose blocks run attention (windowed, or global
at ``global_layers``) and the Mamba2 mixer side by side on the same
normed input and add ``0.5·(attention + SSM)``; the encoder
``hubert-xlarge``, whose frames (``batch["features"]``) enter through
``frontend_proj`` plus a learned ``pos_embed`` and attend non-causally,
trained by the masked-frame loss; and the VLM ``internvl2-26b``, whose
``batch["img_embeds"]`` enter through ``img_proj`` in place of the first
``img_tokens`` token embeddings when the sequence holds them; logit
soft-capping and positions given in the batch are ported too).

Parameters keep the reference's stacked layout — ``segments/seg<i>/
pos<j>/{ln_mix, attn/{wq,wk,wv,wo[,bq,bk,bv]}, ln_mlp, mlp/{...}}`` with
a leading layers axis (an MLA block's ``attn`` holds ``{wq_a, q_norm,
wq_b, wkv_a, kv_norm, wkv_b, wo}``; a MoE block's ``mlp`` holds
``{router, wi, wg, wo[, shared_wi, shared_wg, shared_wo]}``; an SSM
block holds ``ssm/{in_proj, conv_w, conv_b, A_log, D, dt_bias, norm,
out_proj}`` and no ``attn``, a hybrid block both, and a block of
``mlp_kind="none"`` no ``ln_mlp`` or ``mlp``), ``embed`` and
``final_norm`` (and the encoder's ``frontend_proj`` and ``pos_embed``,
the VLM's ``img_proj``) — as nested dicts of tensors, so converting the JAX
package's parameters is a check and a copy.  Where the reference scans
over the layers, :func:`forward` loops over the layer slices in Python.
The MoE layers' load-balance and router z-losses are summed over the
layers and reach ``loss_fn`` (``forward(..., return_aux=True)``).

Entry points:
  * ``model_specs(cfg)``  → nested dict of PSpecs
  * ``init(cfg, gen)``    → params on ``gen``'s device, in the activation
    dtype
  * ``forward(params, batch, cfg, mode=...)`` → logits (+ cache)
  * ``loss_fn`` → (total loss, metrics): next-token (or, for the
    encoder, masked-frame) cross-entropy plus the MoE aux losses
  * ``decode_step`` / ``init_cache`` / ``count_params`` /
    ``model_flops_per_token``

A config with a segment of zero layers raises ``ValueError`` when its
model is built; the encoder has no decode, as the reference's.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts,
                                    noop_context_fn)

from repro_torch.configs.base import ArchConfig, BlockDesc
from repro_torch.device import require_f32_accumulation, resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import (PSpec, init_tree, rms_norm,
                                       spec_axes, stack_specs)
from repro_torch.models.mlp import mlp_apply, mlp_specs
from repro_torch.sharding.collectives import (TensorGroup, all_reduce,
                                              sum_grad,
                                              vocab_embed, vocab_logsumexp,
                                              vocab_pick)
from repro_torch.sharding.rules import (axis_sizes, cache_shardings,
                                        check_whole_heads, local_block,
                                        mesh_coords)
from repro_torch.train.checkpoint import tree_leaves

__all__ = ["RunFlags", "check_supported", "check_mesh", "model_specs",
           "model_axes",
           "init", "forward", "loss_fn", "decode_step", "init_cache",
           "count_params", "model_flops_per_token"]

ATTN_IMPLS = ("flash", "naive", "chunked_q")
# the encoder's learned positions: the reference sizes them for its
# largest encode shape (prefill_32k)
POS_EMBED_ROWS = 32768


@dataclasses.dataclass(frozen=True)
class RunFlags:
    """Runtime knobs threaded through the forward pass.

    * ``attn_impl``: the train/prefill attention of the global layers
      (``"flash"``: the kernel, masked by index; ``"naive"``: the
      full-matrix reference; ``"chunked_q"``: the same one q block at a
      time; both mask by positions).  Windowed layers run
      ``swa_attention`` at every value, as the reference's.
    * ``remat`` (``mode="train"``): each layer's body, every position of
      its segment's pattern, runs under
      ``torch.utils.checkpoint.checkpoint`` and is recomputed in the
      backward.  ``remat_policy="dots"`` saves the outputs of the 2-D
      products (``aten.mm``, ``aten.addmm``) and recomputes the rest, as
      the reference's ``dots_with_no_batch_dims_saveable``;
      ``"nothing"`` saves only the layer's inputs.
    * ``scan_layers``: accepted at both values, with the same result;
      the reference scans over the stacked layers or unrolls them, and
      the port loops over them in Python either way.
    * ``mesh`` (a ``DeviceMesh`` of axes ``("data", "model")`` over the
      process group's ranks): every rank runs the forward on its blocks,
      as ``sharding/rules.py`` cuts them (:func:`check_mesh` first).
      The ``model`` axis splits the heads (heads that do not divide it
      zero-padded, as the reference's ``_pad_heads_even``), MLA's heads
      and ``q_lora``, the experts, the SSM heads, the MLP's ``d_ff`` and
      the vocab where the rules' specs split them, with the sums of
      ``sharding/collectives.py``; the ``data`` axis splits the batch
      (``loss_fn`` normalizes by the global weight sum; the MoE routing
      groups and aux losses are the global batch's) and the decode's
      slots.  With ``seq_shard_decode`` the decode instead holds the
      cache's rows split over ``data`` (``cache_shardings(
      seq_shard=True)``), tokens and lengths replicated, and every
      attention layer (a windowed one with its window) runs
      ``flash_decode`` over the ``data`` group, an MLA layer its absorbed
      softmax's partials combined the same way; the SSM state is
      replicated over ``data``, every rank advancing the same state.
      ``seq_shard_decode`` without a mesh is the one-device decode, as
      the reference's."""
    attn_impl: str = "flash"          # "flash" | "naive" | "chunked_q"
    remat: bool = True
    remat_policy: str = "nothing"     # "nothing" | "dots"
    seq_shard_decode: bool = False
    mesh: Any = None
    scan_layers: bool = True

    def __post_init__(self):
        if self.attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl {self.attn_impl!r}: one of "
                             f"{ATTN_IMPLS}")
        if self.remat_policy not in ("nothing", "dots"):
            raise ValueError(f"remat_policy {self.remat_policy!r}: "
                             f"'nothing' or 'dots'")


def check_mesh(cfg: ArchConfig, mesh) -> None:
    """Raise ``ValueError`` where the default rules would split the SSM
    heads' flattened ``d_inner`` over a model axis that does not divide
    the heads (the port splits whole SSM heads only; attention and MLA
    heads are padded): ``mesh`` a ``DeviceMesh`` or anything
    ``axis_sizes`` reads."""
    if cfg.ssm:
        check_whole_heads(cfg.name, {"ssm_heads": cfg.ssm_heads},
                          cfg.ssm_head_dim, mesh)


def check_supported(cfg: ArchConfig) -> None:
    """Raise ``ValueError`` for a config with a segment of zero
    layers."""
    for si, (descs, rep) in enumerate(cfg.layer_segments()):
        if rep < 1:
            raise ValueError(
                f"{cfg.name}: segment seg{si} (a pattern of {len(descs)} "
                f"blocks) has {rep} layers: {cfg.n_layers} layers do not "
                f"fill one group of its local_global_pattern "
                f"{cfg.local_global_pattern}; the reference cannot "
                f"initialise such a segment either (its stacked fan-in "
                f"is 0)")


# ---------------------------------------------------------------------------
# Specs.
# ---------------------------------------------------------------------------

def _block_specs(cfg: ArchConfig, desc: BlockDesc) -> dict[str, Any]:
    d = cfg.d_model
    specs: dict[str, Any] = {
        "ln_mix": PSpec((d,), (None,), init="zeros"),
    }
    if desc.mixer == "mla":
        specs["attn"] = attn_mod.mla_specs(cfg)
    elif desc.mixer in ("attn", "hybrid"):
        specs["attn"] = attn_mod.attention_specs(cfg, desc)
    elif desc.mixer != "ssm":
        raise ValueError(desc.mixer)
    if desc.mixer in ("ssm", "hybrid"):
        specs["ssm"] = ssm_mod.ssm_specs(cfg)
    if desc.mlp != "none":
        specs["ln_mlp"] = PSpec((d,), (None,), init="zeros")
        specs["mlp"] = (moe_mod.moe_specs(cfg) if desc.mlp == "moe"
                        else mlp_specs(cfg, desc.mlp))
    return specs


def model_specs(cfg: ArchConfig) -> dict[str, Any]:
    check_supported(cfg)
    d = cfg.d_model
    specs: dict[str, Any] = {
        "embed": PSpec((cfg.padded_vocab, d), ("vocab", "embed"),
                       init="embed", scale=1.0),
        "final_norm": PSpec((d,), (None,), init="zeros"),
    }
    if not cfg.tie_embeddings:
        specs["head"] = PSpec((d, cfg.padded_vocab), ("embed", "vocab"))
    if cfg.family == "vlm":
        specs["img_proj"] = PSpec((cfg.frontend_dim, d), (None, "embed"))
    if cfg.family == "encoder":
        specs["frontend_proj"] = PSpec((cfg.frontend_dim, d),
                                       (None, "embed"))
        specs["pos_embed"] = PSpec((POS_EMBED_ROWS, d), (None, "embed"),
                                   scale=0.02)
    specs["segments"] = {
        f"seg{si}": stack_specs({f"pos{di}": _block_specs(cfg, desc)
                                 for di, desc in enumerate(descs)}, rep)
        for si, (descs, rep) in enumerate(cfg.layer_segments())}
    return specs


def model_axes(cfg: ArchConfig) -> dict:
    """The logical axes of every parameter (``sharding/rules.py`` maps
    them onto a mesh)."""
    return spec_axes(model_specs(cfg))


def init(cfg: ArchConfig, gen: torch.Generator) -> dict[str, Any]:
    """Random parameters drawn on ``gen``'s device and stored in
    ``cfg.activation_dtype`` (the reference casts every leaf to it on
    every forward): a full-width model is drawn on the card, never in
    host memory."""
    return init_tree(gen, model_specs(cfg), cfg.activation_dtype)


def count_params(cfg: ArchConfig) -> int:
    total = 0
    for s in tree_leaves(model_specs(cfg)):
        n = 1
        for d in s.shape:
            n *= int(d)
        total += n
    return total


def _routed(tree: dict, routed: bool = False):
    """(spec, is a routed expert's weight) for every leaf: the
    ``wi``/``wg``/``wo`` of a MoE block's ``mlp`` (not its shared
    expert's)."""
    for key, v in tree.items():
        if isinstance(v, dict):
            yield from _routed(v, key == "mlp")
        else:
            yield v, routed and key in ("wi", "wg", "wo")


def model_flops_per_token(cfg: ArchConfig) -> float:
    """MODEL_FLOPS a token = 6·N (dense, MLA included) or 6·N_active
    (MoE): each routed expert leaf counts ``n·top_k // n_experts`` of its
    ``n`` parameters, as the reference's."""
    total = 0
    for s, routed in _routed(model_specs(cfg)):
        n = 1
        for d in s.shape:
            n *= int(d)
        total += n * cfg.top_k // cfg.n_experts if cfg.moe and routed \
            else n
    return 6.0 * total


# ---------------------------------------------------------------------------
# Forward.
# ---------------------------------------------------------------------------

def _block_apply(params, x, cfg, desc, *, positions, mode, cache, lengths,
                 flags: RunFlags, on_mesh=None):
    """One block: (x, its cache ``{"attn": ..., "ssm": ...}`` as the
    block has them (empty in train mode), its MoE aux
    ``[load_balance_loss, router_z_loss]`` f32, or None for a dense
    MLP).  A hybrid block's mixer output is ``0.5·(attention + SSM)`` in
    the activation dtype, as the reference's."""
    h = rms_norm(x, params["ln_mix"], cfg.norm_eps)
    new_cache, outs = {}, []
    tp = None if on_mesh is None else on_mesh.tp
    if desc.mixer != "ssm":
        fn = attn_mod.mla_apply if desc.mixer == "mla" else \
            attn_mod.attention_apply
        shard = {} if on_mesh is None else {"seq_shard": on_mesh.seq_shard,
                                            "tp": tp}
        out, c = fn(params["attn"], h, cfg, desc, positions=positions,
                    mode=mode,
                    cache=None if cache is None else cache.get("attn"),
                    lengths=lengths, attn_impl=flags.attn_impl, **shard)
        outs.append(out)
        if c is not None:
            new_cache["attn"] = c
    if desc.mixer in ("ssm", "hybrid"):
        if mode == "decode":
            out, c = ssm_mod.ssm_decode_step(params["ssm"], h, cfg,
                                             cache["ssm"], tp=tp)
        else:
            out, c = ssm_mod.ssm_apply(params["ssm"], h, cfg, mode=mode,
                                       tp=tp)
        outs.append(out)
        if c is not None:
            new_cache["ssm"] = c
    x = x + (0.5 * (outs[0] + outs[1]) if len(outs) == 2 else outs[0])
    aux = None
    if desc.mlp == "moe":
        h = rms_norm(x, params["ln_mlp"], cfg.norm_eps)
        # the batch's rows are split over data, but for the
        # sequence-sharded decode's, which every data rank holds
        rows = None if on_mesh is None or on_mesh.seq_shard else \
            on_mesh.data
        y, moe_aux = moe_mod.moe_apply(params["mlp"], h, cfg, tp=tp,
                                       data=rows)
        aux = torch.stack([moe_aux["load_balance_loss"],
                           moe_aux["router_z_loss"]])
        x = x + y
    elif desc.mlp != "none":
        h = rms_norm(x, params["ln_mlp"], cfg.norm_eps)
        x = x + mlp_apply(params["mlp"], h, desc.mlp,
                          None if params["mlp"]["wo"].shape[0] == cfg.d_ff
                          else tp)
    return x, new_cache, aux


def _vocab_split(table_rows: int, cfg: ArchConfig, tp):
    """``(the model group, this rank's first vocab row)`` where the
    vocab is split over it (the rank's ``table_rows`` fewer than
    ``padded_vocab``), else ``(None, 0)``."""
    if tp is None or table_rows == cfg.padded_vocab:
        return None, 0
    return tp.group, tp.index * table_rows


def _embed_in(params, batch, cfg: ArchConfig, tp=None) -> torch.Tensor:
    """The first layer's input, as the reference's: the encoder's
    ``features`` (B, S, frontend_dim) through ``frontend_proj`` plus
    ``pos_embed[:S]``; else the token embeddings scaled by
    ``d_model**0.5``, and for the VLM the ``img_embeds`` (B, img_tokens,
    frontend_dim) through ``img_proj`` in place of the first
    ``img_tokens`` positions when S reaches ``img_tokens`` (the sequence
    as it is below that).  With the vocab split over ``tp``'s group the
    lookup is vocab-parallel (``collectives.vocab_embed``)."""
    dt = cfg.activation_dtype
    if cfg.family == "encoder":
        feats = batch["features"].to(dt)
        s = feats.shape[1]
        if s > POS_EMBED_ROWS:
            raise ValueError(f"{cfg.name} encodes at most {POS_EMBED_ROWS} "
                             f"frames (its pos_embed rows), got {s}")
        return feats @ params["frontend_proj"] + params["pos_embed"][:s]
    # F.embedding: on the card its backward sums the rows in a fixed
    # order, so a replayed step is the same step bit for bit
    group, offset = _vocab_split(params["embed"].shape[0], cfg, tp)
    tokens = batch["tokens"].long()
    x = F.embedding(tokens, params["embed"]) if group is None \
        else vocab_embed(tokens, params["embed"], offset, group)
    x = x.to(dt)
    x = x * torch.tensor(cfg.d_model ** 0.5, dtype=dt)
    if cfg.family == "vlm" and "img_embeds" in batch \
            and x.shape[1] >= cfg.img_tokens:
        img = batch["img_embeds"].to(dt) @ params["img_proj"]
        x = torch.cat([img, x[:, cfg.img_tokens:]], dim=1)
    return x


def _logits(params, x, cfg: ArchConfig, tp=None) -> torch.Tensor:
    """The (soft-capped, padding-masked) logits; with the vocab split
    over ``tp``'s group, this rank's columns of them, masked by their
    global column indices."""
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["head"]
    group, offset = _vocab_split(head.shape[1], cfg, tp)
    if group is not None:
        x = sum_grad(x, group, "model", f32=True)
    logits = x @ head.to(x.dtype)
    if cfg.logit_softcap > 0:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    if cfg.padded_vocab != cfg.vocab:  # mask padding columns
        valid = offset + torch.arange(head.shape[1], device=x.device) \
            < cfg.vocab
        logits = torch.where(valid, logits,
                             torch.tensor(-1e30, dtype=logits.dtype,
                                          device=x.device))
    return logits


def _cast_params(params, dt: torch.dtype):
    """Every floating leaf in the activation dtype (no copy for a leaf
    already stored in it)."""
    return {k: (_cast_params(v, dt) if isinstance(v, dict)
                else v.to(dt) if v.is_floating_point() else v)
            for k, v in params.items()}


def _unstack(tree, n: int) -> list[dict]:
    """The ``n`` layer slices of a stacked tree, by one ``unbind`` a
    leaf: its backward stacks the layers' gradients once, where
    indexing would add a whole-leaf gradient for each layer.  The slices
    are views, so decode's in-place cache writes reach the stack."""
    flat = {k: (_unstack(v, n) if isinstance(v, dict) else v.unbind(0))
            for k, v in tree.items()}
    return [{k: v[li] for k, v in flat.items()} for li in range(n)]


_SAVED_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_products(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_PRODUCTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


_REMAT_CONTEXTS = {
    "nothing": noop_context_fn,
    "dots": functools.partial(create_selective_checkpoint_contexts,
                              _save_products)}


def forward(params, batch, cfg: ArchConfig, *, mode: str = "train",
            cache=None, lengths=None, flags: RunFlags = RunFlags(),
            last_logit_only: bool = False, return_aux: bool = False):
    """Returns (logits, new_cache); new_cache is None in train mode.
    ``return_aux``: (logits, new_cache, aux), aux ``{"load_balance_loss",
    "router_z_loss"}`` f32 scalars summed over the MoE layers (0 for a
    dense config), as the reference's third value.

    ``train`` is the pass that ``loss_fn`` differentiates: with
    ``flags.remat`` each layer runs under activation checkpointing
    (:class:`RunFlags`).  ``prefill`` returns the cache of
    the prompt, stacked over each segment's layers: ``{seg: {pos:
    {"attn": {"k", "v"}}}}`` of ``(layers, B, S, Hk, hd)`` (an MLA
    block's ``{"ckv", "krope"}`` of ``(layers, B, S, kv_lora)`` and
    ``(layers, B, S, qk_rope)``); an SSM block's ``{"ssm": {"h",
    "conv"}}`` holds the state after the prompt, ``h`` f32 ``(layers, B,
    H, P, N)`` and ``conv`` the last ``W-1`` conv inputs ``(layers, B,
    W-1, conv_dim)``, and a hybrid block has both entries.  ``decode``
    writes into ``cache`` in place (k/v at ``lengths``; the SSM state
    of every row, idle slots' too, as the reference's) and returns
    it.
    ``last_logit_only``: the logits of the last position only.

    ``batch`` holds ``tokens`` (B, S), with the VLM's optional
    ``img_embeds`` (B, img_tokens, frontend_dim), or the encoder's
    ``features`` (B, S, frontend_dim); the encoder has no ``decode``.
    ``batch["positions"]`` (B, S), optional outside decode (default:
    ``0..S-1`` on every row), drive RoPE on every path and the masks of
    ``naive``, ``chunked_q`` and the short ``swa`` branch.  The flash
    kernel masks by index, which is their mask only when each row is
    ``p0 + 0..S-1``: other positions at ``attn_impl="flash"`` raise."""
    check_supported(cfg)
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(mode)
    if mode == "decode" and not cfg.supports_decode:
        raise ValueError(f"{cfg.name} is encoder-only: no decode")
    on_mesh = _on_mesh(cfg, mode, flags)
    tp = None if on_mesh is None else on_mesh.tp
    params = _cast_params(params, cfg.activation_dtype)
    x = _embed_in(params, batch, cfg, tp)
    require_f32_accumulation(x)
    b, s, _ = x.shape
    if mode == "decode":
        positions = lengths[:, None]
    elif "positions" in batch:
        positions = _batch_positions(batch["positions"], (b, s), cfg,
                                     flags, x.device)
    else:
        positions = torch.arange(s, device=x.device)[None].expand(b, s)

    def body(x, lp, lc, descs):
        """One layer: (x, its caches, its MoE aux summed over the
        pattern's blocks, or None), the aux a tensor output so that its
        gradient passes through the checkpoint."""
        outs, aux = {}, None
        for di, desc in enumerate(descs):
            x, outs[f"pos{di}"], a = _block_apply(
                lp[f"pos{di}"], x, cfg, desc, positions=positions,
                mode=mode, cache=None if lc is None else lc[f"pos{di}"],
                lengths=lengths, flags=flags, on_mesh=on_mesh)
            if a is not None:
                aux = a if aux is None else aux + a
        return x, outs, aux

    remat = flags.remat and mode == "train"
    context_fn = _REMAT_CONTEXTS[flags.remat_policy]
    new_cache = {}
    aux_sum = torch.zeros(2, device=x.device)
    for si, (descs, rep) in enumerate(cfg.layer_segments()):
        seg_cache = None if cache is None else cache[f"seg{si}"]
        stacked = None
        lcs = [None] * rep if seg_cache is None else _unstack(seg_cache, rep)
        for li, (lp, lc) in enumerate(zip(
                _unstack(params["segments"][f"seg{si}"], rep), lcs)):
            if remat:
                x, outs, aux = checkpoint(body, x, lp, lc, descs,
                                          use_reentrant=False,
                                          context_fn=context_fn)
            else:
                x, outs, aux = body(x, lp, lc, descs)
            if aux is not None:
                aux_sum = aux_sum + aux
            if mode == "prefill":
                if stacked is None:
                    stacked = _empty_stack(outs, rep)
                _set_layer(stacked, outs, li)
        if mode == "prefill":
            new_cache[f"seg{si}"] = stacked
        elif mode == "decode":
            new_cache[f"seg{si}"] = seg_cache
    if last_logit_only:
        x = x[:, -1:]
    logits = _logits(params, x, cfg, tp)
    new_cache = new_cache if mode in ("prefill", "decode") else None
    if return_aux:
        return logits, new_cache, {"load_balance_loss": aux_sum[0],
                                   "router_z_loss": aux_sum[1]}
    return logits, new_cache


@dataclasses.dataclass(frozen=True, eq=False)
class _OnMesh:
    """A forward's place on ``RunFlags.mesh``: the ``model`` group and
    the batch's (``data``, with ``pod`` on a mesh that has it) where
    they span more than one rank, and ``(data group, this rank's data
    index)`` for the sequence-sharded decode."""
    tp: TensorGroup | None
    data: TensorGroup | None
    seq_shard: tuple | None


def _on_mesh(cfg: ArchConfig, mode: str, flags: RunFlags):
    """The forward's :class:`_OnMesh` (None without a mesh), after
    :func:`check_mesh`."""
    if flags.mesh is None:
        return None
    check_mesh(cfg, flags.mesh)
    mesh = flags.mesh
    sizes = axis_sizes(mesh)
    seq = (mesh.get_group("data"), mesh.get_local_rank("data")) \
        if flags.seq_shard_decode and mode == "decode" else None
    # the batch is split over data, and over the pods of a mesh with a
    # pod axis (the reference's batch axes)
    batch = [a for a in ("pod", "data") if a in sizes]
    return _OnMesh(
        tp=TensorGroup.of(mesh, "model") if sizes["model"] > 1 else None,
        data=TensorGroup.over(mesh, batch)
        if math.prod(sizes[a] for a in batch) > 1 else None,
        seq_shard=seq)


def _batch_positions(positions, shape, cfg: ArchConfig, flags: RunFlags,
                     device) -> torch.Tensor:
    """``batch["positions"]`` as a (B, S) int64 tensor on ``device``;
    raises where ``flags.attn_impl="flash"`` runs a global attention
    layer (an MLA or a hybrid layer among them; an SSM block runs no
    attention) on positions the kernel's index mask does not equal."""
    positions = torch.as_tensor(positions, device=device).long()
    if tuple(positions.shape) != shape:
        raise ValueError(f"batch positions of shape "
                         f"{tuple(positions.shape)}, tokens {shape}")
    runs_flash = any(d.mixer != "ssm" and not (d.window and cfg.causal)
                     for descs, _ in cfg.layer_segments() for d in descs)
    if flags.attn_impl == "flash" and runs_flash:
        offset = positions - torch.arange(shape[1], device=device)
        if not bool((offset == offset[:, :1]).all()):
            raise ValueError(
                "attn_impl='flash' masks by index, which equals the "
                "position mask only for positions p0 + 0..S-1 on each row; "
                "these are not: use attn_impl='naive' or 'chunked_q', "
                "which mask by positions")
    return positions


def loss_fn(params, batch, cfg: ArchConfig, flags: RunFlags = RunFlags(),
            aux_weight: float = 0.01, z_weight: float = 1e-3):
    """Next-token cross-entropy on f32 logits: the labels are the tokens
    shifted left and padded, and the last position weighs 0.  The
    encoder's is the masked-frame cross-entropy: ``batch["labels"]`` (B,
    S) weighted by ``batch["label_mask"]`` (ones where it is absent).
    Either is the weighted sum over the weights' sum (at least 1).  Returns
    ``(total, metrics)`` with ``total = loss + aux_weight·aux_lb +
    z_weight·aux_z``, the MoE layers' load-balance and router z-losses
    summed over the layers (both 0 for a dense config), and ``metrics``
    ``{"loss", "aux_lb", "aux_z", "tokens"}``.

    On ``flags.mesh`` ``batch`` is this rank's rows and ``params`` its
    blocks: the logits may be the rank's vocab columns
    (``collectives.vocab_logsumexp`` / ``vocab_pick``), and both sums,
    the weighted ``nll`` and the weights, are sums over the ``data``
    ranks, the reference's loss over the global batch (a mean of the
    ranks' means would be wrong wherever their weights differ).  Each
    rank returns that global loss, whose gradient on the rank is ``D``
    (the data ranks) times its rows' share: the ranks' gradients
    averaged over ``data`` are the global batch's."""
    logits, _, aux = forward(params, batch, cfg, mode="train", flags=flags,
                             return_aux=True)
    on_mesh = _on_mesh(cfg, "train", flags)
    tp = None if on_mesh is None else on_mesh.tp
    logits = logits.float()
    if cfg.family == "encoder":
        labels = batch["labels"].long()
        weights = batch.get("label_mask")
        weights = (torch.ones(labels.shape, device=logits.device)
                   if weights is None else weights.float())
    else:
        labels = F.pad(batch["tokens"][:, 1:].long(), (0, 1))
        weights = F.pad(torch.ones(labels[:, :-1].shape,
                                   device=logits.device), (0, 1))
    group, offset = _vocab_split(logits.shape[-1], cfg, tp)
    # the label's logit by a gather: the reference contracts with a
    # one-hot over the vocab, whose only nonzero term is the same value,
    # and a one-hot would be a second f32 tensor of the logits' size
    # (4.19 GB at 2 x 2048 tokens of Gemma's 256,000)
    if group is None:
        lse = torch.logsumexp(logits, dim=-1)
        lab = torch.gather(logits, -1, labels[..., None])[..., 0]
    else:
        lse = vocab_logsumexp(logits, group)
        lab = vocab_pick(logits, labels, offset, group)
    nll = (lse - lab) * weights
    data = None if on_mesh is None else on_mesh.data
    if data is None:
        loss = nll.sum() / torch.clamp(weights.sum(), min=1.0)
    else:
        with torch.no_grad():
            w_all = all_reduce(weights.sum(), data.group, "data")
            nll_all = all_reduce(nll.sum().detach(), data.group, "data")
        local = nll.sum() * (data.size / torch.clamp(w_all, min=1.0))
        # the global loss's value, the rank's rows' gradient (times D)
        loss = nll_all / torch.clamp(w_all, min=1.0) + (local
                                                        - local.detach())
        weights = w_all
    aux_lb, aux_z = aux["load_balance_loss"], aux["router_z_loss"]
    total = loss + aux_weight * aux_lb + z_weight * aux_z
    metrics = {"loss": loss, "aux_lb": aux_lb, "aux_z": aux_z,
               "tokens": weights.sum()}
    return total, metrics


def _empty_stack(tree: dict, n: int) -> dict:
    """A stack of ``n`` layers shaped like ``tree`` (one layer's cache),
    uninitialised."""
    return {k: (_empty_stack(v, n) if isinstance(v, dict)
                else v.new_empty((n, *v.shape))) for k, v in tree.items()}


def _set_layer(stack: dict, tree: dict, i: int) -> None:
    """Layer ``i`` of ``stack`` set to ``tree``: each layer's prefill
    cache goes to its place as the layer ends, so a prefill never holds
    its cache twice (a 2000-token Qwen1.5-32B prefill's is 2.6 GB)."""
    for k, v in tree.items():
        if isinstance(v, dict):
            _set_layer(stack[k], v, i)
        else:
            stack[k][i] = v


def decode_step(params, cache, tokens, lengths, cfg: ArchConfig,
                flags: RunFlags = RunFlags()):
    """One decoding step, the cache (bf16 or int8, :func:`init_cache`)
    updated in place.  tokens (B,1) → (logits (B, vocab), cache).  On
    ``flags.mesh`` the cache is this rank's block (:func:`init_cache`
    with the same flags): with ``seq_shard_decode`` its block of rows,
    tokens and lengths the same on every rank; without it its slots
    (tokens and lengths its rows of them).  The logits are the rank's
    vocab columns where the vocab is split over ``model``
    (:class:`RunFlags`)."""
    logits, cache = forward(params, {"tokens": tokens}, cfg, mode="decode",
                            cache=cache, lengths=lengths, flags=flags)
    return logits[:, -1], cache


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype: torch.dtype | None = None, kv_dtype: str = "bf16",
               device: str | torch.device = "cuda",
               flags: RunFlags | None = None) -> dict:
    """Zero cache matching the segment structure: per attention block
    (a hybrid block's attention half too) ``{"attn": {"k", "v"}}`` of
    ``(layers, batch, max_len, Hk, hd)``, per MLA block the latent
    ``{"attn": {"ckv": (layers, batch, max_len, kv_lora), "krope":
    (layers, batch, max_len, qk_rope)}}``, per SSM or hybrid block the
    state ``{"ssm": {"h": f32 (layers, batch, H, P, N), "conv": (layers,
    batch, W-1, conv_dim)}}``, in ``dtype`` (default: the activation
    dtype; ``h`` f32, float64 in a float64 cache), on ``device``
    (default: the card).  ``kv_dtype="int8"``: each attention block's
    ``k`` and ``v`` in int8 beside their f32 scales ``k_s``, ``v_s`` of
    ``(layers, batch, max_len, 1, 1)``, one a token (about half the
    bf16 cache's bytes); MLA latents and SSM states keep ``dtype``, as
    the reference's.  On ``flags.mesh``: this rank's block of the cache
    of ``batch`` slots, as ``sharding.rules.cache_shardings`` cuts it
    (``seq_shard=flags.seq_shard_decode``).  ``device="meta"``: shapes
    only."""
    check_supported(cfg)
    device = torch.device("meta") if str(device) == "meta" \
        else resolve_device(device)
    if flags is not None and flags.mesh is not None:
        check_mesh(cfg, flags.mesh)
        whole = init_cache(cfg, batch, max_len, dtype, kv_dtype, "meta")
        specs = cache_shardings(flags.mesh, whole,
                                seq_shard=flags.seq_shard_decode)
        coords = mesh_coords(flags.mesh)

        def block(tree, spec):
            return {k: (block(v, spec[k]) if isinstance(v, dict) else
                        torch.zeros(local_block(v, spec[k], flags.mesh,
                                                coords).shape,
                                    dtype=v.dtype, device=device))
                    for k, v in tree.items()}
        return block(whole, specs)
    if kv_dtype not in ("bf16", "int8"):
        raise ValueError(f"unknown kv_dtype {kv_dtype!r}")
    dt = dtype or cfg.activation_dtype
    hd = cfg.resolved_head_dim
    cache: dict[str, Any] = {}
    for si, (descs, rep) in enumerate(cfg.layer_segments()):
        lead = (rep, batch, max_len)
        seg = cache[f"seg{si}"] = {}
        for di, desc in enumerate(descs):
            blk = seg[f"pos{di}"] = {}
            if desc.mixer == "mla":
                shapes = {"ckv": lead + (cfg.kv_lora_rank,),
                          "krope": lead + (cfg.qk_rope_head_dim,)}
            elif desc.mixer in ("attn", "hybrid"):
                shapes = dict.fromkeys(("k", "v"),
                                       lead + (cfg.n_kv_heads, hd))
            else:
                shapes = None
            if shapes is not None:
                kv_dt = torch.int8 if kv_dtype == "int8" and \
                    desc.mixer != "mla" else dt
                blk["attn"] = {name: torch.zeros(shape, dtype=kv_dt,
                                                 device=device)
                               for name, shape in shapes.items()}
                if kv_dt == torch.int8:
                    blk["attn"].update(
                        {name: torch.zeros(lead + (1, 1), device=device)
                         for name in ("k_s", "v_s")})
            if desc.mixer in ("ssm", "hybrid"):
                blk["ssm"] = ssm_mod.init_state(cfg, batch, dt, device,
                                                (rep,))
    return cache
