"""Attention of the LLM stack: GQA/MQA/MHA with RoPE and a KV cache,
global or sliding-window, causal or (the encoder's) full, with optional
logit soft-capping, and MLA (the port of ``repro.models.attention``).

* :func:`flash_attention` — train and prefill attention of a global
  layer.  On the card it launches the hand-written kernel
  (``kernels/csrc/flash_attention*.cu``, the port of the Pallas
  ``_fa_kernel``, soft-cap included); on the CPU its plain version.
  Either is differentiable (``FlashAttentionFn``: the backward
  recomputes attention in plain PyTorch).  The kernel masks by index,
  which is the reference's position mask when each row's positions are
  ``p0 + 0..S-1`` (``models/transformer.py`` refuses others at
  ``attn_impl="flash"``).
* :func:`swa_attention` — exact causal sliding-window attention of a
  local layer by the reference's block-local form (each query block of
  ``window`` rows attends to itself and the block before), at every
  ``attn_impl``.
* :func:`naive_attention` and :func:`chunked_q_attention` — the
  full-matrix reference, whole or one q block at a time, selected by
  ``attn_impl="naive"`` / ``"chunked_q"``; both mask by positions.
* :func:`decode_attention` — one-token attention over the static-size
  cache with a length (and window) mask.
* :func:`mla_specs` / :func:`mla_apply` — multi-head latent attention
  (MiniCPM3): low-rank q and kv projections with a decoupled RoPE part
  shared by the heads.  Train and prefill expand the latent to per-head
  k and v and run :func:`flash_attention` on q·k head dim ``qk_nope +
  qk_rope`` and value head dim ``v_head_dim`` (the kernel's split
  instances) or :func:`naive_attention`; decode attends in the latent
  space (the absorbed projections), over a cache of ``kv_lora +
  qk_rope`` values a token.

* :func:`quantize_kv` / :func:`dequantize_kv` — the int8 KV cache: one
  f32 scale a token (over all its heads and the head dim), codes rounded
  half to even and clipped to ±127; decode writes the codes and scales
  of its token and attends over the cache dequantized in the activation
  dtype (a per-layer transient).
* :func:`flash_decode` — decode attention over a cache whose sequence is
  split over the mesh's ``data`` ranks: each rank's partial (max,
  denominator, numerator) over its rows (:func:`flash_decode_partials`),
  combined by a max and two sums over the ranks
  (:func:`flash_decode_combine`: three ``all_reduce`` calls a layer).

``swa_attention``, ``chunked_q_attention``, ``decode_attention``,
``flash_decode``, the int8 quantization and MLA's absorbed decode are
plain PyTorch on the card too: the reference computes them in jnp
outside any Pallas kernel.  Scores and softmax run in f32, and ``p`` is
cast to v's dtype before ``p·v``, as the reference.

On a ``model`` axis above 1 (:class:`~repro_torch.sharding.
collectives.TensorGroup`) :func:`attention_apply` runs the rank's whole
heads: q, k and v projected by its column blocks, the kernel (or the
plain attention) over them, ``wo`` row-parallel and summed over the
group.  Where the rules' blocks cut a head (Hymba's 25 heads over 2
ranks: ``wq``'s columns split at 12.5 heads), the heads are the
reference's ``_pad_heads_even``: GQA expanded to MHA, the heads
zero-padded to a multiple of the axis, ``ceil(H/m)`` a rank, the pads
the last; each rank reads the columns of its padded heads from the
leaves gathered over ``model`` (``collectives.leaf_part``: the backward
sums the ranks' cotangents into the owning block), drops its pads after
the attention and multiplies its real heads' rows of ``wo``.  Its
decode holds the cache as the rules cut it (the head dim split where
the kv heads do not divide the axis): the scores' partial sums over the
rank's slice of the head dim are summed over ``model``, and the
outputs' slices gathered.  :func:`mla_apply` runs the rank's (padded)
heads the same way, ``q_norm``'s RMS over the whole ``q_lora`` (the
q-down projection gathered), the latent whole on every rank; under
``seq_shard`` its absorbed decode combines the ranks' partial softmax
over their cache rows (:func:`flash_decode_combine`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig, BlockDesc
from repro_torch.kernels.flash_attention import (FlashAttentionFn,
                                                 flash_attention_cuda,
                                                 flash_attention_meta,
                                                 flash_attention_plain)
from repro_torch.models.common import (PSpec, apply_rope, rms_norm,
                                       rope_angles)
from repro_torch.sharding import collectives
from repro_torch.sharding.collectives import leaf_part, reduce_from_model

__all__ = ["attention_specs", "attention_apply", "mla_specs", "mla_apply",
           "flash_attention", "naive_attention", "chunked_q_attention",
           "swa_attention", "decode_attention", "quantize_kv",
           "dequantize_kv", "flash_decode_partials", "flash_decode_combine",
           "flash_decode"]

NEG_INF = -1e30


def _softcap(scores: torch.Tensor, softcap: float) -> torch.Tensor:
    return softcap * torch.tanh(scores / softcap) if softcap > 0 else scores


def _mask(q_pos: torch.Tensor, k_pos: torch.Tensor, *, causal: bool,
          window: int = 0) -> torch.Tensor:
    """(B,S,T) validity mask from absolute positions.

    q_pos: (B,S) int; k_pos: (B,T) or (T,).  A key is kept when it is
    not after the query (``causal``), less than ``window`` before it
    (``window`` > 0), and not padding (a negative k_pos)."""
    if k_pos.ndim == 1:
        k_pos = k_pos[None]
    d = q_pos[:, :, None] - k_pos[:, None, :]
    m = torch.ones(d.shape, dtype=torch.bool, device=d.device)
    if causal:
        m &= d >= 0
    if window > 0:
        m &= d < window
    m &= k_pos[:, None, :] >= 0
    return m


def naive_attention(q, k, v, q_pos, k_pos, *, causal: bool = True,
                    window: int = 0, softcap: float = 0.0) -> torch.Tensor:
    """Reference full-matrix attention.  q (B,S,Hq,hd), k/v (B,T,Hk,hd).
    Scores and softmax in f32, soft-capped after the ``hd**-0.5`` scale
    and before the mask; the probabilities are cast to v's dtype before
    ``p·v``, as the reference."""
    b, s, hq, hd = q.shape
    hk = k.shape[2]
    hv = v.shape[-1]
    qg = q.reshape(b, s, hk, hq // hk, hd)
    scores = torch.einsum("bsgrh,btgh->bgrst", qg.float(), k.float())
    scores = _softcap(scores * hd ** -0.5, softcap)
    mask = _mask(q_pos, k_pos, causal=causal, window=window)
    scores = torch.where(mask[:, None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bgrst,btgh->bsgrh", probs, v)
    return out.reshape(b, s, hq, hv)


def chunked_q_attention(q, k, v, q_pos, k_pos, *, causal: bool = True,
                        window: int = 0, softcap: float = 0.0,
                        block_q: int = 1024) -> torch.Tensor:
    """:func:`naive_attention` one q block of ``block_q`` rows at a time
    (the reference scans over the blocks): live scores O(block_q·T)
    instead of O(S·T).  The tail block is padded with queries at
    position 0, whose rows are dropped."""
    b, s, hq, hd = q.shape
    if s <= block_q:
        return naive_attention(q, k, v, q_pos, k_pos, causal=causal,
                               window=window, softcap=softcap)
    nb = -(-s // block_q)
    pad = nb * block_q - s
    if pad:
        q = F.pad(q, (0, 0, 0, 0, 0, pad))
        q_pos = F.pad(q_pos, (0, pad), value=0)
    out = torch.cat([naive_attention(
        q[:, i:i + block_q], k, v, q_pos[:, i:i + block_q], k_pos,
        causal=causal, window=window, softcap=softcap)
        for i in range(0, nb * block_q, block_q)], dim=1)
    return out[:, :s]


def swa_attention(q, k, v, q_pos, k_pos, *, window: int,
                  softcap: float = 0.0) -> torch.Tensor:
    """Exact causal sliding-window attention, block-local formulation
    (the reference's): FLOPs O(S·2w).  q/k/v of one length S (train and
    prefill).

    For S <= 2w the naive attention with a window, masked by positions.
    Above, the sequence is cut into ``nb = ceil(S/w)`` blocks of ``w``
    (zero-padded at the tail); each query block attends to its own keys
    and the previous block's (none for the first), masked by index:
    ``0 <= i + w - j < w`` within the block pair, and queries and keys
    past S or before 0 dropped (the reference's behaviour: its blocked
    branch takes no positions)."""
    b, s, hq, hd = q.shape
    hk = k.shape[2]
    rep = hq // hk
    w = window
    if s <= 2 * w:  # not worth blocking
        return naive_attention(q, k, v, q_pos, k_pos, causal=True,
                               window=window, softcap=softcap)
    nb = -(-s // w)
    pad = nb * w - s
    if pad:
        q, k, v = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (q, k, v))
    qb = q.reshape(b, nb, w, hk, rep, hd)
    kb = k.reshape(b, nb, w, hk, hd)
    vb = v.reshape(b, nb, w, hk, hd)
    k_prev = F.pad(kb, (0, 0, 0, 0, 0, 0, 1, 0))[:, :-1]
    v_prev = F.pad(vb, (0, 0, 0, 0, 0, 0, 1, 0))[:, :-1]
    kc = torch.cat([k_prev, kb], dim=2)          # (b, nb, 2w, hk, hd)
    vc = torch.cat([v_prev, vb], dim=2)
    sc = torch.einsum("bnigrh,bnjgh->bngrij", qb.float(), kc.float())
    sc = _softcap(sc * hd ** -0.5, softcap)
    dev = q.device
    i = torch.arange(w, device=dev)[:, None]
    j = torch.arange(2 * w, device=dev)[None, :]
    delta = i + w - j            # q_abs - k_abs
    rel_ok = (delta >= 0) & (delta < w)
    first_blk = (torch.arange(nb, device=dev) == 0)[:, None, None]
    from_prev = (j < w)[None, :, :].expand(nb, w, 2 * w)
    valid = rel_ok[None] & ~(first_blk & from_prev)
    # mask padded queries/keys at the tail
    blk = torch.arange(nb, device=dev)[:, None]
    qi_abs = blk * w + torch.arange(w, device=dev)[None, :]
    kj_abs = (blk - 1) * w + torch.arange(2 * w, device=dev)[None, :]
    valid = (valid & (qi_abs[:, :, None] < s) & (kj_abs[:, None, :] < s)
             & (kj_abs[:, None, :] >= 0))
    sc = torch.where(valid[None, :, None, None], sc, NEG_INF)
    pr = torch.softmax(sc, dim=-1).to(vc.dtype)
    out = torch.einsum("bngrij,bnjgh->bnigrh", pr, vc)
    out = out.reshape(b, nb * w, hq, hd)[:, :s]
    return out.to(q.dtype)


def flash_attention(q, k, v, *, causal: bool = True,
                    softcap: float = 0.0) -> torch.Tensor:
    """Blocked online-softmax attention, masked by index (positions
    ``p0 + 0..S-1`` against ``p0 + 0..T-1``).  q (B,S,Hq,hd), k/v
    (B,T,Hk,hd): GQA is expanded to MHA (``repeat_interleave`` over
    heads, the reference's head order; its backward sums dk and dv over
    the repeats), then the kernel runs on a CUDA tensor and its plain
    version on a CPU one, each looked up here at call time, through
    :class:`FlashAttentionFn`; ``softcap`` > 0 soft-caps the scores in
    the kernel.  On ``meta`` tensors (the dry-run) it is the kernel's
    launch as ``flash_attention_meta`` checks and counts it, never the
    plain version."""
    rep = q.shape[2] // k.shape[2]
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    attend = flash_attention_cuda if q.is_cuda else \
        flash_attention_meta if q.is_meta else flash_attention_plain
    return FlashAttentionFn.apply(q, k, v, causal, attend, softcap)


def decode_attention(q, k_cache, v_cache, lengths, *, window: int = 0,
                     softcap: float = 0.0) -> torch.Tensor:
    """One-token attention over a static-size cache.

    q: (B,1,Hq,hd); caches (B,T,Hk,hd); lengths (B,) = index of the
    current token (the cache already holds it at ``lengths``).  A key
    counts when its index is at most ``lengths`` and, with a window,
    greater than ``lengths - window``.  Scores and softmax in f32,
    soft-capped before the mask, ``p`` cast to the cache's dtype."""
    b, _, hq, hd = q.shape
    t, hk = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(b, 1, hk, hq // hk, hd)
    sc = torch.einsum("bsgrh,btgh->bgrst", qg.float(), k_cache.float())
    sc = _softcap(sc * hd ** -0.5, softcap)
    kpos = torch.arange(t, device=q.device)[None]
    ok = kpos <= lengths[:, None]
    if window > 0:
        ok &= kpos > lengths[:, None] - window
    sc = torch.where(ok[:, None, None, None], sc, NEG_INF)
    pr = torch.softmax(sc, dim=-1).to(v_cache.dtype)
    out = torch.einsum("bgrst,btgh->bsgrh", pr, v_cache)
    return out.reshape(b, 1, hq, hd).to(q.dtype)


def quantize_kv(x: torch.Tensor, group=None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """x (..., Hk, hd) → (int8 codes of x's shape, f32 scales (..., 1,
    1)): one scale a token, ``max(max|x| / 127, 1e-8)`` over all its
    heads and the head dim, and codes ``clip(round(x / s), -127, 127)``,
    rounded half to even, all in f32 (the reference's, whose docstring
    says per-(token, head) but whose code reduces over both axes).  With
    the heads split over ``group`` (a ``model`` group) the max is taken
    over every rank's heads (one ``all_reduce``)."""
    xf = x.float()
    amax = xf.abs().amax(dim=(-2, -1), keepdim=True)
    if group is not None:
        amax = collectives.all_reduce(amax, group, "model", op="max")
    s = (amax / 127.0).clamp_min(1e-8)
    return torch.round(xf / s).clamp(-127, 127).to(torch.int8), s


def dequantize_kv(codes: torch.Tensor, scales: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
    """``codes · scales``, each cast to ``dtype`` and multiplied there
    (rounded once in ``dtype``, as the reference, not in f32)."""
    return codes.to(dtype) * scales.to(dtype)


def flash_decode_partials(q, k_local, v_local, lengths, offset: int = 0,
                          window: int = 0, softcap: float = 0.0):
    """One shard's partial decode attention.  q (B,1,Hq,hd); k_local,
    v_local (B,T_loc,Hk,hd) hold the cache rows at indices ``offset +
    0..T_loc-1``; a key counts as in :func:`decode_attention` (scores
    soft-capped as there, before the mask, where ``softcap`` > 0).  Returns
    f32 ``(m, den, num)``: the row max of the masked scores and the
    denominator, (B,Hk,rep,1), and the numerator (B,Hk,rep,1,hd) of the
    softmax relative to that max.  A shard with no live key for a row
    gives ``m = NEG_INF``, a finite -1e30, so ``exp(m - m_g)`` is 0 in the
    combine and its terms weigh nothing (no ``inf - inf``)."""
    b, _, hq, hd = q.shape
    t, hk = k_local.shape[1], k_local.shape[2]
    qg = q.reshape(b, 1, hk, hq // hk, hd)
    sc = torch.einsum("bsgrh,btgh->bgrst", qg.float(), k_local.float())
    sc = _softcap(sc * hd ** -0.5, softcap)
    kpos = offset + torch.arange(t, device=q.device)[None]
    ok = kpos <= lengths[:, None]
    if window > 0:
        ok &= kpos > lengths[:, None] - window
    sc = torch.where(ok[:, None, None, None], sc, NEG_INF)
    m = sc.amax(dim=-1)
    p = torch.exp(sc - m[..., None])
    # p cast to v's dtype, the products summed in f32
    num = torch.einsum("bgrst,btgh->bgrsh", p.to(v_local.dtype).float(),
                       v_local.float())
    return m, p.sum(dim=-1), num


def _shard_reduce(t: torch.Tensor, op: str, group) -> torch.Tensor:
    if group is None:
        return t.amax(0, keepdim=True) if op == "max" \
            else t.sum(0, keepdim=True)
    return collectives.all_reduce(t, group, "data", op=op)


def flash_decode_combine(m, den, num, group=None) -> torch.Tensor:
    """The shards' partials (:func:`flash_decode_partials`, each with a
    leading shard axis) combined: ``m_g = max m``, ``corr = exp(m -
    m_g)``, the sums of ``den·corr`` and ``num·corr``, and ``num_g /
    max(den_g, 1e-30)``, (B,Hk,rep,1,hd) f32.  Over ``group`` (a rank's
    partials, a shard axis of 1) each reduction is one ``all_reduce``
    over the group's ranks; with no group they run over the leading axis,
    so one process can combine any number of shards by the same
    reductions."""
    m_g = _shard_reduce(m, "max", group)
    corr = torch.exp(m - m_g)
    den_g = _shard_reduce(den * corr, "sum", group)
    num_g = _shard_reduce(num * corr[..., None], "sum", group)
    return (num_g / den_g.clamp_min(1e-30)[..., None])[0]


def flash_decode(q, k_local, v_local, lengths, *, offset: int = 0,
                 group=None, window: int = 0,
                 softcap: float = 0.0) -> torch.Tensor:
    """Decode attention with the cache's sequence split over ``group``'s
    ranks (the reference's ``flash_decode`` over the mesh's ``data``
    axis): this rank's partials over its rows ``offset + 0..T_loc-1``,
    combined over the group (3 ``all_reduce`` calls).  With no group the
    cache is whole.  q (B,1,Hq,hd) → (B,1,Hq,hd) in q's dtype.  The
    reference's ``flash_decode`` has no soft-cap; ``softcap`` serves the
    windowed layers, which the reference decodes by ``decode_attention``
    over the gathered cache, soft-cap included."""
    b, _, hq, hd = q.shape
    m, den, num = flash_decode_partials(q, k_local, v_local, lengths,
                                        offset, window, softcap)
    out = flash_decode_combine(m[None], den[None], num[None], group)
    return out.permute(0, 3, 1, 2, 4).reshape(b, 1, hq, hd).to(q.dtype)


def _write_rows(c: torch.Tensor, new: torch.Tensor, lengths,
                offset: int | None):
    """``new`` (B, ...) into row ``lengths[b]`` of each sequence of ``c``
    (B, T, ...), in place.  With an ``offset``, ``c`` holds the rows
    ``offset + 0..T-1`` of a longer cache: a sequence whose row lies
    outside them is left as it is (no host sync)."""
    rows = torch.arange(c.shape[0], device=c.device)
    if offset is None:
        c[rows, lengths] = new.to(c.dtype)
        return
    t = c.shape[1]
    local = lengths - offset
    mine = ((local >= 0) & (local < t)).view(-1, *([1] * (new.ndim - 1)))
    at = local.clamp(0, t - 1)
    c[rows, at] = torch.where(mine, new.to(c.dtype), c[rows, at])


def attention_specs(cfg: ArchConfig, desc: BlockDesc) -> dict[str, PSpec]:
    d, hq, hk = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    hd = cfg.resolved_head_dim
    specs = {
        "wq": PSpec((d, hq * hd), ("embed", "heads")),
        "wk": PSpec((d, hk * hd), ("embed", "kv_heads")),
        "wv": PSpec((d, hk * hd), ("embed", "kv_heads")),
        "wo": PSpec((hq * hd, d), ("heads", "embed")),
    }
    if cfg.qkv_bias:
        specs["bq"] = PSpec((hq * hd,), ("heads",), init="zeros")
        specs["bk"] = PSpec((hk * hd,), ("kv_heads",), init="zeros")
        specs["bv"] = PSpec((hk * hd,), ("kv_heads",), init="zeros")
    return specs


def _rank_heads(t: torch.Tensor, hq: int, hq_loc: int, index: int
                ) -> torch.Tensor:
    """The kv heads that q heads ``index·hq_loc + 0..hq_loc-1`` read, of a
    replicated ``t`` (B, T, Hk, hd) (``kv_heads`` fell back to
    replication): a block of the kv heads where whole groups of
    ``hq / Hk`` q heads fall on the rank, else each of its q heads' own
    kv head (the reference's ``repeat_interleave`` order)."""
    rep = hq // t.shape[2]
    if hq_loc % rep == 0:
        return t.narrow(2, index * hq_loc // rep, hq_loc // rep)
    return t.repeat_interleave(rep, dim=2).narrow(2, index * hq_loc, hq_loc)


def _attend(q, k, v, positions, cfg: ArchConfig, desc: BlockDesc,
            attn_impl: str) -> torch.Tensor:
    """Train and prefill attention of q, k, v (B, S, H, hd): a windowed
    causal layer through :func:`swa_attention` at any ``attn_impl``, else
    ``"flash"``, ``"chunked_q"`` or ``"naive"``; soft-capped by the
    config."""
    cap = cfg.logit_softcap
    if desc.window and cfg.causal:
        return swa_attention(q, k, v, positions, positions,
                             window=desc.window, softcap=cap)
    if attn_impl == "flash":
        return flash_attention(q, k, v, causal=cfg.causal, softcap=cap)
    if attn_impl == "chunked_q":
        return chunked_q_attention(q, k, v, positions, positions,
                                   causal=cfg.causal, softcap=cap)
    if attn_impl == "naive":
        return naive_attention(q, k, v, positions, positions,
                               causal=cfg.causal, softcap=cap)
    raise ValueError(f"unknown attn_impl {attn_impl!r}")


def _cuts_a_head(params, cfg: ArchConfig, m: int) -> bool:
    """Whether the rules' blocks of ``wq`` or ``wk`` end inside a head on
    a model axis of ``m``."""
    hd = cfg.resolved_head_dim
    return any(params[name].shape[-1] < n * hd and n % m
               for name, n in (("wq", cfg.n_heads),
                               ("wk", cfg.n_kv_heads)))


def _padded_heads(h: int, tp) -> tuple[int, int, int]:
    """``(first head, real heads, heads a rank)`` of this rank's block of
    the reference's padded heads (``_pad_heads_even``): ``h`` zero-padded
    to a multiple of the model axis, ``ceil(h/m)`` a rank in order, the
    pads the last rank's last."""
    per = -(-h // tp.size)
    lo = tp.index * per
    return lo, max(0, min(per, h - lo)), per


def _real_heads(out: torch.Tensor, n: int) -> torch.Tensor:
    """The rank's ``n`` real heads of its padded block's output (B, S,
    heads, hd): the first ``n``, the pads dropped."""
    return out[:, :, :n]


def _pad_to(t: torch.Tensor, heads: int) -> torch.Tensor:
    """``t`` (B, S, H, d) zero-padded on the heads to ``heads``."""
    return F.pad(t, (0, 0, 0, heads - t.shape[2])) if heads > t.shape[2] \
        else t


def _kv_block(t: torch.Tensor, tp) -> torch.Tensor:
    """This rank's block of a whole k or v (..., Hk, hd) as the cache
    holds it where the model axis does not divide the kv heads (as on
    every path through :func:`_attention_padded`;
    ``sharding.rules.cache_shardings``): its slice of the head dim where
    the axis divides that, else whole."""
    hd, m = t.shape[-1], tp.size
    if hd % m == 0:
        return t.narrow(-1, tp.index * hd // m, hd // m)
    return t


def _split_hd_attention(q, k_cache, v_cache, lengths, hd: int, tp, *,
                        offset: int | None, seq_group, window: int,
                        softcap: float) -> torch.Tensor:
    """Decode attention over a cache whose head dim is split over the
    model group: q (B,1,Hq,hd_loc) the rank's slice of every head,
    caches (B,T,Hk,hd_loc).  The f32 scores' partial sums over the slices
    are summed over the group (one ``all_reduce``), then masked and
    soft-capped as :func:`decode_attention`'s; ``p`` (cast to the cache's
    dtype) times the rank's slice of v, each rank's slice of the output
    gathered: (B,1,Hq,hd) in q's dtype.  With ``seq_group`` the cache
    holds the rows ``offset + 0..T-1`` and the softmax is combined over
    the group's ranks (:func:`flash_decode_combine`)."""
    b, _, hq, hd_loc = q.shape
    t, hk = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(b, 1, hk, hq // hk, hd_loc)
    sc = torch.einsum("bsgrh,btgh->bgrst", qg.float(), k_cache.float())
    sc = collectives.all_reduce(sc, tp.group, "model")
    sc = _softcap(sc * hd ** -0.5, softcap)
    kpos = (offset or 0) + torch.arange(t, device=q.device)[None]
    ok = kpos <= lengths[:, None]
    if window > 0:
        ok &= kpos > lengths[:, None] - window
    sc = torch.where(ok[:, None, None, None], sc, NEG_INF)
    if seq_group is None:
        pr = torch.softmax(sc, dim=-1).to(v_cache.dtype)
        out = torch.einsum("bgrst,btgh->bgrsh", pr, v_cache)
    else:
        m = sc.amax(dim=-1)
        p = torch.exp(sc - m[..., None])
        num = torch.einsum("bgrst,btgh->bgrsh", p.to(v_cache.dtype).float(),
                           v_cache.float())
        out = flash_decode_combine(m[None], p.sum(dim=-1)[None], num[None],
                                   seq_group)
    out = out.permute(0, 3, 1, 2, 4).reshape(b, 1, hq, hd_loc).to(q.dtype)
    return collectives.all_gather(out, 3, tp.group, "model")


def _attention_padded(params, x, cfg: ArchConfig, desc: BlockDesc, *,
                      positions, mode: str, cache, lengths, attn_impl: str,
                      seq_shard, tp):
    """:func:`attention_apply` where the rules' blocks cut a head (see the
    module docstring): train and prefill over the rank's padded heads
    (:func:`_padded_heads`; k and v of every kv head, then each of its q
    heads' own, the reference's GQA expansion), the prefill's cache the
    rank's block of k and v (:func:`_kv_block`); decode over the cache's
    blocks (:func:`_split_hd_attention`, or, whole, the one-device
    attention on every rank) from the projections of every head."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    hq, hk = cfg.n_heads, cfg.n_kv_heads
    d = cfg.d_model
    lo, n, per = _padded_heads(hq, tp) if mode != "decode" else (0, hq, hq)
    x = collectives.sum_grad(x, tp.group, "model", f32=True)

    def proj(name, heads, first, count):
        w = leaf_part(params[name], (d, heads * hd), tp, 1, first * hd,
                      (first + count) * hd)
        out = x @ w
        bias = params.get("b" + name[1:])
        if bias is not None:
            out = out + leaf_part(bias, (heads * hd,), tp, 0, first * hd,
                                  (first + count) * hd).to(out.dtype)
        return out.reshape(b, s, count, hd)
    cos, sin = rope_angles(positions, hd, desc.rope_theta)
    q = apply_rope(proj("wq", hq, lo, n), cos, sin)
    k = apply_rope(proj("wk", hk, 0, hk), cos, sin)
    v = proj("wv", hk, 0, hk)
    new_cache = None
    if mode in ("train", "prefill"):
        kv = torch.arange(lo, lo + n, device=x.device) // (hq // hk)
        out = _attend(*(_pad_to(t, per) for t in (q, k[:, :, kv],
                                                  v[:, :, kv])),
                      positions, cfg, desc, attn_impl)
        out = _real_heads(out, n).reshape(b, s, n * hd)
        out = out @ leaf_part(params["wo"], (hq * hd, d), tp, 0, lo * hd,
                              (lo + n) * hd)
        if mode == "prefill":
            new_cache = {"k": _kv_block(k, tp), "v": _kv_block(v, tp)}
        return reduce_from_model(out, tp.group), new_cache
    if mode != "decode":
        raise ValueError(mode)
    offset = None if seq_shard is None \
        else seq_shard[1] * cache["k"].shape[1]
    if "k_s" in cache:
        # one scale a token over every head, as on one device
        (kq, ks), (vq, vs) = (quantize_kv(t[:, 0]) for t in (k, v))
        for name, new in (("k", _kv_block(kq, tp)), ("v", _kv_block(vq, tp)),
                          ("k_s", ks), ("v_s", vs)):
            _write_rows(cache[name], new, lengths, offset)
        dt = cfg.activation_dtype
        k_cache = dequantize_kv(cache["k"], cache["k_s"], dt)
        v_cache = dequantize_kv(cache["v"], cache["v_s"], dt)
    else:
        _write_rows(cache["k"], _kv_block(k[:, 0], tp), lengths, offset)
        _write_rows(cache["v"], _kv_block(v[:, 0], tp), lengths, offset)
        k_cache, v_cache = cache["k"], cache["v"]
    # the reference's flash_decode has no soft-cap (see attention_apply)
    cap = cfg.logit_softcap if seq_shard is None or desc.window else 0.0
    group = None if seq_shard is None else seq_shard[0]
    if k_cache.shape[-1] < hd:
        hd_loc = k_cache.shape[-1]
        out = _split_hd_attention(
            q.narrow(-1, tp.index * hd_loc, hd_loc), k_cache, v_cache,
            lengths, hd, tp, offset=offset, seq_group=group,
            window=desc.window, softcap=cap)
    elif group is None:
        out = decode_attention(q, k_cache, v_cache, lengths,
                               window=desc.window, softcap=cap)
    else:
        out = flash_decode(q, k_cache, v_cache, lengths, offset=offset,
                           group=group, window=desc.window, softcap=cap)
    out = out.reshape(b, s, hq * hd)
    wo = params["wo"]
    if wo.shape[0] == hq * hd:
        return out @ wo, cache
    rows = wo.shape[0]
    out = out.narrow(-1, tp.index * rows, rows) @ wo
    return reduce_from_model(out, tp.group), cache


def attention_apply(params, x, cfg: ArchConfig, desc: BlockDesc, *,
                    positions, mode: str = "train", cache=None,
                    lengths=None, attn_impl: str = "flash",
                    seq_shard: tuple | None = None, tp=None):
    """Returns (out, new_cache).

    ``train``: attention over the sequence, no cache: a windowed
    causal layer (``desc.window`` > 0) through :func:`swa_attention` at
    any ``attn_impl``, else ``"flash"``, ``"chunked_q"`` or ``"naive"``.
    ``prefill``: the same, and the cache ``{"k", "v"}`` of the
    un-expanded heads (full length for a windowed layer too, as the
    reference's: no ring buffer).  ``positions`` (B, S) drive RoPE at
    ``desc.rope_theta`` and the position masks.
    ``decode``: writes this token's k/v into ``cache`` *in place* at row
    ``lengths`` of each sequence (the reference returns an updated
    copy), then attends over the cache; returns the same cache.  An int8
    cache (``{"k", "v", "k_s", "v_s"}``) gets the token's codes and
    scales (:func:`quantize_kv`) and is attended dequantized in the
    activation dtype.  ``seq_shard`` (``(group, index)``: the mesh's
    ``data`` group and this rank's place on it) holds this rank's block
    of the cache's rows, ``index·T_loc + 0..T_loc-1``: only the rank
    that owns row ``lengths`` writes it, and attention is
    :func:`flash_decode` over the group (a windowed layer's too, with
    its window and soft-cap).

    ``tp`` (a ``TensorGroup``: the ``model`` group, its size and this
    rank's index) with ``params`` the rank's blocks: where ``wq``'s
    columns are split (fewer than ``n_heads·head_dim``), the rank runs
    its whole heads, ``wo``'s partials summed over the group
    (``reduce_from_model``); k and v are the rank's kv heads, or, where
    ``kv_heads`` fell back to replication, the kv heads its q heads read
    (the cache then holds every kv head).  Where a block cuts a head the
    rank runs its padded heads (:func:`_attention_padded`).  Without a
    split the layer runs whole on every rank."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    hq, hk = cfg.n_heads, cfg.n_kv_heads
    if tp is not None and _cuts_a_head(params, cfg, tp.size):
        return _attention_padded(params, x, cfg, desc, positions=positions,
                                 mode=mode, cache=cache, lengths=lengths,
                                 attn_impl=attn_impl, seq_shard=seq_shard,
                                 tp=tp)
    hq_loc = params["wq"].shape[-1] // hd
    tp = tp if hq_loc < hq else None
    wk, wv = params["wk"], params["wv"]
    bk, bv = params.get("bk"), params.get("bv")
    kv_whole = params["wk"].shape[-1] // hd == hk
    if tp is not None:
        x = collectives.sum_grad(x, tp.group, "model", f32=True)
        if kv_whole:    # a replicated leaf read by part of the heads
            wk, wv, bk, bv = (None if w is None else collectives.sum_grad(
                w, tp.group, "model", f32=True) for w in (wk, wv, bk, bv))
    hk_loc = wk.shape[-1] // hd
    q = x @ params["wq"]
    k = x @ wk
    v = x @ wv
    if cfg.qkv_bias:
        q = q + params["bq"].to(q.dtype)
        k = k + bk.to(k.dtype)
        v = v + bv.to(v.dtype)
    q = q.reshape(b, s, hq_loc, hd)
    k = k.reshape(b, s, hk_loc, hd)
    v = v.reshape(b, s, hk_loc, hd)
    cos, sin = rope_angles(positions, hd, desc.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    def heads(t):
        return t if tp is None or not kv_whole \
            else _rank_heads(t, hq, hq_loc, tp.index)

    new_cache = None
    if mode in ("train", "prefill"):
        out = _attend(q, heads(k), heads(v), positions, cfg, desc, attn_impl)
        if mode == "prefill":
            new_cache = {"k": k, "v": v}
    elif mode == "decode":
        offset = None if seq_shard is None \
            else seq_shard[1] * cache["k"].shape[1]
        if "k_s" in cache:
            group = None if tp is None or kv_whole else tp.group
            (kq, ks), (vq, vs) = (quantize_kv(t[:, 0], group) for t in (k, v))
            for name, new in (("k", kq), ("v", vq), ("k_s", ks),
                              ("v_s", vs)):
                _write_rows(cache[name], new, lengths, offset)
            dt = cfg.activation_dtype
            k_cache = dequantize_kv(cache["k"], cache["k_s"], dt)
            v_cache = dequantize_kv(cache["v"], cache["v_s"], dt)
        else:
            _write_rows(cache["k"], k[:, 0], lengths, offset)
            _write_rows(cache["v"], v[:, 0], lengths, offset)
            k_cache, v_cache = cache["k"], cache["v"]
        k_cache, v_cache = heads(k_cache), heads(v_cache)
        new_cache = cache
        if seq_shard is None:
            out = decode_attention(q, k_cache, v_cache, lengths,
                                   window=desc.window,
                                   softcap=cfg.logit_softcap)
        else:
            # a windowed layer: the reference's decode_attention over the
            # whole cache, here the same keys' partials over the ranks
            cap = cfg.logit_softcap if desc.window else 0.0
            out = flash_decode(q, k_cache, v_cache, lengths, offset=offset,
                               group=seq_shard[0], window=desc.window,
                               softcap=cap)
    else:
        raise ValueError(mode)
    out = out.reshape(b, s, hq_loc * hd) @ params["wo"]
    if tp is not None:
        out = reduce_from_model(out, tp.group)
    return out, new_cache


# ---------------------------------------------------------------------------
# MLA (MiniCPM3 / DeepSeek-style multi-head latent attention).
# ---------------------------------------------------------------------------

def mla_specs(cfg: ArchConfig) -> dict[str, PSpec]:
    d, h = cfg.d_model, cfg.n_heads
    ql, kl = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    return {
        "wq_a": PSpec((d, ql), ("embed", "q_lora")),
        "q_norm": PSpec((ql,), (None,), init="zeros"),
        "wq_b": PSpec((ql, h * (dn + dr)), ("q_lora", "heads")),
        "wkv_a": PSpec((d, kl + dr), ("embed", None)),
        "kv_norm": PSpec((kl,), (None,), init="zeros"),
        "wkv_b": PSpec((kl, h * (dn + dv)), ("kv_lora", "heads")),
        "wo": PSpec((h * dv, d), ("heads", "embed")),
    }


def _lora_norm(q: torch.Tensor, scale: torch.Tensor, eps: float,
               parts: int) -> torch.Tensor:
    """``q_norm``'s RMS norm of the q latent, over the whole ``q_lora``
    (``parts``: the model ranks its columns are split over, which the
    norm's statistics do not follow)."""
    return rms_norm(q, scale, eps)


def mla_apply(params, x, cfg: ArchConfig, desc: BlockDesc, *, positions,
              mode: str = "train", cache=None, lengths=None,
              attn_impl: str = "flash", seq_shard: tuple | None = None,
              tp=None):
    """Returns (out, new_cache).

    q: ``wq_a`` → ``rms_norm(q_norm)`` → ``wq_b``, split per head into
    ``qk_nope`` and ``qk_rope`` dims; ``wkv_a`` gives the latent ``c_kv``
    (normed by ``kv_norm``) and one ``k_rope`` shared by the heads; RoPE
    over ``qk_rope`` at ``desc.rope_theta``.

    ``train`` / ``prefill``: ``c_kv @ wkv_b`` expanded to per-head
    ``k_nope`` and ``v``, the broadcast ``k_rope`` concatenated onto
    ``k_nope``, then causal attention of q·k head dim ``qk_nope +
    qk_rope`` and value head dim ``v_head_dim``: ``attn_impl="flash"``
    through :func:`flash_attention` (masked by index), any other through
    :func:`naive_attention` (masked by positions), as the reference's two
    branches.  ``prefill`` also returns the cache ``{"ckv", "krope"}``.
    ``decode``: the absorbed form.  This token's ``c_kv`` and ``k_rope``
    are written into ``cache`` *in place* at row ``lengths``; the scores
    are ``(q_nope·W_uk)·ckv + q_rope·krope`` in f32 times ``(qk_nope +
    qk_rope)**-0.5`` over the keys at indices up to ``lengths``; ``p`` is
    cast to the cache's dtype and the output is ``(p·ckv)·W_uv``.

    ``tp`` with ``params`` the rank's blocks (``wq_a``'s columns and
    ``wq_b``'s rows split on ``q_lora``, ``wkv_b``'s columns and ``wo``'s
    rows on the heads): the rank runs its padded heads
    (:func:`_padded_heads`, every head where none is split), the q latent
    from the gathered ``wq_a`` and ``wq_b`` (``q_norm``'s RMS over the
    whole ``q_lora``), the kv latent whole, ``wo``'s partials summed over
    the group.  ``seq_shard`` (``(data group, index)``): the cache holds
    the rows ``index·T_loc + 0..T_loc-1``, written by their owner, and
    the decode's softmax is each rank's partial max, denominator and
    latent numerator ``p·ckv`` combined over the group, then ``W_uv``."""
    b, s, _ = x.shape
    d, h = cfg.d_model, cfg.n_heads
    ql, kl = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    dq = dn + dr
    whole = {"wq_a": (d, ql), "wq_b": (ql, h * dq),
             "wkv_b": (kl, h * (dn + dv)), "wo": (h * dv, d)}
    if tp is not None and all(tuple(params[k].shape) == v
                              for k, v in whole.items()):
        tp = None           # no leaf split: the layer runs whole
    if tp is None:
        lo, n, per = 0, h, h
    else:
        lo, n, per = _padded_heads(h, tp)
        x = collectives.sum_grad(x, tp.group, "model", f32=True)

    def part(name, shape, dim=0, first=0, stop=None):
        return leaf_part(params[name], shape, tp, dim, first,
                         shape[dim] if stop is None else stop)

    q = _lora_norm(x @ part("wq_a", (d, ql), 1), part("q_norm", (ql,)),
                   cfg.norm_eps, 1 if tp is None else tp.size)
    q = q @ part("wq_b", (ql, h * dq), 1, lo * dq, (lo + n) * dq)
    q = q.reshape(b, s, n, dq)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    kv_a = x @ part("wkv_a", (d, kl + dr), 1)
    c_kv = rms_norm(kv_a[..., :kl], part("kv_norm", (kl,)), cfg.norm_eps)
    k_rope = kv_a[..., kl:]                      # (b, s, dr), shared heads
    cos, sin = rope_angles(positions, dr, desc.rope_theta)
    q_rope = apply_rope(q_rope, cos, sin)
    k_rope = apply_rope(k_rope[:, :, None, :], cos, sin)[:, :, 0]
    wkv_b = part("wkv_b", (kl, h * (dn + dv)), 1, lo * (dn + dv),
                 (lo + n) * (dn + dv))

    new_cache = None
    if mode in ("train", "prefill"):
        kv = (c_kv @ wkv_b).reshape(b, s, n, dn + dv)
        k_nope, v = kv[..., :dn], kv[..., dn:]
        k = torch.cat([k_nope, k_rope[:, :, None, :].expand(b, s, n, dr)],
                      dim=-1)
        qf = torch.cat([q_nope, q_rope], dim=-1)
        qf, k, v = (_pad_to(t, per) for t in (qf, k, v))
        if attn_impl == "flash":
            out = flash_attention(qf, k, v, causal=True)
        else:
            out = naive_attention(qf, k, v, positions, positions,
                                  causal=True)
        out = _real_heads(out, n)
        if mode == "prefill":
            new_cache = {"ckv": c_kv, "krope": k_rope}
    elif mode == "decode":
        w_b = wkv_b.reshape(kl, n, dn + dv)
        w_uk, w_uv = w_b[..., :dn], w_b[..., dn:]
        q_lat = torch.einsum("bshn,khn->bshk", q_nope, w_uk)  # (b,1,n,kl)
        ckv, krope = cache["ckv"], cache["krope"]
        offset = None if seq_shard is None else seq_shard[1] * ckv.shape[1]
        _write_rows(ckv, c_kv[:, 0], lengths, offset)
        _write_rows(krope, k_rope[:, 0], lengths, offset)
        new_cache = cache
        sc = (torch.einsum("bshk,btk->bhst", q_lat.float(), ckv.float())
              + torch.einsum("bshr,btr->bhst", q_rope.float(),
                             krope.float()))
        sc = sc * (dn + dr) ** -0.5
        ok = (offset or 0) + torch.arange(ckv.shape[1], device=x.device)[
            None] <= lengths[:, None]
        sc = torch.where(ok[:, None, None], sc, NEG_INF)
        if seq_shard is None:
            pr = torch.softmax(sc, dim=-1).to(ckv.dtype)
            o_lat = torch.einsum("bhst,btk->bshk", pr, ckv)  # (b,1,n,kl)
        else:
            m = sc.amax(dim=-1)
            p = torch.exp(sc - m[..., None])
            num = torch.einsum("bhst,btk->bhsk", p.to(ckv.dtype).float(),
                               ckv.float())
            o_lat = flash_decode_combine(m[None], p.sum(dim=-1)[None],
                                         num[None], seq_shard[0])
            o_lat = o_lat.permute(0, 2, 1, 3).to(ckv.dtype)
        out = torch.einsum("bshk,khv->bshv", o_lat, w_uv)
    else:
        raise ValueError(mode)
    out = out.reshape(b, s, n * dv) @ part("wo", (h * dv, d), 0, lo * dv,
                                           (lo + n) * dv)
    if tp is not None:
        out = reduce_from_model(out, tp.group)
    return out, new_cache
