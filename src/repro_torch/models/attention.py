"""Attention of the LLM stack: GQA/MQA/MHA with RoPE and a KV cache (the
port of ``repro.models.attention`` for dense, causal, un-windowed
configs).

* :func:`flash_attention` — train and prefill attention.  On the card it
  launches the hand-written kernel (``kernels/csrc/flash_attention.cu``,
  the port of the Pallas ``_fa_kernel``); on the CPU its plain version.
  Either is differentiable (``FlashAttentionFn``: the backward
  recomputes attention in plain PyTorch).  Positions are the indices
  ``0..S-1`` (the only ones this slice takes).
* :func:`naive_attention` — the full-matrix reference, selected by
  ``attn_impl="naive"``.
* :func:`decode_attention` — one-token attention over the static-size
  cache with a length mask, plain PyTorch (the reference computes it
  outside any Pallas kernel).

Not ported (``models/transformer.py`` refuses the configs that need
them): sliding-window and chunked attention, logit soft-capping, MLA,
``flash_decode`` over a sharded cache, the int8 cache and the mesh
constraints.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig, BlockDesc
from repro_torch.kernels.flash_attention import (FlashAttentionFn,
                                                 flash_attention_cuda,
                                                 flash_attention_plain)
from repro_torch.models.common import PSpec, apply_rope, rope_angles

__all__ = ["attention_specs", "attention_apply", "flash_attention",
           "naive_attention", "decode_attention"]

NEG_INF = -1e30


def _mask(q_pos: torch.Tensor, k_pos: torch.Tensor, *,
          causal: bool) -> torch.Tensor:
    """(B,S,T) validity mask from absolute positions.

    q_pos: (B,S) int; k_pos: (B,T) or (T,).  A negative k_pos marks
    padding."""
    if k_pos.ndim == 1:
        k_pos = k_pos[None]
    d = q_pos[:, :, None] - k_pos[:, None, :]
    m = torch.ones(d.shape, dtype=torch.bool, device=d.device)
    if causal:
        m &= d >= 0
    m &= k_pos[:, None, :] >= 0
    return m


def naive_attention(q, k, v, q_pos, k_pos, *,
                    causal: bool = True) -> torch.Tensor:
    """Reference full-matrix attention.  q (B,S,Hq,hd), k/v (B,T,Hk,hd).
    Scores and softmax in f32; the probabilities are cast to v's dtype
    before ``p·v``, as the reference."""
    b, s, hq, hd = q.shape
    hk = k.shape[2]
    hv = v.shape[-1]
    qg = q.reshape(b, s, hk, hq // hk, hd)
    scores = torch.einsum("bsgrh,btgh->bgrst", qg.float(), k.float())
    scores = scores * hd ** -0.5
    mask = _mask(q_pos, k_pos, causal=causal)
    scores = torch.where(mask[:, None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bgrst,btgh->bsgrh", probs, v)
    return out.reshape(b, s, hq, hv)


def flash_attention(q, k, v, *, causal: bool = True) -> torch.Tensor:
    """Blocked online-softmax attention at positions ``0..S-1`` /
    ``0..T-1``.  q (B,S,Hq,hd), k/v (B,T,Hk,hd): GQA is expanded to MHA
    (``repeat_interleave`` over heads, the reference's head order; its
    backward sums dk and dv over the repeats), then the kernel runs on a
    CUDA tensor and its plain version on a CPU one, each looked up here
    at call time, through :class:`FlashAttentionFn`."""
    rep = q.shape[2] // k.shape[2]
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    attend = flash_attention_cuda if q.is_cuda else flash_attention_plain
    return FlashAttentionFn.apply(q, k, v, causal, attend)


def decode_attention(q, k_cache, v_cache, lengths) -> torch.Tensor:
    """One-token attention over a static-size cache.

    q: (B,1,Hq,hd); caches (B,T,Hk,hd); lengths (B,) = index of the
    current token (the cache already holds it at ``lengths``).  Scores
    and softmax in f32, ``p`` cast to the cache's dtype."""
    b, _, hq, hd = q.shape
    t, hk = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(b, 1, hk, hq // hk, hd)
    sc = torch.einsum("bsgrh,btgh->bgrst", qg.float(), k_cache.float())
    sc = sc * hd ** -0.5
    ok = torch.arange(t, device=q.device)[None] <= lengths[:, None]
    sc = torch.where(ok[:, None, None, None], sc, NEG_INF)
    pr = torch.softmax(sc, dim=-1).to(v_cache.dtype)
    out = torch.einsum("bgrst,btgh->bsgrh", pr, v_cache)
    return out.reshape(b, 1, hq, hd).to(q.dtype)


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


def attention_apply(params, x, cfg: ArchConfig, desc: BlockDesc, *,
                    positions, mode: str = "train", cache=None,
                    lengths=None, attn_impl: str = "flash"):
    """Returns (out, new_cache).

    ``train``: attention over the sequence, no cache.  ``prefill``: the
    same, and the cache ``{"k", "v"}`` of the un-expanded heads.
    ``decode``: writes this token's k/v into ``cache`` *in place* at row
    ``lengths`` of each sequence (the reference returns an updated
    copy), then attends over the cache; returns the same cache."""
    b, s, _ = x.shape
    hq, hk = cfg.n_heads, cfg.n_kv_heads
    hd = cfg.resolved_head_dim
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if cfg.qkv_bias:
        q = q + params["bq"].to(q.dtype)
        k = k + params["bk"].to(k.dtype)
        v = v + params["bv"].to(v.dtype)
    q = q.reshape(b, s, hq, hd)
    k = k.reshape(b, s, hk, hd)
    v = v.reshape(b, s, hk, hd)
    cos, sin = rope_angles(positions, hd, desc.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    new_cache = None
    if mode in ("train", "prefill"):
        if attn_impl == "flash":
            out = flash_attention(q, k, v, causal=cfg.causal)
        elif attn_impl == "naive":
            out = naive_attention(q, k, v, positions, positions,
                                  causal=cfg.causal)
        else:
            raise ValueError(f"unknown attn_impl {attn_impl!r}")
        if mode == "prefill":
            new_cache = {"k": k, "v": v}
    elif mode == "decode":
        rows = torch.arange(b, device=x.device)
        cache["k"][rows, lengths] = k[:, 0].to(cache["k"].dtype)
        cache["v"][rows, lengths] = v[:, 0].to(cache["v"].dtype)
        new_cache = cache
        out = decode_attention(q, cache["k"], cache["v"], lengths)
    else:
        raise ValueError(mode)
    out = out.reshape(b, s, hq * hd) @ params["wo"]
    return out, new_cache
