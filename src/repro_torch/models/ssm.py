"""Mamba2 mixer (the port of ``repro.models.ssm``): the chunked SSD
(state-space duality) form for train and prefill, and the one-token
recurrence for decode.  ``mamba2-2.7b``'s blocks and the SSM half of
``hymba-1.5b``'s hybrid blocks run through here.

The sequence is cut into chunks of :data:`CHUNK` tokens (the tail padded
with zeros).  Within a chunk the recurrence is a masked, decay-weighted
contraction, quadratic in the chunk; across chunks a ``(B, H, P, N)``
state carries the prefix.  :func:`_ssd_chunked` computes every chunk's
intra-chunk terms at once (they do not depend on the carried state) and
runs only the state recurrence chunk by chunk; each element's
arithmetic is the reference's.  :func:`ssd_chunked_plain` is the
reference's loop over chunks transcribed, and
:func:`ssm_recurrence_plain` the token-by-token recurrence of
:func:`ssm_decode_step` over a whole sequence: the yardsticks of the
tests and ``chip_smoke.py``, never the main path.  The reference has no
Pallas kernel here, and the port's mixer is plain PyTorch.

Reference rules kept as they are:

* the products of the SSD are summed in f32 (the reference's
  ``preferred_element_type=jnp.float32`` on bf16 ``B`` and ``C``): the
  operands are widened to f32 first, so the products are exact; ``x·dt``
  and the inclusive cumsum of ``dt·A`` are f32 too;
* the upper triangle of the decay matrix is set to -inf *before* the
  ``exp``: masked after it, the entries overflow to inf and the
  gradient through the mask is ``inf·0 = NaN``;
* the depthwise causal conv (width ``W``) keeps a cache of the last
  ``W-1`` raw inputs (pre-conv, pre-activation); its four taps are
  shifted products summed in f32, rounded once to the activation dtype,
  then the bias is added in that dtype, then SiLU;
* the output is gated as ``y · silu(z in f32)`` rounded to ``y``'s dtype,
  then RMS-normed;
* ``dt = softplus(dt_raw + dt_bias)`` in f32 (PyTorch's softplus returns
  its input above 20, where the two differ by less than e^-20
  relative).

At float64 inputs (the plain yardsticks on the card) every f32 of the
above is float64.

On a ``model`` axis (``tp``, a ``TensorGroup``) a rank runs its block of
the SSM heads, ``A_log``'s: heads ``r·H/m + 0..H/m-1`` of model rank
``r``, with their ``x``, ``z`` and ``dt`` columns, ``D``, ``dt_bias``,
their part of the SSD and of the state, and ``norm``'s and
``out_proj``'s rows of them (their blocks in the rules' layout);
``B`` and ``C`` (``ssm_groups`` 1) are whole on every rank.  The rules
cut ``in_proj``'s packed ``z | x | B | C | dt`` columns and ``conv_w``,
``conv_b`` and the ``conv`` cache's ``x | B | C`` channels into
contiguous blocks that do not follow the heads: the masters, the
checkpoints and the cache keep that layout, and the rank's compute copy
is cut from the leaves gathered over ``model``
(``collectives.leaf_part``: the backward sums the ranks' cotangents into
each block).  The gated RMSNorm's mean of squares is over the whole
``d_inner``, its partial sums added over ``model`` in f32; ``out_proj``
is row-parallel, summed by ``reduce_from_model``.  The decode step
gathers the ``conv`` cache's blocks, runs the conv over every channel
and writes back the rank's block.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.common import PSpec, rms_norm
from repro_torch.sharding import collectives
from repro_torch.sharding.collectives import leaf_part, reduce_from_model

__all__ = ["CHUNK", "ssm_specs", "ssm_apply", "ssm_decode_step",
           "ssd_chunked_plain", "ssm_recurrence_plain", "init_state"]

CHUNK = 256


def _dims(cfg: ArchConfig):
    di = cfg.ssm_d_inner
    h = cfg.ssm_heads
    p = cfg.ssm_head_dim
    g = cfg.ssm_groups
    n = cfg.ssm_state
    conv_dim = di + 2 * g * n
    return di, h, p, g, n, conv_dim


def _acc(dtype: torch.dtype) -> torch.dtype:
    """The dtype of the sums: f32, or float64 for float64 inputs."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def ssm_specs(cfg: ArchConfig) -> dict[str, PSpec]:
    d = cfg.d_model
    di, h, p, g, n, conv_dim = _dims(cfg)
    w = cfg.ssm_conv
    return {
        "in_proj": PSpec((d, 2 * di + 2 * g * n + h), ("embed", "ssm_inner")),
        "conv_w": PSpec((w, conv_dim), (None, "ssm_conv_dim")),
        "conv_b": PSpec((conv_dim,), ("ssm_conv_dim",), init="zeros"),
        "A_log": PSpec((h,), ("ssm_heads",), init="ones"),
        "D": PSpec((h,), ("ssm_heads",), init="ones"),
        "dt_bias": PSpec((h,), ("ssm_heads",), init="zeros"),
        "norm": PSpec((di,), ("ssm_inner",), init="zeros"),
        "out_proj": PSpec((di, d), ("ssm_inner", "embed")),
    }


def init_state(cfg: ArchConfig, batch: int, dtype: torch.dtype,
               device, lead: tuple[int, ...] = ()) -> dict:
    """A zero cache ``{"h": f32 (*lead, batch, H, P, N), "conv": (*lead,
    batch, W-1, conv_dim) in dtype}`` (``h`` float64 for float64)."""
    _, h, p, _, n, conv_dim = _dims(cfg)
    return {"h": torch.zeros(lead + (batch, h, p, n), dtype=_acc(dtype),
                             device=device),
            "conv": torch.zeros(lead + (batch, cfg.ssm_conv - 1, conv_dim),
                                dtype=dtype, device=device)}


def _causal_conv(xbc, conv_w, conv_b, cache=None):
    """Depthwise causal conv1d of xbc (B, L, C) with conv_w (W, C).
    Returns (out, new_cache), the cache the last W-1 inputs."""
    w, l = conv_w.shape[0], xbc.shape[1]
    if cache is not None:
        xfull = torch.cat([cache.to(xbc.dtype), xbc], dim=1)
    else:
        xfull = F.pad(xbc, (0, 0, w - 1, 0))
    new_cache = xfull[:, xfull.shape[1] - (w - 1):]
    acc = _acc(xbc.dtype)
    wide = xfull.to(acc)
    taps = conv_w.to(xbc.dtype).to(acc)
    out = wide[:, :l] * taps[0]
    for k in range(1, w):
        out = out + wide[:, k:k + l] * taps[k]
    out = out.to(xbc.dtype) + conv_b.to(xbc.dtype)
    return F.silu(out), new_cache


def _pad_and_chunk(x, dt, B, C, chunk):
    """x·dt (in the sums' dtype), dt, B and C padded to whole chunks and
    cut into them: (B, nc, Q, ...)."""
    b, l = x.shape[:2]
    q = min(chunk, l)
    nc = -(-l // q)
    pad = nc * q - l
    xdt = x * dt[..., None]
    out = []
    for t in (xdt, dt, B, C):
        if pad:
            t = F.pad(t, (0, 0) * (t.ndim - 2) + (0, pad))
        out.append(t.reshape((b, nc, q) + t.shape[2:]))
    return out, q, nc


def _ssd_chunked(x, dt, A, B, C, D, h0=None, chunk=CHUNK):
    """Chunked SSD core: x (B,L,H,P); dt (B,L,H); A (H,) (negative);
    B, C (B,L,G,N); D (H,).  Returns (y (B,L,H,P) in x's dtype, h_final
    (B,H,P,N) in the sums' dtype)."""
    b, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    r = h // g
    acc = _acc(x.dtype)
    (xdt, dtc, Bc, Cc), q, nc = _pad_and_chunk(x, dt, B, C, chunk)
    xdt, Bc, Cc = xdt.to(acc), Bc.to(acc), Cc.to(acc)
    cum = torch.cumsum(dtc.to(acc) * A, dim=2)        # (B,nc,Q,H) inclusive
    # intra-chunk; mask BEFORE exp
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]    # (B,nc,i,j,H)
    tri = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    lm = torch.exp(torch.where(tri[:, :, None], seg, float("-inf")))
    scores = torch.einsum("bcign,bcjgn->bcgij", Cc, Bc)
    m = lm.reshape(b, nc, q, q, g, r) * \
        scores.permute(0, 1, 3, 4, 2)[..., None]
    y_in = torch.einsum("bcijgr,bcjgrp->bcigrp", m,
                        xdt.reshape(b, nc, q, g, r, p))
    del seg, lm, m
    # each chunk's state update, then the recurrence across chunks
    decay_end = torch.exp(cum[:, :, -1:, :] - cum)            # (B,nc,Q,H)
    dxg = (xdt * decay_end[..., None]).reshape(b, nc, q, g, r, p)
    h_add = torch.einsum("bcjgrp,bcjgn->bcgrpn", dxg, Bc
                         ).reshape(b, nc, h, p, n)
    decay_chunk = torch.exp(cum[:, :, -1, :])[..., None, None]
    hprev = torch.zeros((b, h, p, n), dtype=acc, device=x.device) \
        if h0 is None else h0
    inbound = []
    for c in range(nc):
        inbound.append(hprev)
        hprev = hprev * decay_chunk[:, c] + h_add[:, c]
    # the inbound state's contribution, decayed by exp(cum)
    hs = torch.stack(inbound, dim=1).reshape(b, nc, g, r, p, n)
    y_st = torch.einsum("bcign,bcgrpn->bcigrp", Cc, hs)
    y_st = y_st * torch.exp(cum).reshape(b, nc, q, g, r)[..., None]
    y = (y_in + y_st).reshape(b, nc * q, h, p)[:, :l]
    y = y + x * D[:, None]
    return y.to(x.dtype), hprev


def ssd_chunked_plain(x, dt, A, B, C, D, h0=None, chunk=CHUNK):
    """The reference's ``_ssd_chunked`` transcribed: one chunk at a time,
    its intra-chunk terms and its state update in the loop's body (the
    yardstick of :func:`_ssd_chunked`)."""
    b, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    r = h // g
    acc = _acc(x.dtype)
    (xdt, dtc, Bc, Cc), q, nc = _pad_and_chunk(x, dt, B, C, chunk)
    hprev = torch.zeros((b, h, p, n), dtype=acc, device=x.device) \
        if h0 is None else h0
    tri = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    ys = []
    for c in range(nc):
        xd, dtk = xdt[:, c].to(acc), dtc[:, c]
        bk, ck = Bc[:, c].to(acc), Cc[:, c].to(acc)
        cum = torch.cumsum(dtk.to(acc) * A, dim=1)
        seg = cum[:, :, None, :] - cum[:, None, :, :]
        lm = torch.exp(torch.where(tri[None, :, :, None], seg,
                                   float("-inf")))
        scores = torch.einsum("bign,bjgn->bgij", ck, bk)
        y_in = torch.einsum("bgij,bijgr,bjgrp->bigrp", scores,
                            lm.reshape(b, q, q, g, r),
                            xd.reshape(b, q, g, r, p))
        y_st = torch.einsum("bign,bgrpn->bigrp", ck,
                            hprev.reshape(b, g, r, p, n))
        y_st = y_st * torch.exp(cum).reshape(b, q, g, r)[..., None]
        ys.append((y_in + y_st).reshape(b, q, h, p))
        decay_end = torch.exp(cum[:, -1:, :] - cum)
        dxg = (xd * decay_end[..., None]).reshape(b, q, g, r, p)
        h_add = torch.einsum("bjgrp,bjgn->bgrpn", dxg, bk)
        hprev = hprev * torch.exp(cum[:, -1, :])[:, :, None, None] + \
            h_add.reshape(b, h, p, n)
    y = torch.cat(ys, dim=1)[:, :l] + x * D[:, None]
    return y.to(x.dtype), hprev


def _norm_over_model(y: torch.Tensor, scale: torch.Tensor, eps: float,
                     width: int, tp) -> torch.Tensor:
    """:func:`rms_norm` of the rank's channels ``y`` of a ``width``-wide
    vector split over ``tp``'s group: the mean of squares over all of
    them (the partial sums added over the group in f32)."""
    if tp is None:
        return rms_norm(y, scale, eps)
    dt = y.dtype
    yf = y.float()
    ss = collectives.model_sum(yf.square().sum(dim=-1, keepdim=True),
                               tp.group)
    return (yf * torch.rsqrt(ss / width + eps)
            * (1.0 + scale.float())).to(dt)


def _gate_out(params, y, z, cfg: ArchConfig, tp=None, heads=None):
    """``rms_norm(y · silu(z in f32) rounded to y's dtype) @ out_proj``;
    with ``tp`` over the rank's ``heads`` (first, count) of ``d_inner``,
    summed over the group."""
    di, _, p, *_ = _dims(cfg)
    gate = F.silu(z.to(_acc(z.dtype))).to(y.dtype)
    lo, hi = (0, di) if heads is None else (heads[0] * p,
                                            (heads[0] + heads[1]) * p)
    norm = leaf_part(params["norm"], (di,), tp, 0, lo, hi)
    out = _norm_over_model(y * gate, norm, cfg.norm_eps, di, tp) @ \
        leaf_part(params["out_proj"], (di, cfg.d_model), tp, 0, lo, hi)
    return out if tp is None else reduce_from_model(out, tp.group)


def _heads(params, cfg: ArchConfig, tp):
    """``(tp, (first head, heads))`` of this rank's SSM heads: its block
    of ``A_log``'s, or every head (and no group) where they are whole."""
    h_loc = params["A_log"].shape[0]
    if tp is None or h_loc == cfg.ssm_heads:
        return None, (0, cfg.ssm_heads)
    return tp, (tp.index * h_loc, h_loc)


def _local(params, cfg: ArchConfig, tp, heads):
    """The rank's compute copy: ``(in_proj``'s columns ``z | x | B | C |
    dt`` of its heads, ``conv_w``/``conv_b``'s channels ``x | B | C`` of
    them, ``A_log``, ``D``, ``dt_bias``)."""
    di, h, p, g, n, conv_dim = _dims(cfg)
    d = cfg.d_model
    if tp is None:
        return (params["in_proj"], params["conv_w"], params["conv_b"],
                params["A_log"], params["D"], params["dt_bias"])
    h0, hl = heads
    width = 2 * di + 2 * g * n + h
    w = collectives.leaf_whole(params["in_proj"], (d, width), tp)
    cw = collectives.leaf_whole(params["conv_w"], (cfg.ssm_conv, conv_dim),
                                tp)
    cb = collectives.leaf_whole(params["conv_b"], (conv_dim,), tp)
    x0, x1 = h0 * p, (h0 + hl) * p
    proj = torch.cat([w[:, x0:x1], w[:, di + x0:di + x1],
                      w[:, 2 * di:2 * di + 2 * g * n],
                      w[:, 2 * di + 2 * g * n + h0:
                        2 * di + 2 * g * n + h0 + hl]], dim=1)
    conv_w = torch.cat([cw[:, x0:x1], cw[:, di:]], dim=1)
    conv_b = torch.cat([cb[x0:x1], cb[di:]])
    small = tuple(leaf_part(params[k], (h,), tp, 0, h0, h0 + hl)
                  for k in ("A_log", "D", "dt_bias"))
    return (proj, conv_w, conv_b) + small


def _split_local(zxbcdt, cfg: ArchConfig, hl: int):
    """``(z, xBC, dt_raw)`` of the rank's projection over ``hl`` heads."""
    _, _, p, g, n, _ = _dims(cfg)
    return torch.split(zxbcdt, [hl * p, hl * p + 2 * g * n, hl], dim=-1)


def _conv_block(t: torch.Tensor, conv_dim: int, tp) -> torch.Tensor:
    """This rank's block of the ``conv`` cache's channels (the rules'
    layout: ``conv_dim`` split evenly where the axis divides it)."""
    if tp is None or conv_dim % tp.size:
        return t
    c = conv_dim // tp.size
    return t.narrow(-1, tp.index * c, c)


def ssm_apply(params, x, cfg: ArchConfig, *, mode: str = "train", tp=None):
    """Full-sequence Mamba2 mixer of x (B, L, D).  Returns (out,
    new_cache): at ``mode="prefill"`` the cache ``{"h": (B, H, P, N) f32,
    "conv": (B, W-1, conv_dim)}``, else None.  ``tp``: over the rank's
    heads (module docstring), the cache its block of ``h`` and of the
    ``conv`` channels."""
    b, l, _ = x.shape
    di, h, p, g, n, conv_dim = _dims(cfg)
    acc = _acc(x.dtype)
    tp, heads = _heads(params, cfg, tp)
    hl = heads[1]
    if tp is not None:
        x = collectives.sum_grad(x, tp.group, "model", f32=True)
    proj, conv_w, conv_b, a_log, d_, dt_bias = _local(params, cfg, tp, heads)
    z, xbc, dt_raw = _split_local(x @ proj, cfg, hl)
    xbc, conv_cache = _causal_conv(xbc, conv_w, conv_b)
    xi, B, C = torch.split(xbc, [hl * p, g * n, g * n], dim=-1)
    dt = F.softplus(dt_raw.to(acc) + dt_bias.to(acc))
    A = -torch.exp(a_log.to(acc))
    y, h_final = _ssd_chunked(xi.reshape(b, l, hl, p), dt, A,
                              B.reshape(b, l, g, n), C.reshape(b, l, g, n),
                              d_.to(acc))
    out = _gate_out(params, y.reshape(b, l, hl * p), z, cfg, tp, heads)
    if mode != "prefill":
        return out, None
    if tp is not None:
        # the conv cache in the rules' layout: the last W-1 raw inputs of
        # every channel, the rank's block of them
        w = collectives.leaf_whole(params["in_proj"],
                                   (cfg.d_model, 2 * di + 2 * g * n + h), tp)
        tail = x[:, max(0, l - cfg.ssm_conv + 1):] @ w[:, di:2 * di
                                                       + 2 * g * n]
        tail = F.pad(tail, (0, 0, cfg.ssm_conv - 1 - tail.shape[1], 0))
        conv_cache = _conv_block(tail, conv_dim, tp)
    return out, {"h": h_final, "conv": conv_cache}


def ssm_decode_step(params, x, cfg: ArchConfig, cache: dict, tp=None):
    """The one-token recurrent update of x (B, 1, D): ``h ← h·exp(dt·A)
    + dt·x⊗B``, ``y = C·h + D·x``.  Writes the new ``h`` and ``conv``
    into ``cache`` in place and returns (out, cache).  ``tp``: the rank's
    heads and its blocks of the cache (module docstring)."""
    b = x.shape[0]
    di, h, p, g, n, conv_dim = _dims(cfg)
    tp, heads = _heads(params, cfg, tp)
    hl = heads[1]
    r = hl // g
    acc = _acc(x.dtype)
    proj, conv_w, conv_b, a_log, d_, dt_bias = _local(params, cfg, tp, heads)
    z, xbc, dt_raw = _split_local(x @ proj, cfg, hl)
    if tp is None:
        xbc, conv_cache = _causal_conv(xbc, conv_w, conv_b,
                                       cache=cache["conv"])
    else:
        # every channel's conv from the gathered cache blocks, the rank's
        # heads' channels kept and its block of the new cache written
        width = 2 * di + 2 * g * n + h
        w = collectives.leaf_whole(params["in_proj"], (cfg.d_model, width),
                                   tp)
        whole = cache["conv"] if cache["conv"].shape[-1] == conv_dim else \
            collectives.all_gather(cache["conv"], 2, tp.group, "model")
        full, conv_cache = _causal_conv(
            x @ w[:, di:2 * di + 2 * g * n],
            collectives.leaf_whole(params["conv_w"],
                                   (cfg.ssm_conv, conv_dim), tp),
            collectives.leaf_whole(params["conv_b"], (conv_dim,), tp),
            cache=whole)
        x0, x1 = heads[0] * p, (heads[0] + hl) * p
        xbc = torch.cat([full[..., x0:x1], full[..., di:]], dim=-1)
        conv_cache = _conv_block(conv_cache, conv_dim, tp)
    xi, B, C = torch.split(xbc, [hl * p, g * n, g * n], dim=-1)
    xi = xi.reshape(b, hl, p)
    B = B.reshape(b, g, n).to(acc)
    C = C.reshape(b, g, n).to(acc)
    dt = F.softplus(dt_raw.to(acc) + dt_bias.to(acc))[:, 0]
    A = -torch.exp(a_log.to(acc))
    xdt = (xi * dt[..., None]).to(acc).reshape(b, g, r, p)
    h_add = (xdt[..., None] * B[:, :, None, None, :]).reshape(b, hl, p, n)
    h_new = cache["h"] * torch.exp(dt * A)[:, :, None, None] + h_add
    y = torch.einsum("bgn,bgrpn->bgrp", C, h_new.reshape(b, g, r, p, n))
    y = y.reshape(b, hl, p) + xi.to(acc) * d_[:, None].to(acc)
    y = y.reshape(b, 1, hl * p).to(x.dtype)
    cache["h"].copy_(h_new)
    cache["conv"].copy_(conv_cache)
    return _gate_out(params, y, z, cfg, tp, heads), cache


def ssm_recurrence_plain(params, x, cfg: ArchConfig):
    """The mixer of x (B, L, D) token by token through
    :func:`ssm_decode_step` from a zero cache (``h`` f32, or float64 for
    float64 inputs): the recurrence the chunked SSD computes in blocks.
    Returns (out, {"h", "conv"}) as ``ssm_apply(mode="prefill")``."""
    cache = init_state(cfg, x.shape[0], x.dtype, x.device)
    outs = [ssm_decode_step(params, x[:, t:t + 1], cfg, cache)[0]
            for t in range(x.shape[1])]
    return torch.cat(outs, dim=1), cache
