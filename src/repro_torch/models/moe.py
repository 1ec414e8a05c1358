"""Mixture-of-experts layer (the port of ``repro.models.moe``): top-k
routing within groups of tokens, expert buffers of a fixed capacity, the
load-balance and router z-losses.  ``olmoe-1b-7b`` (64 experts, top-8)
and ``llama4-scout-17b-a16e`` (16 experts, top-1, one shared expert)
route through here.

:func:`moe_apply` computes the reference's function with its dispatch
done by index: each (token, slot) pair that its expert's buffer keeps
has one place in it, so the reference's one-hot dispatch and combine
contractions, each with a single non-zero term, are a gather of rows
into the ``(E, G·C, D)`` buffers and a gather of the k outputs back.
Both directions of :class:`_TakeRows` are gathers over unique indices,
so the backward is deterministic (a replayed train step is the same
step bit for bit).  The experts run as one batched product per weight
over all their buffers, empty rows included, as the reference's einsums
do.  :func:`moe_apply_plain` is the reference's one-hot einsums
transcribed: the yardstick of the tests and ``chip_smoke.py``, never the
main path.

Reference rules kept as they are: groups of ``min(group_size, B·S)``
tokens, batch-major, must divide the tokens (a ``ValueError`` where the
reference asserts); the router logits are rounded to the activation
dtype before the f32 softmax; of tied probabilities the lower expert
index wins (``jax.lax.top_k``'s order; ``torch.topk`` breaks ties
otherwise on the CPU); the gates are renormalised by ``max(sum,
1e-9)``; the capacity is ``max(1, int(Sg·k·cf/E))``; a pair's place in
its expert's buffer is its rank among the group's pairs in flat
(token, slot) order, and a pair at or past the capacity is dropped; the
outputs are weighted by the gates rounded to the activation dtype.  A
decode step's slots, idle ones included, form one group.

On a mesh (``tp``: the ``model`` group, ``data``: the ``data`` group
over which the batch's rows are split) the experts are split over
``model`` (a rank holds ``E/m`` of them, ``wi``/``wg``/``wo`` on dim 0)
and the activations are whole on every model rank: every rank routes the
same tokens to the same bits, fills and runs only its own experts'
buffers, combines its own pairs' outputs (the others' are zero), and the
combine is summed over ``model`` in f32.  The routing groups are the
reference's, a reshape of the global batch's tokens: where a data rank's
rows make whole groups it routes them alone; else (a decode step's
slots, one group across the ranks) the router's logits are gathered over
``data``, every rank routes the whole group, and each dispatches its own
rows' pairs.  The load-balance loss is ``E·Σ me·ce`` of the global
batch, ``me`` and ``ce`` summed over ``data`` before the product; the
z-loss is averaged over ``data``.  Each data rank's aux gradient is
``D`` times its rows' share, as ``loss_fn``'s.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.common import PSpec
from repro_torch.models.mlp import mlp_apply, mlp_specs
from repro_torch.sharding import collectives
from repro_torch.sharding.collectives import reduce_from_model

__all__ = ["DEFAULT_GROUP", "Routing", "moe_specs", "moe_apply",
           "moe_apply_plain", "router_logits", "expert_capacity", "top_k",
           "route", "route_rows", "route_plain"]

DEFAULT_GROUP = 256


def moe_specs(cfg: ArchConfig) -> dict[str, PSpec]:
    d, e, f = cfg.d_model, cfg.n_experts, cfg.expert_d_ff
    specs = {
        "router": PSpec((d, e), ("embed", None), scale=0.02),
        "wi": PSpec((e, d, f), ("expert", "embed", "expert_mlp")),
        "wg": PSpec((e, d, f), ("expert", "embed", "expert_mlp")),
        "wo": PSpec((e, f, d), ("expert", "expert_mlp", "embed")),
    }
    if cfg.n_shared_experts:
        shared = mlp_specs(cfg, "swiglu",
                           d_ff=cfg.expert_d_ff * cfg.n_shared_experts)
        specs.update({f"shared_{k}": v for k, v in shared.items()})
    return specs


class Routing(NamedTuple):
    """A group-wise routing: ``probs`` (G, Sg, E) f32; ``idx`` (G, Sg, k)
    the experts, best first; ``gates`` (G, Sg, k) f32, renormalised;
    ``pos`` (G, Sg, k) each pair's place in its expert's buffer;
    ``keep`` (G, Sg, k) ``pos < capacity``."""
    probs: torch.Tensor
    idx: torch.Tensor
    gates: torch.Tensor
    pos: torch.Tensor
    keep: torch.Tensor


def _groups(x: torch.Tensor, group_size: int, ranks: int = 1
            ) -> tuple[int, int]:
    """(G, Sg) of ``x`` (B, S, D), or of ``ranks`` such row blocks one
    after another (the data ranks' rows): groups of ``min(group_size,
    B·S)`` tokens, which must divide the tokens."""
    t = x.shape[0] * x.shape[1] * ranks
    sg = min(group_size, t)
    if t % sg:
        raise ValueError(
            f"MoE routing groups of {sg} tokens do not divide the "
            f"{t} tokens of a ({x.shape[0] * ranks}, {x.shape[1]}) batch: "
            f"B·S must be at most {group_size} or a multiple of it (the "
            f"reference asserts t % group_size == 0)")
    return t // sg, sg


def router_logits(params, xt: torch.Tensor) -> torch.Tensor:
    """(G, Sg, D) → (G, Sg, E): the router product in the activation
    dtype, rounded to it, then widened to f32."""
    return (xt @ params["router"].to(xt.dtype)).float()


def expert_capacity(sg: int, k: int, cf: float, e: int) -> int:
    return max(1, int(sg * k * cf / e))


def top_k(probs: torch.Tensor, k: int) -> torch.Tensor:
    """The indices of the ``k`` largest of the last dim, largest first;
    of equal values the lower index first (``jax.lax.top_k``'s order): a
    stable descending sort."""
    return torch.sort(probs, dim=-1, descending=True, stable=True
                      ).indices[..., :k]


def _positions(idx: torch.Tensor, e: int) -> torch.Tensor:
    """Each (token, slot) pair's rank among the earlier pairs of its
    group, in flat (token, slot) order, that chose the same expert."""
    g, sg, k = idx.shape
    onehot = F.one_hot(idx.reshape(g, sg * k), e)
    earlier = onehot.cumsum(dim=1) - onehot
    return earlier.gather(-1, idx.reshape(g, sg * k, 1)).reshape(g, sg, k)


def route(logits: torch.Tensor, k: int, capacity: int) -> Routing:
    """The reference's routing of f32 ``logits`` (G, Sg, E)."""
    probs = torch.softmax(logits, dim=-1)
    idx = top_k(probs, k)
    gates = probs.gather(-1, idx)
    gates = gates / gates.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    pos = _positions(idx, logits.shape[-1])
    return Routing(probs, idx, gates, pos, pos < capacity)


class _TakeRows(torch.autograd.Function):
    """``out[i] = src[take[i]]``, a zero row where ``take[i] < 0``; each
    row of ``src`` is read by at most ``m`` rows of ``out``, listed in
    ``readers`` (rows of ``src`` × m; -1 for none).  The backward sums,
    for each row of ``src``, its readers' gradients in the listed order:
    both directions are gathers, with no atomic accumulation."""

    @staticmethod
    def forward(ctx, src, take, readers):
        ctx.save_for_backward(take, readers)
        ctx.n_out = take.shape[0]
        pad = torch.cat([src, src.new_zeros((1,) + src.shape[1:])])
        return pad[torch.where(take < 0, src.shape[0], take)]

    @staticmethod
    def backward(ctx, grad):
        take, readers = ctx.saved_tensors
        pad = torch.cat([grad, grad.new_zeros((1,) + grad.shape[1:])])
        rows = pad[torch.where(readers < 0, ctx.n_out, readers)]
        return rows.sum(dim=1), None, None


def _dispatch_indices(r, groups: int, capacity: int,
                      experts: tuple[int, int]):
    """The buffers' rows, ``(E_loc, groups, C)`` flat, of the experts
    ``experts = (first, count)``: ``r`` the :class:`_Rows` of T tokens.
    Returns ``slot_of_pair`` (T·k,) each pair's row (-1: dropped, or
    another rank's expert), ``pair_of_slot`` (E_loc·groups·C,) each row's
    pair (-1 empty) and ``mine`` (T, k) the pairs kept in these
    experts' buffers."""
    e0, e_loc = experts
    mine = r.keep & (r.idx >= e0) & (r.idx < e0 + e_loc)
    slot = ((r.idx - e0) * groups + r.group[:, None]) * capacity + r.pos
    slot_of_pair = torch.where(mine, slot, -1).reshape(-1)
    n = e_loc * groups * capacity
    # a dropped pair writes the extra last row, which is cut off
    pair_of_slot = torch.full((n + 1,), -1, dtype=torch.long,
                              device=slot.device)
    pair_of_slot.scatter_(0, torch.where(slot_of_pair < 0, n, slot_of_pair),
                          torch.arange(slot_of_pair.numel(),
                                       device=slot.device))
    return slot_of_pair, pair_of_slot[:n], mine


def _shared(params, dtype: torch.dtype) -> dict:
    """The shared expert's SwiGLU weights, in ``dtype``."""
    return {k[7:]: v.to(dtype) for k, v in params.items()
            if k.startswith("shared_")}


def _load_balance(me: torch.Tensor, ce: torch.Tensor, e: int, data
                  ) -> torch.Tensor:
    """``E·Σ me·ce`` (f32) of the global batch from this rank's ``me`` (the
    mean router probability of each expert) and ``ce`` (its share of the
    top-k choices) over its rows: on ``data`` both are averaged over the
    ranks before the product; the gradient is the rank's rows' times
    ``D``."""
    if data is None:
        return e * (me * ce).sum()
    n = data.size
    me_g = collectives.all_reduce(me.detach(), data.group, "data") / n
    ce_g = collectives.all_reduce(ce, data.group, "data") / n
    return e * ((me_g + (me - me.detach())) * ce_g).sum()


def _aux(r, logits: torch.Tensor, e: int, k: int, data=None) -> dict:
    """The load-balance loss (over the top-k choices before the
    capacity), the router z-loss and each expert's share of the choices,
    in f32, over ``r``'s and ``logits``' tokens (any leading shape); on
    ``data`` (the rows split over its ranks) those of the global batch
    (:func:`_load_balance`; the z-loss averaged over the ranks)."""
    probs = r.probs.reshape(-1, e)
    t = probs.shape[0]
    me = probs.mean(dim=0)
    # each expert's count of choices: a bincount of e bins (a sum of
    # integers, exact in any order), shaped without reading the indices
    idx = r.idx.reshape(-1)
    ce = torch.zeros(e, dtype=torch.int64, device=idx.device).scatter_add_(
        0, idx.long(), torch.ones_like(idx, dtype=torch.int64)).float() \
        / (t * k)
    z = torch.logsumexp(logits.reshape(-1, e), dim=-1).square().mean()
    lb = _load_balance(me, ce, e, data)
    if data is not None:
        n = data.size
        ce = collectives.all_reduce(ce, data.group, "data") / n
        z = collectives.all_reduce(z.detach(), data.group, "data") / n \
            + (z - z.detach())
    return {"load_balance_loss": lb, "router_z_loss": z, "expert_load": ce}


class _Rows(NamedTuple):
    """A routing of T tokens flat: ``probs`` (T, E), ``idx``/``gates``/
    ``pos``/``keep`` (T, k) as :class:`Routing`'s, ``group`` (T,) each
    token's group among the buffers'."""
    probs: torch.Tensor
    idx: torch.Tensor
    gates: torch.Tensor
    pos: torch.Tensor
    keep: torch.Tensor
    group: torch.Tensor


def route_rows(logits: torch.Tensor, k: int, capacity: int, sg: int,
               data=None) -> tuple[_Rows, int]:
    """The routing of this rank's tokens (``logits`` (T, E) f32, T = its
    B·S) in groups of ``sg`` of the global batch's tokens, and the count
    of groups its buffers hold.  Where ``sg`` divides T the rank's groups
    are its own; else (``data``: the group spans ranks) the logits are
    gathered over ``data`` and every group routed, the rank taking its
    own tokens' rows of the routing (their places counted among the
    whole group's pairs) and the gates computed from its own logits."""
    t, e = logits.shape
    if t % sg == 0:
        r = route(logits.reshape(t // sg, sg, e), k, capacity)
        group = torch.arange(t, device=logits.device) // sg
        return _Rows(r.probs.reshape(t, e), *(
            v.reshape(t, k) for v in (r.idx, r.gates, r.pos, r.keep)),
            group), t // sg
    with torch.no_grad():
        every = collectives.all_gather(logits, 0, data.group, "data")
        r = route(every.reshape(-1, sg, e), k, capacity)
    own = slice(data.index * t, (data.index + 1) * t)
    idx, pos, keep = (v.reshape(-1, k)[own] for v in (r.idx, r.pos, r.keep))
    probs = torch.softmax(logits, dim=-1)
    gates = probs.gather(-1, idx)
    gates = gates / gates.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    group = (data.index * t + torch.arange(t, device=logits.device)) // sg
    return _Rows(probs, idx, gates, pos, keep, group), every.shape[0] // sg


def moe_apply(params, x: torch.Tensor, cfg: ArchConfig, *,
              capacity_factor: float | None = None,
              group_size: int = DEFAULT_GROUP, tp=None, data=None):
    """x (B, S, D) → (y (B, S, D), aux): aux ``{"load_balance_loss",
    "router_z_loss", "expert_load"}``, f32.  The weights compute in
    ``x``'s dtype (``forward`` hands them over cast to it).  ``tp`` and
    ``data`` (``TensorGroup``s) run it on a mesh (module docstring):
    ``params`` the rank's blocks, ``x`` its rows."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    cf = capacity_factor or cfg.capacity_factor
    _, sg = _groups(x, group_size, 1 if data is None else data.size)
    flat = x.reshape(b * s, d)
    logits = router_logits(params, flat)
    capacity = expert_capacity(sg, k, cf, e)
    r, groups = route_rows(logits, k, capacity, sg, data)
    e_loc = params["wi"].shape[0]
    tp_e = tp if e_loc < e else None
    first = 0 if tp_e is None else tp_e.index * e_loc
    slot_of_pair, pair_of_slot, mine = _dispatch_indices(
        r, groups, capacity, (first, e_loc))
    src, gates = flat, r.gates
    if tp_e is not None:
        # each rank's use of the tokens and of the gates is its experts'
        src = collectives.sum_grad(flat, tp_e.group, "model", f32=True)
        gates = collectives.sum_grad(gates, tp_e.group, "model", f32=True)

    # each buffer row reads its pair's token; a token's k pairs read it
    # (an empty row's -1 floors to -1)
    buf = _TakeRows.apply(
        src, pair_of_slot.div(k, rounding_mode="floor"),
        slot_of_pair.reshape(b * s, k)).reshape(e_loc, groups * capacity, d)
    w = {n: params[n].to(x.dtype) for n in ("wi", "wg", "wo")}
    h = F.silu(torch.bmm(buf, w["wg"])) * torch.bmm(buf, w["wi"])
    ye = torch.bmm(h, w["wo"]).reshape(e_loc * groups * capacity, d)
    out = _TakeRows.apply(ye, slot_of_pair, pair_of_slot[:, None])
    weights = (gates.to(x.dtype) * mine).float().reshape(b * s, k, 1)
    y = (out.reshape(b * s, k, d).float() * weights).sum(dim=1)
    if tp_e is not None:
        y = reduce_from_model(y, tp_e.group)
    y = y.to(x.dtype)

    if cfg.n_shared_experts:
        shared = _shared(params, x.dtype)
        whole = cfg.expert_d_ff * cfg.n_shared_experts
        y = y + mlp_apply(shared, flat, "swiglu",
                          tp if shared["wo"].shape[0] < whole else None)
    return y.reshape(b, s, d), _aux(r, logits, e, k, data)


# ---------------------------------------------------------------------------
# The plain form: the reference's one-hot contractions.
# ---------------------------------------------------------------------------

def route_plain(logits: torch.Tensor, k: int, capacity: int) -> Routing:
    """:func:`route` by the reference's one-hot arithmetic, its top-k by
    ``k`` rounds of ``argmax`` (which returns the first of equal
    maxima)."""
    e = logits.shape[-1]
    probs = torch.softmax(logits, dim=-1)
    left, picks = probs.clone(), []
    for _ in range(k):
        i = left.argmax(dim=-1)
        picks.append(i)
        left.scatter_(-1, i[..., None], float("-inf"))
    idx = torch.stack(picks, dim=-1)
    gates = probs.gather(-1, idx)
    gates = gates / torch.maximum(gates.sum(dim=-1, keepdim=True),
                                  gates.new_tensor(1e-9))
    g, sg, _ = idx.shape
    onehot = F.one_hot(idx, e)                             # (G,Sg,k,E)
    flat = onehot.reshape(g, sg * k, e)
    pos_in = (flat.cumsum(dim=1) - flat).reshape(g, sg, k, e)
    pos = (pos_in * onehot).sum(dim=-1)
    return Routing(probs, idx, gates, pos, pos < capacity)


def moe_apply_plain(params, x: torch.Tensor, cfg: ArchConfig, *,
                    capacity_factor: float | None = None,
                    group_size: int = DEFAULT_GROUP,
                    logits: torch.Tensor | None = None):
    """:func:`moe_apply` by the reference's one-hot dispatch and combine
    einsums, in ``x``'s dtype.  ``logits`` (G, Sg, E) f32, if given,
    take the router's place (to compute at a wider dtype from the
    routing of a narrower one)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    cf = capacity_factor or cfg.capacity_factor
    g, sg = _groups(x, group_size)
    dt = x.dtype
    xt = x.reshape(g, sg, d)
    if logits is None:
        logits = router_logits(params, xt)
    capacity = expert_capacity(sg, k, cf, e)
    r = route_plain(logits, k, capacity)
    disp_k = (F.one_hot(r.idx, e).to(dt)[..., None]
              * F.one_hot(r.pos.clamp_max(capacity - 1) * r.keep,
                          capacity).to(dt)[..., None, :]
              * r.keep[..., None, None].to(dt))            # (G,Sg,k,E,C)
    combine = (disp_k * r.gates[..., None, None].to(dt)).sum(dim=2)
    disp = disp_k.sum(dim=2)
    xe = torch.einsum("gsec,gsd->gecd", disp, xt)
    w = {n: params[n].to(dt) for n in ("wi", "wg", "wo")}
    h = F.silu(torch.einsum("gecd,edf->gecf", xe, w["wg"])) * \
        torch.einsum("gecd,edf->gecf", xe, w["wi"])
    ye = torch.einsum("gecf,efd->gecd", h, w["wo"])
    y = torch.einsum("gsec,gecd->gsd", combine, ye)
    if cfg.n_shared_experts:
        y = y + mlp_apply(_shared(params, dt), xt.reshape(g * sg, d),
                          "swiglu").reshape(g, sg, d)
    return y.reshape(b, s, d), _aux(r, logits, e, k)
