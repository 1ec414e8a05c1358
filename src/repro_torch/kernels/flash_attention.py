"""Forward flash attention (the port of ``repro.kernels.flash_attention``).

:func:`flash_attention_cuda` launches one of two hand-written CUDA C++
kernels, both ports of ``_fa_kernel`` / ``flash_attention_pallas``,
chosen by :func:`kernel_variant` from the dtype and the head dims alone
(``dk`` of q and k, ``dv`` of v):

* ``"wgmma"`` (``csrc/flash_attention_sm90.cu``): bf16 at hd 64, 80,
  128 and 256 and at MLA's split pair (dk, dv) = (96, 64), both products
  on the tensor cores (``p`` split into two bf16 terms for ``p·v``), q,
  k and v fed by TMA;
* ``"ffma"`` (``csrc/flash_attention.cu``): f32 storage, bf16 at hd 8-32,
  and f32 at the split pairs of :data:`SPLIT_HEAD_DIMS` and bf16 at (48,
  32), on the FP32 units.  It is built for bf16 hd 64, 80 and (96, 64)
  too, which :func:`flash_attention_ffma` launches when called directly
  (the yardsticks of the wgmma instances).

:func:`flash_attention_plain` computes the same function in plain
PyTorch on any device, over the same q and kv tiles, with the same
causal live-block bound and the same tail masks, so the CPU tests
exercise the kernels' indexing.  :func:`flash_attention_meta` is the
card's launch as the dry-run sees it on ``meta`` tensors: the same
launcher's checks and an output of the kernel's shape, with no data,
reported with the kernel's cost rule (:func:`flash_cost`: the FLOPs of
the tiles it computes, those the mask keeps, and its bytes).

Layout contract: ``q (B, S, H, dk)``, ``k (B, T, H, dk)`` and ``v (B,
T, H, dv)`` (MHA: expand GQA first), float32 or bfloat16, the head dim
contiguous; the output ``(B, S, H, dv)`` is of q's dtype (the Pallas
kernel reads ``dv`` from v too).  Scores, the online softmax, ``p`` and
the accumulator are f32; q is scaled by ``dk**-0.5`` in f32 before
``q·kᵀ`` (the wgmma kernel scales the f32 scores, the same up to f32
rounding); masked scores are ``-1e30`` and the output is
``acc / max(l, 1e-30)``.  The causal mask is ``i >= j`` on indices,
aligned top-left.  Unlike the Pallas kernel, S and T need not be
multiples of the tiles: the tails are masked.

``softcap`` > 0 soft-caps the scaled scores to ``softcap·tanh(s /
softcap)`` before the mask (Gemma's logit soft-capping: the reference's
``flash_attention(..., softcap=)``, which the Pallas kernel does not
take).  Each kernel has it as a template flag, so the instances at
``softcap=0`` are the code they were without it; a call at 0 passes no
``softcap`` on to the function it calls.

:class:`FlashAttentionFn` makes either forward differentiable.  The
Pallas kernel has no backward (the reference differentiates its jnp
attention), so neither has the port's kernels: the backward recomputes
attention from the saved q, k, v in plain PyTorch
(:func:`recompute_attention`, the function of the reference's
``naive_attention``) and differentiates that.
"""

from __future__ import annotations

import ctypes
import functools

import torch

__all__ = ["HEAD_DIMS", "SPLIT_HEAD_DIMS", "VARIANTS", "BLOCK_Q",
           "kernel_variant", "kernel_tiles", "kernel_block_k",
           "check_tma_operand",
           "flash_attention_plain", "flash_attention_cuda",
           "flash_attention_ffma", "flash_attention_wgmma",
           "flash_attention_meta", "flash_cost", "recompute_attention",
           "FlashAttentionFn"]

NEG_INF = -1e30
# the head dims flash_attention_cuda takes with dk == dv: the FFMA kernel
# (csrc/flash_attention.cu) is built for all of them in f32 and for those
# up to 80 in bf16, the wgmma kernel for bf16 at 64, 80, 128 and 256
# (80: HuBERT-XLarge's 16 heads over d_model 1280)
HEAD_DIMS = (8, 16, 32, 64, 80, 128, 256)
# the (dk, dv) pairs with dk != dv: MiniCPM3-4B's MLA (qk_nope 64 +
# qk_rope 32 against v_head_dim 64) and its tiny preset's (32 + 16
# against 32)
SPLIT_HEAD_DIMS = ((96, 64), (48, 32))
BLOCK_Q = 64
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# (dtype, dk, dv) the wgmma kernel is built for, and its tiles
# (csrc/flash_attention_sm90.cu: kBQ, Sm90Tiles<DK, DV>::BK)
WGMMA_TILES = {(torch.bfloat16, 64, 64): (128, 128),
               (torch.bfloat16, 80, 80): (128, 64),
               (torch.bfloat16, 128, 128): (128, 64),
               (torch.bfloat16, 256, 256): (128, 64),
               (torch.bfloat16, 96, 64): (128, 128)}
WGMMA_GEOMETRIES = frozenset(WGMMA_TILES)
WGMMA_BLOCK_Q = 128
# (dtype, dk, dv) the FFMA kernel is built for: f32 at every head dim,
# bf16 up to 80, both dtypes at the split pairs
FFMA_GEOMETRIES = frozenset(
    [(torch.float32, d, d) for d in HEAD_DIMS]
    + [(torch.bfloat16, d, d) for d in HEAD_DIMS if d <= 80]
    + [(dt, dk, dv) for dt in _DTYPE_CODES for dk, dv in SPLIT_HEAD_DIMS])
# the bytes TMA needs strides and addresses to be multiples of
_TMA_ALIGN = 16
_INT32_MAX = 2 ** 31 - 1
# (dtype, dk, dv) -> the kernel that takes it: the variant table, the
# wgmma kernel wherever it is built
VARIANTS = {g: "wgmma" if g in WGMMA_GEOMETRIES else "ffma"
            for g in sorted(FFMA_GEOMETRIES | WGMMA_GEOMETRIES, key=str)}


def kernel_variant(dtype: torch.dtype, dk: int, dv: int | None = None
                   ) -> str:
    """The kernel that :func:`flash_attention_cuda` launches for ``dtype``
    at q·k head dim ``dk`` and value head dim ``dv`` (default ``dk``):
    ``"wgmma"`` or ``"ffma"``.  Raises on what neither kernel takes."""
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"flash attention takes float32 or bfloat16, got "
                        f"{dtype}")
    dv = dk if dv is None else dv
    variant = VARIANTS.get((dtype, dk, dv))
    if variant is None:
        raise ValueError(f"flash_attention_cuda is built for head dims "
                         f"{HEAD_DIMS} (dk == dv) and the (dk, dv) pairs "
                         f"{SPLIT_HEAD_DIMS}, got dk {dk}, dv {dv}")
    return variant


def kernel_tiles(dtype: torch.dtype, dk: int, dv: int | None = None
                 ) -> tuple[int, int]:
    """(q rows, kv rows) of the tiles of the kernel that runs ``dtype``
    at head dims ``dk`` and ``dv`` (default ``dk``): :data:`WGMMA_TILES`
    where the wgmma kernel runs it, else the FFMA kernel's ``kBQ`` and
    ``Tiles<DK, DV>::BK``."""
    dv = dk if dv is None else dv
    return WGMMA_TILES.get((dtype, dk, dv),
                           (BLOCK_Q, 64 if max(dk, dv) <= 64 else 32))


def kernel_block_k(hd: int, dtype: torch.dtype, dv: int | None = None
                   ) -> int:
    """The kv tile of the kernel that runs ``dtype`` at head dims ``hd``
    (q·k) and ``dv`` (default ``hd``)."""
    return kernel_tiles(dtype, hd, dv)[1]


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"flash attention takes q (B,S,H,dk), k "
                         f"(B,T,H,dk) and v (B,T,H,dv), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, s, h, d = q.shape
    if k.shape[2] != h:
        raise ValueError(f"k has {k.shape[2]} heads and q {h}: expand GQA "
                         f"to MHA before the kernel")
    if (k.shape[0], k.shape[3]) != (b, d) or v.shape[:3] != k.shape[:3]:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} disagree")
    if min(b, s, h, d, k.shape[1], v.shape[3]) <= 0:
        raise ValueError("flash attention needs non-empty operands")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"flash attention takes float32 or bfloat16 q, k "
                        f"and v of one dtype, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")


def _check_softcap(softcap: float) -> None:
    if not softcap >= 0:
        raise ValueError(f"softcap is 0 (none) or the cap, got {softcap}")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, *, causal: bool = True,
                          softcap: float = 0.0,
                          block_q: int | None = None,
                          block_k: int | None = None) -> torch.Tensor:
    """The kernels' function in plain PyTorch, tile by tile: per q tile
    of ``block_q`` rows, an online softmax over the kv tiles of
    ``block_k`` rows (default: those of the kernel that runs q's dtype
    at its head dims) up to the causal live-block bound.  q is scaled by
    ``dk**-0.5``, the accumulator is ``dv`` wide; ``p`` stays f32.  Runs
    on any device."""
    _check(q, k, v)
    _check_softcap(softcap)
    b, s, h, d = q.shape
    t, dv = k.shape[1], v.shape[3]
    tile_q, tile_k = kernel_tiles(q.dtype, d, dv)
    block_q = block_q or tile_q
    block_k = block_k or tile_k
    qf = q.float() * d ** -0.5
    kf, vf = k.float(), v.float()
    out = q.new_empty((b, s, h, dv))
    n_kv = -(-t // block_k)
    for q0 in range(0, s, block_q):
        qt = qf[:, q0:q0 + block_q]
        qpos = torch.arange(q0, q0 + qt.shape[1], device=q.device)
        m = torch.full((b, h, qt.shape[1]), NEG_INF, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((b, h, qt.shape[1], dv), device=q.device)
        n_live = (min((q0 + block_q + block_k - 1) // block_k, n_kv)
                  if causal else n_kv)
        for k0 in range(0, n_live * block_k, block_k):
            kt, vt = kf[:, k0:k0 + block_k], vf[:, k0:k0 + block_k]
            sc = torch.einsum("bqhd,bkhd->bhqk", qt, kt)
            if softcap:
                sc = softcap * torch.tanh(sc / softcap)
            if causal:
                kpos = torch.arange(k0, k0 + kt.shape[1], device=q.device)
                sc = torch.where(qpos[:, None] >= kpos[None], sc, NEG_INF)
            m_new = torch.maximum(m, sc.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(sc - m_new[..., None])
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd",
                                                        p, vt)
            m = m_new
        o = acc / torch.clamp_min(l, 1e-30)[..., None]
        out[:, q0:q0 + block_q] = o.transpose(1, 2).to(q.dtype)
    return out


def check_tma_operand(name: str, a: torch.Tensor) -> tuple[int, ...]:
    """The element strides (batch, position, head) under which the wgmma
    kernel's TMA reads or writes operand ``a`` (B, rows, H, hd) of bf16:
    the head dim contiguous, the other strides and the address multiples
    of 16 bytes.  A dim of extent 1 is never stepped over, so its stride
    is taken as a contiguous tensor's.  Raises ValueError naming the
    operand; needs no card."""
    shape, stride = a.shape, a.stride()
    if stride[3] != 1:
        raise ValueError(f"flash_attention_cuda takes a contiguous head dim "
                         f"({name} has stride {stride[3]})")
    size = a.element_size()
    dense = (shape[1] * shape[2] * shape[3], shape[2] * shape[3], shape[3])
    strides = tuple(st if n > 1 else d
                    for n, st, d in zip(shape[:3], stride[:3], dense))
    for dim, st in zip(("batch", "position", "head"), strides):
        if (st * size) % _TMA_ALIGN:
            raise ValueError(f"the wgmma kernel reads {name} by TMA, whose "
                             f"strides are multiples of {_TMA_ALIGN} bytes: "
                             f"{name}'s {dim} stride is {st * size} bytes")
    if a.data_ptr() % _TMA_ALIGN:
        raise ValueError(f"the wgmma kernel reads {name} by TMA, which needs "
                         f"a {_TMA_ALIGN}-byte aligned address: {name} "
                         f"starts at {a.data_ptr():#x}")
    return strides


@functools.cache
def _library(variant: str):
    from repro_torch.kernels.build import load
    if variant == "ffma":
        fn = load("flash_attention").flash_attention_fwd
        # q, k, v, out, dtype, B, H, S, T, dk, dv, strides, causal,
        # scale, softcap, stream
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [
            ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_float,
            ctypes.c_float, ctypes.c_void_p]
    else:
        fn = load("flash_attention_sm90").flash_attention_sm90_fwd
        # q, k, v, out, B, H, S, T, dk, dv, strides, causal, scale,
        # softcap, stream
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
            ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_float,
            ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_device(q, k, v, softcap: float, device_type: str) -> None:
    """The operands' checks of a launch on a ``device_type`` device
    (``"cuda"``; ``"meta"`` for :func:`flash_attention_meta`)."""
    _check(q, k, v)
    _check_softcap(softcap)
    dev = q.device
    for a in (q, k, v):
        if a.device != dev or a.device.type != device_type:
            where = "CUDA" if device_type == "cuda" else device_type
            raise ValueError(f"flash_attention_cuda takes tensors on one "
                             f"{where} device, got {a.device} beside {dev}")
        if a.stride(-1) != 1:
            raise ValueError("flash_attention_cuda takes a contiguous "
                             "head dim")


def _launch_error(err: int, variant: str) -> RuntimeError:
    if variant == "wgmma" and err == -1:
        why = "the driver has no cuTensorMapEncodeTiled"
    elif variant == "wgmma" and err < 0:
        operand = ("q", "k", "v", "out")[-err // 1000 - 1]
        why = f"encoding the TMA map of {operand} failed: CUresult " \
              f"{-err % 1000}"
    else:
        why = f"CUDA error {err}"
    return RuntimeError(f"flash_attention_cuda ({variant} kernel) launch "
                        f"failed: {why}")


def _ffma_prepare(q, k, v, softcap: float, device_type: str
                  ) -> torch.Tensor:
    """The FFMA launch's checks, raising where the kernel cannot run the
    call, and its output (allocated on q's device)."""
    kernel_variant(q.dtype, q.shape[-1], v.shape[-1])  # raises off the table
    if (q.dtype, q.shape[-1], v.shape[-1]) not in FFMA_GEOMETRIES:
        raise ValueError(f"the FFMA kernel is not built for {q.dtype} at "
                         f"head dim {q.shape[-1]}: the wgmma kernel takes it")
    _check_device(q, k, v, softcap, device_type)
    b, s, h, d = q.shape
    dv = v.shape[3]
    if -(-s // BLOCK_Q) > 65535:
        raise ValueError(f"S = {s} needs more than 65535 q tiles")
    out = torch.empty((b, s, h, dv), dtype=q.dtype, device=q.device)
    for a in (q, k, v, out):
        last = sum((n - 1) * st for n, st in zip(a.shape, a.stride()))
        if last > _INT32_MAX:
            raise ValueError("flash_attention_cuda indexes with 32-bit "
                             "offsets; split the batch")
    return out


def flash_attention_ffma(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         softcap: float = 0.0) -> torch.Tensor:
    """Launch the FFMA kernel (``csrc/flash_attention.cu``) on the current
    stream, without synchronising: float32 at every head dim of
    :data:`HEAD_DIMS`, bfloat16 at those up to 80 (the wgmma kernel takes
    bfloat16 at 128 and 256), and both at the (dk, dv) pairs of
    :data:`SPLIT_HEAD_DIMS` (:data:`FFMA_GEOMETRIES`; bfloat16 hd 64, 80
    and (96, 64) run here only when called directly:
    :func:`flash_attention_cuda` takes them to the wgmma kernel).  Each
    launch adds one to ``flash_attention_ffma.launches`` and to
    ``flash_attention_ffma.launches_by_geometry[(dtype, dk, dv)]``."""
    out = _ffma_prepare(q, k, v, softcap, "cuda")
    b, s, h, d = q.shape
    t, dv = k.shape[1], v.shape[3]
    dev = q.device
    strides = (ctypes.c_int * 12)(*(st for a in (q, k, v, out)
                                    for st in a.stride()[:3]))
    fn = _library("ffma")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 _DTYPE_CODES[q.dtype], b, h, s, t, d, dv, strides,
                 int(causal), float(d ** -0.5), float(softcap), stream)
    if err != 0:
        raise _launch_error(err, "ffma")
    flash_attention_ffma.launches += 1
    geometry = (q.dtype, d, dv)
    by_geometry = flash_attention_ffma.launches_by_geometry
    by_geometry[geometry] = by_geometry.get(geometry, 0) + 1
    return out


def _wgmma_prepare(q, k, v, softcap: float, device_type: str
                   ) -> tuple[torch.Tensor, list]:
    """The wgmma launch's checks, raising where the kernel cannot run
    the call, its output (allocated on q's device) and the TMA strides
    of q, k, v and the output."""
    geometry = (q.dtype, q.shape[-1], v.shape[-1])
    if geometry not in WGMMA_GEOMETRIES:
        elsewhere = (": it runs on the FFMA kernel (flash_attention_ffma)"
                     if geometry in FFMA_GEOMETRIES else "")
        raise ValueError(f"the wgmma kernel takes bfloat16 at head dims "
                         f"64, 80, 128 and 256 (dk == dv) and at (dk, dv) "
                         f"(96, 64), got {q.dtype} at dk {q.shape[-1]}, dv "
                         f"{v.shape[-1]}{elsewhere}")
    _check_device(q, k, v, softcap, device_type)
    b, s, h, d = q.shape
    dv = v.shape[3]
    if -(-s // WGMMA_BLOCK_Q) > 65535 or b * h > _INT32_MAX:
        raise ValueError(f"B*H = {b * h}, S = {s}: too large a grid")
    strides = [check_tma_operand(n, a) for n, a in (("q", q), ("k", k),
                                                    ("v", v))]
    out = torch.empty((b, s, h, dv), dtype=q.dtype, device=q.device)
    strides.append(check_tma_operand("out", out))
    return out, strides


def flash_attention_wgmma(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, *, causal: bool = True,
                          softcap: float = 0.0) -> torch.Tensor:
    """Launch the wgmma/TMA kernel (``csrc/flash_attention_sm90.cu``) on
    the current stream, without synchronising: bfloat16 at head dims 64,
    80, 128 and 256 (q, k and v) and at (dk, dv) = (96, 64) (q and k of
    96, v of 64; :data:`WGMMA_GEOMETRIES`), operands whose strides and
    addresses TMA takes (:func:`check_tma_operand`).  Each launch adds
    one to ``flash_attention_wgmma.launches`` and to
    ``flash_attention_wgmma.launches_by_geometry[(dtype, dk, dv)]``."""
    out, strides = _wgmma_prepare(q, k, v, softcap, "cuda")
    b, s, h, d = q.shape
    t, dv = k.shape[1], v.shape[3]
    geometry = (q.dtype, d, dv)
    dev = q.device
    c_strides = (ctypes.c_longlong * 12)(*(st for sts in strides
                                           for st in sts))
    fn = _library("wgmma")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 b, h, s, t, d, dv, c_strides, int(causal), float(d ** -0.5),
                 float(softcap), stream)
    if err != 0:
        raise _launch_error(err, "wgmma")
    flash_attention_wgmma.launches += 1
    by_geometry = flash_attention_wgmma.launches_by_geometry
    by_geometry[geometry] = by_geometry.get(geometry, 0) + 1
    return out


_LAUNCHERS = {"ffma": flash_attention_ffma, "wgmma": flash_attention_wgmma}


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         softcap: float = 0.0) -> torch.Tensor:
    """Launch the kernel that :func:`kernel_variant` picks for q's dtype
    and head dim, on the current stream (no synchronise).

    Takes q, k, v on one CUDA device, float32 or bfloat16, any strides
    with a contiguous head dim (the wgmma kernel: multiples of 16 bytes),
    head dims in :data:`VARIANTS`, and raises on anything else, and on a
    failed build or launch: there is no fallback.  The output is
    allocated here, contiguous.  Each launch adds one to
    ``flash_attention_cuda.launches`` and to the variant's own count;
    the variant's launcher checks the operands."""
    out = _LAUNCHERS[kernel_variant(q.dtype, q.shape[-1], v.shape[-1])](
        q, k, v, causal=causal, softcap=softcap)
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0
flash_attention_ffma.launches = 0
flash_attention_ffma.launches_by_geometry = {}
flash_attention_wgmma.launches = 0
flash_attention_wgmma.launches_by_geometry = {}


def _live_pairs(s: int, t: int, block_q: int, block_k: int,
               causal: bool) -> int:
    """The (query, key) pairs of the tiles a launch computes: each q
    tile of ``block_q`` rows against the kv tiles up to its causal
    live-block bound (every kv tile when not ``causal``), masked entries
    of a diagonal tile included, as :func:`flash_attention_plain`
    bounds them."""
    if not causal:
        return s * t
    n_kv = -(-t // block_k)
    pairs = 0
    for q0 in range(0, s, block_q):
        n_live = min((q0 + block_q + block_k - 1) // block_k, n_kv)
        pairs += min(block_q, s - q0) * min(n_live * block_k, t)
    return pairs


def _useful_pairs(s: int, t: int, causal: bool) -> int:
    """The (query, key) pairs the mask lets through: ``min(i + 1, T)``
    keys for query ``i`` when ``causal``, else all ``S·T``."""
    if not causal:
        return s * t
    m = min(s, t)
    return m * (m + 1) // 2 + (s - m) * t


def flash_cost(b: int, s: int, t: int, h: int, dk: int, dv: int,
               dtype: torch.dtype, causal: bool) -> dict:
    """The cost rule of one launch of the kernel that
    :func:`kernel_variant` picks for ``dtype`` at (``dk``, ``dv``), on
    q (B, S, H, dk), k (B, T, H, dk), v (B, T, H, dv): ``flops``
    2·(dk + dv)·B·H·:func:`_live_pairs` at its :func:`kernel_tiles`
    (what it computes), ``useful_flops`` the same over
    :func:`_useful_pairs` (what the mask keeps), and ``bytes`` q, k and v
    read once and the output written once."""
    bq, bk = kernel_tiles(dtype, dk, dv)
    per_pair = 2.0 * (dk + dv) * b * h
    size = torch.empty((), dtype=dtype).element_size()
    return {"flops": per_pair * _live_pairs(s, t, bq, bk, causal),
            "useful_flops": per_pair * _useful_pairs(s, t, causal),
            "bytes": float(size * b * h * (s * dk + t * dk + t * dv
                                           + s * dv))}


def flash_attention_meta(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         softcap: float = 0.0) -> torch.Tensor:
    """What :func:`flash_attention_cuda` does with ``meta`` tensors, for
    the dry-run: the same launcher's checks, so a call the card's kernel
    refuses raises here too (the variant table, the grid, TMA's strides
    for the wgmma kernel, 32-bit offsets for the FFMA one), and an
    output of the kernel's shape and dtype, with no data.  The launch is
    reported to the counts in progress (``utils.opcount.record_kernel``)
    with the kernel's cost rule (:func:`flash_cost`)."""
    from repro_torch.utils.opcount import record_kernel
    variant = kernel_variant(q.dtype, q.shape[-1], v.shape[-1])
    if variant == "wgmma":
        out, _ = _wgmma_prepare(q, k, v, softcap, "meta")
    else:
        out = _ffma_prepare(q, k, v, softcap, "meta")
    b, s, h, dk = q.shape
    t, dv = k.shape[1], v.shape[3]
    cost = flash_cost(b, s, t, h, dk, dv, q.dtype, causal)
    record_kernel(f"flash_attention_{variant}",
                  f"{str(q.dtype).removeprefix('torch.')}/{dk}/{dv}",
                  flops=cost["flops"], useful_flops=cost["useful_flops"],
                  nbytes=cost["bytes"])
    return out


def recompute_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        softcap: float = 0.0) -> torch.Tensor:
    """Attention as the reference differentiates it (its
    ``naive_attention``, which its ``flash_attention`` calls for T up to
    ``block_k``, and the same function blocked above): f32 scores scaled
    by ``dk**-0.5`` and softmax, ``p`` cast to v's dtype before ``p·v``.
    q (B, S, H, dk), k (B, T, H, dk), v (B, T, H, dv) → (B, S, H, dv);
    the scores soft-capped when ``softcap`` > 0; the causal mask is
    ``i >= j``, top-left.  Holds the (B, H, S, T) f32 scores whole: 537
    MB at B 2, H 16, S = T = 2048."""
    s, t, hd = q.shape[1], k.shape[1], q.shape[3]
    sc = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * hd ** -0.5
    if softcap:
        sc = softcap * torch.tanh(sc / softcap)
    if causal:
        keep = torch.ones((s, t), dtype=torch.bool, device=q.device).tril()
        sc = torch.where(keep, sc, NEG_INF)
    p = torch.softmax(sc, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v).to(q.dtype)


def _cap(softcap: float) -> dict:
    """The ``softcap`` keyword of a call: none at 0, so that a function
    written for the un-capped contract is called as before."""
    return {"softcap": softcap} if softcap else {}


class FlashAttentionFn(torch.autograd.Function):
    """``FlashAttentionFn.apply(q, k, v, causal, attend[, softcap])``:
    the forward is ``attend(q, k, v, causal=causal, softcap=softcap)``
    (the kernel's wrapper on the card, its plain version on the CPU;
    ``softcap`` passed only when > 0), and q, k, v are saved; the
    backward recomputes :func:`recompute_attention` from them, the
    soft-cap's ``tanh`` included, under ``torch.enable_grad()`` and
    differentiates it (looked up in this module at call time).  Under
    ``torch.no_grad()`` it is the forward alone."""

    @staticmethod
    def forward(ctx, q, k, v, causal, attend, softcap=0.0):
        ctx.causal, ctx.softcap = causal, softcap
        ctx.save_for_backward(q, k, v)
        return attend(q, k, v, causal=causal, **_cap(softcap))

    @staticmethod
    def backward(ctx, d_out):
        needs = ctx.needs_input_grad[:3]
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(n)
                      for t, n in zip(ctx.saved_tensors, needs)]
            out = recompute_attention(*inputs, causal=ctx.causal,
                                      **_cap(ctx.softcap))
            grads = iter(torch.autograd.grad(
                out, [t for t in inputs if t.requires_grad], d_out))
        # no gradient for causal, attend and softcap (autograd drops the
        # trailing None of a call that left softcap at its default)
        return (*(next(grads) if n else None for n in needs), None, None,
                None)
