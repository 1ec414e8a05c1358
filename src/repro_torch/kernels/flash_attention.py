"""Forward flash attention (the port of ``repro.kernels.flash_attention``).

:func:`flash_attention_cuda` launches the hand-written CUDA C++ kernel of
``csrc/flash_attention.cu``, the port of ``_fa_kernel`` /
``flash_attention_pallas``; :func:`flash_attention_plain` computes the
same function in plain PyTorch on any device, over the same q and kv
tiles, with the same causal live-block bound and the same tail masks,
so the CPU tests exercise the kernel's indexing.

Layout contract: ``q (B, S, H, hd)``, ``k`` and ``v`` ``(B, T, H, hd)``
(MHA: expand GQA first), float32 or bfloat16, the head dim contiguous;
the output ``(B, S, H, hd)`` is of q's dtype.  Scores, the online
softmax, ``p`` and the accumulator are f32; q is scaled by ``hd**-0.5``
in f32 before ``q·kᵀ``; masked scores are ``-1e30`` and the output is
``acc / max(l, 1e-30)``.  The causal mask is ``i >= j`` on indices,
aligned top-left.  Unlike the Pallas kernel, S and T need not be
multiples of the tiles: the tails are masked.
"""

from __future__ import annotations

import ctypes
import functools

import torch

__all__ = ["HEAD_DIMS", "BLOCK_Q", "kernel_block_k", "flash_attention_plain",
           "flash_attention_cuda"]

NEG_INF = -1e30
# the head dims the kernel is built for (csrc/flash_attention.cu)
HEAD_DIMS = (8, 16, 32, 64, 128, 256)
BLOCK_Q = 64
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_INT32_MAX = 2 ** 31 - 1


def kernel_block_k(hd: int) -> int:
    """The kernel's kv tile for head dim ``hd`` (``Tiles<D>::BK``)."""
    return 64 if hd <= 64 else 32


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"flash attention takes q (B,S,H,hd) and k/v "
                         f"(B,T,H,hd), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, s, h, d = q.shape
    if k.shape[2] != h:
        raise ValueError(f"k has {k.shape[2]} heads and q {h}: expand GQA "
                         f"to MHA before the kernel")
    if (k.shape[0], k.shape[3]) != (b, d) or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} disagree")
    if min(b, s, h, d, k.shape[1]) <= 0:
        raise ValueError("flash attention needs non-empty operands")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"flash attention takes float32 or bfloat16 q, k "
                        f"and v of one dtype, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, *, causal: bool = True,
                          block_q: int = BLOCK_Q,
                          block_k: int | None = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch, tile by tile: per q tile
    of ``block_q`` rows, an online softmax over the kv tiles of
    ``block_k`` rows (default: the kernel's) up to the causal live-block
    bound.  Runs on any device."""
    _check(q, k, v)
    b, s, h, d = q.shape
    t = k.shape[1]
    block_k = block_k or kernel_block_k(d)
    qf = q.float() * d ** -0.5
    kf, vf = k.float(), v.float()
    out = torch.empty_like(q)
    n_kv = -(-t // block_k)
    for q0 in range(0, s, block_q):
        qt = qf[:, q0:q0 + block_q]
        qpos = torch.arange(q0, q0 + qt.shape[1], device=q.device)
        m = torch.full((b, h, qt.shape[1]), NEG_INF, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((b, h, qt.shape[1], d), device=q.device)
        n_live = (min((q0 + block_q + block_k - 1) // block_k, n_kv)
                  if causal else n_kv)
        for k0 in range(0, n_live * block_k, block_k):
            kt, vt = kf[:, k0:k0 + block_k], vf[:, k0:k0 + block_k]
            sc = torch.einsum("bqhd,bkhd->bhqk", qt, kt)
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


@functools.cache
def _library():
    from repro_torch.kernels.build import load
    fn = load("flash_attention").flash_attention_fwd
    # q, k, v, out, dtype, B, H, S, T, hd, strides, causal, sm_scale, stream
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
        ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_float,
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream (no synchronise).

    Takes q, k, v on one CUDA device, float32 or bfloat16, any strides
    with a contiguous head dim, ``hd`` in :data:`HEAD_DIMS`, and raises
    on anything else; the output is allocated here, contiguous.  Each
    launch adds one to ``flash_attention_cuda.launches``."""
    _check(q, k, v)
    dev = q.device
    for a in (q, k, v):
        if a.device != dev or not a.is_cuda:
            raise ValueError(f"flash_attention_cuda takes tensors on one "
                             f"CUDA device, got {a.device} beside {dev}")
        if a.stride(-1) != 1:
            raise ValueError("flash_attention_cuda takes a contiguous "
                             "head dim")
    b, s, h, d = q.shape
    t = k.shape[1]
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention_cuda is built for head dims "
                         f"{HEAD_DIMS}, got {d}")
    if -(-s // BLOCK_Q) > 65535:
        raise ValueError(f"S = {s} needs more than 65535 q tiles")
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=dev)
    for a in (q, k, v, out):
        last = sum((n - 1) * st for n, st in zip(a.shape, a.stride()))
        if last > _INT32_MAX:
            raise ValueError("flash_attention_cuda indexes with 32-bit "
                             "offsets; split the batch")
    strides = (ctypes.c_int * 12)(*(st for a in (q, k, v, out)
                                    for st in a.stride()[:3]))
    fn = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 _DTYPE_CODES[q.dtype], b, h, s, t, d, strides, int(causal),
                 float(d ** -0.5), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_cuda kernel launch failed: "
                           f"CUDA error {err}")
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0
