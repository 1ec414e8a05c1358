"""The port's flash attention against the JAX package's, on the CPU.

``flash_attention_plain`` (the CUDA kernel's function in plain PyTorch,
tile by tile) is held to the Pallas kernel ``flash_attention_pallas`` in
interpret mode on the geometries of ``tests/test_kernels_flash.py``, and
to the reference's ``naive_attention`` where the Pallas kernel cannot
go: ragged S and T (not multiples of the tiles) and hd = 256.

Tolerances: atol = rtol = 3e-5 in f32 (the Pallas test's own: f32 on
both sides, summed in another order); 1e-2 in bf16 (both sides compute
in f32 from the same bf16 inputs and round the output once, so they
differ by at most an ulp or two of a bf16 output).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_pallas
from repro.models.attention import naive_attention
from repro_torch.kernels.flash_attention import (FFMA_GEOMETRIES,
                                                 HEAD_DIMS,
                                                 check_tma_operand,
                                                 flash_attention_cuda,
                                                 flash_attention_ffma,
                                                 flash_attention_plain,
                                                 flash_attention_wgmma,
                                                 kernel_block_k,
                                                 kernel_tiles,
                                                 kernel_variant)
from test_kernels_flash import CASES

F32 = dict(atol=3e-5, rtol=3e-5)
BF16 = dict(atol=1e-2, rtol=1e-2)


def _qkv(b, s, t, h, hd, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, s, h, hd)).astype(dtype)
    k = rng.normal(size=(b, t, h, hd)).astype(dtype)
    v = rng.normal(size=(b, t, h, hd)).astype(dtype)
    return q, k, v


@pytest.mark.parametrize("tiles", ["case", "kernel"])
@pytest.mark.parametrize("b,s,h,hd,causal,bq,bk", CASES)
def test_plain_matches_pallas_interpret(b, s, h, hd, causal, bq, bk, tiles):
    """Both at the case's tiles, and the plain version at the CUDA
    FFMA kernel's own for f32 (64 q rows, ``kernel_block_k(hd, f32)`` kv
    rows)."""
    q, k, v = _qkv(b, s, s, h, hd, seed=s + hd)
    ref = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal=causal, block_q=bq,
                                 block_k=bk, interpret=True)
    blocks = dict(block_q=bq, block_k=bk) if tiles == "case" else {}
    got = flash_attention_plain(torch.tensor(q), torch.tensor(k),
                                torch.tensor(v), causal=causal, **blocks)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F32)


def test_plain_matches_pallas_interpret_bf16():
    """The bf16 case of ``test_kernels_flash.py``: the output is bf16."""
    q, k, v = _qkv(1, 64, 64, 2, 32, seed=1)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    ref = flash_attention_pallas(jq, jk, jv, causal=True, block_q=32,
                                 block_k=32, interpret=True)
    tq, tk, tv = (torch.tensor(np.asarray(a, np.float32)).bfloat16()
                  for a in (jq, jk, jv))
    got = flash_attention_plain(tq, tk, tv, causal=True, block_q=32,
                                block_k=32)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32), **BF16)


RAGGED = [
    # (B, S, T, H, hd, causal)
    (1, 17, 17, 2, 256, True),      # Gemma's head dim, one partial tile
    (1, 130, 130, 2, 256, False),
    (1, 100, 100, 3, 128, True),
    (2, 70, 45, 3, 64, True),       # S > T: rows past T see every key
    (2, 45, 70, 3, 32, False),
    (1, 65, 200, 1, 16, True),      # S < T, top-left causal alignment
    (2, 99, 99, 1, 8, True),
]


@pytest.mark.parametrize("b,s,t,h,hd,causal", RAGGED)
def test_plain_matches_naive_on_ragged_shapes(b, s, t, h, hd, causal):
    q, k, v = _qkv(b, s, t, h, hd, seed=7 * s + t)
    q_pos = jnp.broadcast_to(jnp.arange(s)[None], (b, s))
    k_pos = jnp.broadcast_to(jnp.arange(t)[None], (b, t))
    ref = naive_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          q_pos, k_pos, causal=causal)
    got = flash_attention_plain(torch.tensor(q), torch.tensor(k),
                                torch.tensor(v), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F32)


@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_kernel_tiles_cover_every_head_dim(hd):
    """The plain version at the kernel's tiles over a causal S that
    leaves a partial q tile and a partial kv tile, for every head dim
    the kernel is built for."""
    s = 64 + kernel_block_k(hd, torch.float32) + 5
    q, k, v = _qkv(1, s, s, 2, hd, seed=hd)
    pos = jnp.broadcast_to(jnp.arange(s)[None], (1, s))
    ref = naive_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          pos, pos, causal=True)
    got = flash_attention_plain(torch.tensor(q), torch.tensor(k),
                                torch.tensor(v), causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F32)


@pytest.mark.parametrize("hd", [128, 256])
def test_plain_at_the_wgmma_tiles_matches_naive(hd):
    """The plain version walking the wgmma kernel's tiles (128 q rows, 64
    kv rows) over a causal S that leaves a partial q tile and a partial
    kv tile, in f32 so the check is tight."""
    bq, bk = kernel_tiles(torch.bfloat16, hd)
    assert (bq, bk) == (128, 64) and kernel_block_k(hd, torch.bfloat16) == 64
    s = bq + bk + 5
    q, k, v = _qkv(1, s, s, 2, hd, seed=3 * hd)
    pos = jnp.broadcast_to(jnp.arange(s)[None], (1, s))
    ref = naive_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          pos, pos, causal=True)
    got = flash_attention_plain(torch.tensor(q), torch.tensor(k),
                                torch.tensor(v), causal=True, block_q=bq,
                                block_k=bk)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_variant_table(dtype, hd):
    """The wgmma kernel takes bf16 at hd 64, 80, 128 and 256 (Hymba-1.5B's,
    HuBERT-XLarge's, Qwen1.5-32B's and Gemma-7B's heads), at 128 q rows
    against 128 kv rows at hd 64 (a 64-wide output, as at (96, 64)) and
    64 at 80, 128 and 256; the FFMA kernel every other geometry (bf16 at
    hd 8-32 and f32 everywhere); the choice reads the dtype and the head
    dim alone."""
    wgmma = dtype == torch.bfloat16 and hd in (64, 80, 128, 256)
    want = "wgmma" if wgmma else "ffma"
    assert kernel_variant(dtype, hd) == want
    bq, bk = kernel_tiles(dtype, hd)
    assert bq == (128 if want == "wgmma" else 64)
    assert bk == kernel_block_k(hd, dtype)
    if want == "wgmma":
        assert bk == (128 if hd == 64 else 64)


def test_ffma_keeps_bf16_hd64_as_the_yardstick():
    """bf16 hd 64 runs on the wgmma kernel through the variant table, but
    the FFMA kernel stays built for it: ``flash_attention_ffma`` takes
    it when called directly (the wgmma instance's yardstick), getting as
    far as the device check with no launch counted."""
    assert (torch.bfloat16, 64, 64) in FFMA_GEOMETRIES
    q = torch.zeros((1, 8, 2, 64), dtype=torch.bfloat16)
    before = flash_attention_ffma.launches
    with pytest.raises(ValueError, match="CUDA device"):
        flash_attention_ffma(q, q, q)
    assert flash_attention_ffma.launches == before


def test_variant_table_refuses_other_geometries():
    with pytest.raises(ValueError, match="head dims"):
        kernel_variant(torch.bfloat16, 48)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        kernel_variant(torch.float16, 128)


@pytest.mark.parametrize("launcher,dtype,hd", [
    (flash_attention_ffma, torch.bfloat16, 128),
    (flash_attention_ffma, torch.bfloat16, 256),
    (flash_attention_wgmma, torch.float32, 256),
    (flash_attention_wgmma, torch.bfloat16, 64),
], ids=["ffma-bf16-128", "ffma-bf16-256", "wgmma-f32-256", "wgmma-bf16-64"])
def test_each_kernel_refuses_the_other_kernels_geometries(launcher, dtype,
                                                          hd):
    """Each variant's launcher takes only its own rows of the table, and
    refuses the others before it looks at the operands' device (so with
    no card too) and without counting a launch.  bf16 hd 64 is the wgmma
    kernel's own row (and the FFMA kernel's too, its yardstick): the
    wgmma launcher takes it, and stops at the device check; bf16 hd 32
    is the FFMA kernel's alone, and the wgmma launcher refuses it."""
    q = torch.zeros((1, 8, 2, hd), dtype=dtype)
    before = launcher.launches
    match = ("FFMA kernel is not built for" if launcher is
             flash_attention_ffma else "wgmma kernel takes bfloat16 at head "
             "dims 64, 80, 128 and 256")
    if launcher is flash_attention_wgmma and \
            kernel_variant(dtype, hd) == "wgmma":
        with pytest.raises(ValueError, match="CUDA device"):
            launcher(q, q, q)
        q = torch.zeros((1, 8, 2, 32), dtype=dtype)
    with pytest.raises(ValueError, match=match):
        launcher(q, q, q)
    assert launcher.launches == before


def _bf16(shape, stride=None, offset=0):
    """A bf16 CPU tensor of ``shape`` with ``stride`` (default contiguous),
    ``offset`` elements into its storage."""
    n = offset + 1 + sum((d - 1) * st for d, st in
                         zip(shape, stride or torch.empty(shape).stride()))
    base = torch.zeros(n, dtype=torch.bfloat16)
    return base.as_strided(shape, stride or torch.empty(shape).stride(),
                           offset)


# (label, shape, stride, offset, strides the map gets); shapes (B, S, H, hd)
TMA_ACCEPTED = [
    ("contiguous", (2, 70, 4, 256), None, 0, (70 * 4 * 256, 4 * 256, 256)),
    ("head-major view", (2, 70, 4, 128), (4 * 70 * 128, 128, 70 * 128, 1),
     0, (4 * 70 * 128, 128, 70 * 128)),
    # extent-1 dims are never stepped over: their strides are replaced
    ("odd strides on extent-1 dims", (1, 9, 1, 128), (3, 136, 5, 1), 0,
     (9 * 128, 136, 128)),
    ("16-byte aligned offset", (1, 8, 2, 256), None, 8, (8 * 512, 512, 256)),
]
TMA_REFUSED = [
    ("head stride 520 bytes", (1, 8, 2, 256), (8 * 520, 520, 260, 1), 0,
     "k's head stride is 520 bytes"),
    ("position stride 1032 bytes", (2, 8, 1, 256), (8 * 516, 516, 256, 1),
     0, "k's position stride is 1032 bytes"),
    ("batch stride 4104 bytes", (2, 8, 1, 256), (2052, 256, 256, 1), 0,
     "k's batch stride is 4104 bytes"),
    ("address 8 bytes off", (1, 8, 2, 256), None, 4,
     "16-byte aligned address: k"),
    ("strided head dim", (1, 8, 2, 128), (4096, 512, 256, 2), 0,
     "contiguous head dim"),
]


@pytest.mark.parametrize("label,shape,stride,offset,want", TMA_ACCEPTED,
                         ids=[c[0] for c in TMA_ACCEPTED])
def test_tma_layout_check_accepts(label, shape, stride, offset, want):
    a = _bf16(shape, stride, offset)   # PyTorch aligns CPU storage to 64
    assert check_tma_operand("k", a) == want


@pytest.mark.parametrize("label,shape,stride,offset,match", TMA_REFUSED,
                         ids=[c[0] for c in TMA_REFUSED])
def test_tma_layout_check_refuses(label, shape, stride, offset, match):
    a = _bf16(shape, stride, offset)
    with pytest.raises(ValueError, match=match):
        check_tma_operand("k", a)


def _split(p: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The wgmma kernel's split of f32 ``p`` for ``p·v``
    (``split_bf16`` in csrc/flash_attention_sm90.cu): p_hi = bf16_rn(p),
    p_lo = bf16_rn(p - p_hi)."""
    hi = p.bfloat16()
    return hi, (p - hi.float()).bfloat16()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_split_p_keeps_p_v_within_2_pow_minus_16(seed):
    """For f32 p in [0, 1] (uniform, and exp of scores down to -80 as the
    softmax makes them) and bf16 v, (p_hi + p_lo)·v is within
    2^-16 |p|·|v| of p·v, summed exactly (float64), and each p within
    2^-17 p of p_hi + p_lo: the error argument of the kernel's note."""
    rng = np.random.default_rng(seed)
    p = np.concatenate([rng.uniform(0, 1, (64, 96)),
                        np.exp(-rng.uniform(0, 80, (64, 96)))], axis=1)
    p = torch.tensor(p, dtype=torch.float32)
    v = torch.tensor(rng.normal(size=(192, 256)), dtype=torch.float32)
    v = v.bfloat16().double()
    hi, lo = _split(p)
    split = hi.double() + lo.double()
    pd = p.double()
    assert bool(((pd - split).abs() <= 2.0 ** -17 * pd).all())
    err = (split @ v - pd @ v).abs()
    bound = 2.0 ** -16 * (pd @ v.abs())
    assert bool((err <= bound).all())
    # the split is not the identity: p_lo carries what bf16 p drops
    assert bool((lo != 0).any())
    assert float((hi.double() @ v - pd @ v).abs().max()) > \
        float(bound.max())


def test_operands_are_checked_before_any_launch():
    q = torch.zeros((1, 8, 4, 32))
    kv = torch.zeros((1, 8, 2, 32))
    with pytest.raises(ValueError, match="expand GQA"):
        flash_attention_plain(q, kv, kv)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_attention_plain(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="non-empty"):
        flash_attention_plain(q[:, :0], q, q)
    with pytest.raises(ValueError, match="CUDA device"):
        flash_attention_cuda(q, q, q)
