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
from repro_torch.kernels.flash_attention import (HEAD_DIMS,
                                                 flash_attention_cuda,
                                                 flash_attention_plain,
                                                 kernel_block_k)
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
    kernel's own (64 q rows, ``kernel_block_k(hd)`` kv rows)."""
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
    s = 64 + kernel_block_k(hd) + 5
    q, k, v = _qkv(1, s, s, 2, hd, seed=hd)
    pos = jnp.broadcast_to(jnp.arange(s)[None], (1, s))
    ref = naive_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          pos, pos, causal=True)
    got = flash_attention_plain(torch.tensor(q), torch.tensor(k),
                                torch.tensor(v), causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F32)


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
