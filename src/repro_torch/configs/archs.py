"""Registers every architecture config of the LLM stack.

A copy of the data of the ten ``repro.configs.<arch>`` modules, one
``register`` call each, with each module's source note.  The port serves
the causal ones (``gemma-7b``, ``qwen1.5-32b``, ``gemma3-4b``,
``minicpm3-4b``, ``olmoe-1b-7b``, ``llama4-scout-17b-a16e``); the others
build only as far as ``models/transformer.py`` lets them.
"""

from repro_torch.configs.base import ArchConfig, register

# Gemma3-4B: 34L d_model=2560 8H (GQA kv=4) d_ff=10240 vocab=262144,
# sliding window 1024 on 5:1 local:global layers, global layers use
# rope_theta=1e6 [hf:google/gemma-3-*-pt].
GEMMA3_4B = register(ArchConfig(
    name="gemma3-4b", family="dense", n_layers=34, d_model=2560, n_heads=8,
    n_kv_heads=4, d_ff=10240, vocab=262144, head_dim=256, mlp_kind="geglu",
    tie_embeddings=True, local_window=1024, local_global_pattern=(5, 1),
    rope_theta=1e4))

# Gemma-7B: 28L d_model=3072 16H (kv=16) d_ff=24576 vocab=256000, GeGLU,
# head_dim=256, tied embeddings [arXiv:2403.08295].
GEMMA_7B = register(ArchConfig(
    name="gemma-7b", family="dense", n_layers=28, d_model=3072, n_heads=16,
    n_kv_heads=16, d_ff=24576, vocab=256000, head_dim=256, mlp_kind="geglu",
    tie_embeddings=True, rope_theta=1e4))

# HuBERT-XLarge: encoder-only, 48L d_model=1280 16H d_ff=5120 vocab=504
# (codebook targets), frontend a stub of precomputed frames
# [arXiv:2106.07447].
HUBERT_XLARGE = register(ArchConfig(
    name="hubert-xlarge", family="encoder", n_layers=48, d_model=1280,
    n_heads=16, n_kv_heads=16, d_ff=5120, vocab=504, causal=False,
    mlp_kind="gelu", frontend_dim=512))

# Hymba-1.5B: parallel attention + Mamba heads in every block, 32L
# d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16,
# sliding window except three global layers [arXiv:2411.13676].
HYMBA_1P5B = register(ArchConfig(
    name="hymba-1.5b", family="hybrid", n_layers=32, d_model=1600,
    n_heads=25, n_kv_heads=5, d_ff=5504, vocab=32001, ssm=True,
    ssm_state=16, ssm_conv=4, ssm_expand=2, ssm_head_dim=64, ssm_groups=1,
    local_window=1024, global_layers=(0, 15, 31), mlp_kind="swiglu"))

# InternVL2-26B: InternViT frontend (stub) + InternLM2 backbone, 48L
# d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92553 [arXiv:2404.16821].
INTERNVL2_26B = register(ArchConfig(
    name="internvl2-26b", family="vlm", n_layers=48, d_model=6144,
    n_heads=48, n_kv_heads=8, d_ff=16384, vocab=92553, mlp_kind="swiglu",
    rope_theta=1e6, img_tokens=256, frontend_dim=3200))

# Llama-4-Scout-17B-16E: MoE, 16 experts top-1 + one shared, 48L
# d_model=5120 40H (GQA kv=8) expert d_ff=8192 vocab=202048
# [hf:meta-llama/Llama-4-Scout-17B-16E].
LLAMA4_SCOUT = register(ArchConfig(
    name="llama4-scout-17b-a16e", family="moe", n_layers=48, d_model=5120,
    n_heads=40, n_kv_heads=8, d_ff=8192, vocab=202048, moe=True,
    n_experts=16, top_k=1, expert_d_ff=8192, n_shared_experts=1,
    mlp_kind="swiglu", rope_theta=5e5))

# Mamba2-2.7B: attention-free SSM, 64L d_model=2560 vocab=50280,
# headdim 64, state 128, conv width 4 [arXiv:2405.21060].
MAMBA2_2P7B = register(ArchConfig(
    name="mamba2-2.7b", family="ssm", n_layers=64, d_model=2560, n_heads=0,
    n_kv_heads=0, d_ff=0, vocab=50280, ssm=True, ssm_state=128, ssm_conv=4,
    ssm_expand=2, ssm_head_dim=64, ssm_groups=1, mlp_kind="none"))

# MiniCPM3-4B: dense MLA, 62L d_model=2560 40H d_ff=6400 vocab=73448,
# q_lora 768, kv_lora 256, qk_nope 64, qk_rope 32, v_head 64
# [hf:openbmb/MiniCPM3-4B].
MINICPM3_4B = register(ArchConfig(
    name="minicpm3-4b", family="dense", n_layers=62, d_model=2560,
    n_heads=40, n_kv_heads=40, d_ff=6400, vocab=73448, mla=True,
    q_lora_rank=768, kv_lora_rank=256, qk_nope_head_dim=64,
    qk_rope_head_dim=32, v_head_dim=64, mlp_kind="swiglu", rope_theta=1e4))

# OLMoE-1B-7B: MoE, 64 experts top-8, 16L d_model=2048 16H expert
# d_ff=1024 vocab=50304 [arXiv:2409.02060].
OLMOE_1B_7B = register(ArchConfig(
    name="olmoe-1b-7b", family="moe", n_layers=16, d_model=2048,
    n_heads=16, n_kv_heads=16, d_ff=1024, vocab=50304, moe=True,
    n_experts=64, top_k=8, expert_d_ff=1024, mlp_kind="swiglu",
    rope_theta=1e4))

# Qwen1.5-32B: dense with QKV bias, 64L d_model=5120 40H (kv=40)
# d_ff=27392 vocab=152064 [hf:Qwen/Qwen1.5-*].
QWEN15_32B = register(ArchConfig(
    name="qwen1.5-32b", family="dense", n_layers=64, d_model=5120,
    n_heads=40, n_kv_heads=40, d_ff=27392, vocab=152064, qkv_bias=True,
    mlp_kind="swiglu", rope_theta=1e6))
