"""GANAX on PyTorch and CUDA: the port of the JAX package ``repro``.

The port serves and trains the Table-I GAN generators on an NVIDIA
Hopper card through hand-written CUDA C++ ports of the unified MIMD-SIMD
conv kernels (``kernels/csrc/ganax_conv.cu``, ``ganax_conv3d.cu``), and
serves and trains the LLM stack's causal configs (Gemma-7B, Qwen1.5-32B,
Gemma3-4B, MiniCPM3-4B, and the mixture-of-experts OLMoE-1B-7B and
Llama-4-Scout) with every prefill's attention launched through
hand-written ports of the flash-attention kernel
(``kernels/csrc/flash_attention_sm90.cu``, ``flash_attention.cu``).  It
imports ``torch`` and numpy
only: nothing of JAX and nothing of ``repro``.  Its entry points run on
the card unless the caller passes ``device="cpu"``, where every kernel
runs its plain PyTorch version.
"""
