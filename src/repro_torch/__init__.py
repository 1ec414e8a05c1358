"""GANAX on PyTorch and CUDA: the port of the JAX package ``repro``.

The port serves the Table-I GAN generators on an NVIDIA Hopper card
through a hand-written CUDA C++ port of the unified MIMD-SIMD conv
kernel (``kernels/csrc/ganax_conv.cu``).  It imports ``torch`` and
numpy only: nothing of JAX and nothing of ``repro``.  Its entry points
run on the card unless the caller passes ``device="cpu"``, where every
kernel runs its plain PyTorch version.
"""
