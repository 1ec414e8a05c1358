"""The GANAX conv kernels and the flash-attention kernel: CUDA sources,
build, wrappers and ops."""
