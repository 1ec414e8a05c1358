"""The GANAX conv kernel: CUDA source, build, wrappers and ops."""
