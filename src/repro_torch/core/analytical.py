"""The layer record of the GAN topologies.

The port keeps only the ``ConvLayer`` dataclass of
``repro.core.analytical`` (the cycle and energy model stays in the JAX
package); the parity tests hold the two records field by field.
"""

from __future__ import annotations

import dataclasses

__all__ = ["ConvLayer"]


@dataclasses.dataclass(frozen=True)
class ConvLayer:
    """One (transposed) convolution layer of a GAN.

    For ``transposed=True`` the geometry follows ``core.scheduler``
    (PyTorch ``ConvTranspose``); for plain convs ``strides`` is the
    downsampling stride.
    """
    name: str
    in_spatial: tuple[int, ...]
    kernel: tuple[int, ...]
    strides: tuple[int, ...]
    paddings: tuple[int, ...]
    cin: int
    cout: int
    transposed: bool = True
    batch: int = 1
