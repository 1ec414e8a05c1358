"""Plain oracles for the GANAX kernel (the port of ``repro.kernels.ref``)."""

from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.core.tconv import correlate, tconv_zero_insert

__all__ = ["tconv_ref", "conv_ref"]


def tconv_ref(x: torch.Tensor, w: torch.Tensor, strides: Sequence[int],
              paddings: Sequence[int]) -> torch.Tensor:
    """Transposed convolution oracle (channels-last, PyTorch geometry),
    by the zero-insertion definition — deliberately the naive
    formulation, independent of the polyphase code under test."""
    return tconv_zero_insert(x, w, strides, paddings)


def conv_ref(x: torch.Tensor, w: torch.Tensor, strides: Sequence[int],
             paddings: Sequence[int]) -> torch.Tensor:
    """Plain (discriminator) convolution oracle: correlation, stride s,
    symmetric padding p."""
    return correlate(x, w, strides, tuple((p, p) for p in paddings))
