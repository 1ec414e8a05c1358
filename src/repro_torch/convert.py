"""Parameters of the JAX package as tensors of the port.

:func:`params_from_jax` takes one network's parameters as numpy arrays
(``{name: np.asarray(leaf)}`` of what ``repro.models.gan.init_gan``
returns) and hands back the port's tensors, so both packages compute
the same function from the same weights.  The layouts are the same
(channels-last, weights ``(K..., Cin, Cout)``): the conversion checks
names and shapes and copies.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.gan import (GanConfig, check_params,
                                    discriminator_specs, generator_specs)

__all__ = ["params_from_jax"]


def params_from_jax(np_params: dict[str, np.ndarray], cfg: GanConfig,
                    device: str | torch.device = "cuda"
                    ) -> dict[str, torch.Tensor]:
    """Validate ``np_params`` against the generator's or the
    discriminator's specs of ``cfg`` (every name, every shape) and
    return them as float32 tensors on ``device``."""
    dev = resolve_device(device)
    names = set(np_params)
    specs = generator_specs(cfg)
    if names != set(specs) and names & set(discriminator_specs(cfg)):
        specs = discriminator_specs(cfg)
    check_params(np_params, specs)
    return {name: torch.tensor(np.asarray(np_params[name], np.float32),
                               device=dev)
            for name in sorted(np_params)}
