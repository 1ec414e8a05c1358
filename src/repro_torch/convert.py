"""Parameters of the JAX package as tensors of the port.

:func:`params_from_jax` takes one GAN network's parameters as numpy
arrays (``{name: np.asarray(leaf)}`` of what ``repro.models.gan.init_gan``
returns) and :func:`lm_params_from_jax` the LLM stack's nested
parameters; each hands back the port's tensors, so both packages
compute the same function from the same weights.
:func:`train_state_from_jax` carries a reference LLM train state
(parameters, AdamW moments, counters) into the port's, and
:func:`cache_from_jax` a reference decode cache (bf16 or int8 with its
scales, MLA latents, SSM states) into the port's, so a decode can go on
from a cache the reference filled.  The layouts are the
same (channels-last GAN weights ``(K..., Cin, Cout)``; the LLM's stacked
``segments/seg<i>/pos<j>/...`` tree): the conversion checks names and
shapes and copies.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models.gan import (GanConfig, check_params,
                                    discriminator_specs, generator_specs)
from repro_torch.models.transformer import init_cache, model_specs
from repro_torch.train.checkpoint import tree_items

__all__ = ["params_from_jax", "lm_params_from_jax", "train_state_from_jax",
           "cache_from_jax"]

_TORCH_DTYPES = {"int8": torch.int8, "bfloat16": torch.bfloat16,
                 "float16": torch.float16, "float32": torch.float32,
                 "float64": torch.float64}


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


def _check_tree(np_params: dict, specs: dict, path: str = "") -> None:
    if set(np_params) != set(specs):
        missing = sorted(set(specs) - set(np_params))
        extra = sorted(set(np_params) - set(specs))
        raise ValueError(f"parameters at '{path or '/'}': missing {missing}, "
                         f"unexpected {extra}")
    for key, spec in specs.items():
        where = f"{path}/{key}" if path else key
        leaf = np_params[key]
        if isinstance(spec, dict):
            if not isinstance(leaf, dict):
                raise ValueError(f"{where}: expected a subtree")
            _check_tree(leaf, spec, where)
        elif tuple(np.shape(leaf)) != spec.shape:
            raise ValueError(f"{where}: shape {tuple(np.shape(leaf))}, "
                             f"expected {spec.shape}")


def _to_tensors(tree: dict, device: torch.device, dtype: torch.dtype):
    return {k: (_to_tensors(v, device, dtype) if isinstance(v, dict) else
                torch.tensor(np.asarray(v, np.float32)).to(device, dtype))
            for k, v in tree.items()}


def lm_params_from_jax(np_params: dict, cfg: ArchConfig,
                       device: str | torch.device = "cuda",
                       dtype: torch.dtype | None = None) -> dict:
    """Validate the LLM parameters ``np_params`` (the nested dict of what
    ``repro.models.transformer.init`` returns, leaves as numpy arrays)
    against the port's ``model_specs(cfg)`` (every path, every shape)
    and return them as tensors on ``device``, every leaf stored in
    ``dtype`` (default ``cfg.activation_dtype``: the reference casts
    every leaf to it on every forward, so storing it so computes the
    same function)."""
    dev = resolve_device(device)
    _check_tree(np_params, model_specs(cfg))
    return _to_tensors(np_params, dev, dtype or cfg.activation_dtype)


def train_state_from_jax(np_state: dict, cfg: ArchConfig,
                         device: str | torch.device = "cuda") -> dict:
    """A reference train state (``repro.train.train_state.
    init_train_state``'s tree, or a step's, leaves as numpy arrays:
    ``{"params", "opt": {"mu", "nu", "count"}, "step"}``) as the port's
    on ``device``: the masters and both moments f32, each tree checked
    against ``model_specs(cfg)`` (every path, every shape), ``count``
    and ``step`` int32 scalars."""
    dev = resolve_device(device)
    if set(np_state) != {"params", "opt", "step"} or \
            set(np_state["opt"]) != {"mu", "nu", "count"}:
        raise ValueError("a train state is {'params', 'opt': {'mu', 'nu', "
                         "'count'}, 'step'}")
    specs = model_specs(cfg)
    trees = {}
    for name, tree in (("params", np_state["params"]),
                       ("mu", np_state["opt"]["mu"]),
                       ("nu", np_state["opt"]["nu"])):
        _check_tree(tree, specs, name)
        trees[name] = _to_tensors(tree, dev, torch.float32)

    def counter(v):
        return torch.tensor(int(np.asarray(v)), dtype=torch.int32,
                            device=dev)
    return {"params": trees["params"],
            "opt": {"mu": trees["mu"], "nu": trees["nu"],
                    "count": counter(np_state["opt"]["count"])},
            "step": counter(np_state["step"])}


def _copy_tree(out: dict, np_tree: dict, path: str = "") -> None:
    if set(out) != set(np_tree):
        raise ValueError(f"cache at '{path or '/'}': keys {sorted(np_tree)}, "
                         f"expected {sorted(out)}")
    for key, t in out.items():
        where = f"{path}/{key}" if path else key
        a = np_tree[key]
        if isinstance(t, dict):
            _copy_tree(t, a, where)
            continue
        a = np.asarray(a)
        if tuple(a.shape) != tuple(t.shape) or \
                _TORCH_DTYPES.get(a.dtype.name) != t.dtype:
            raise ValueError(f"{where}: {a.dtype.name} {tuple(a.shape)}, "
                             f"expected {t.dtype} {tuple(t.shape)}")
        # bfloat16 goes through float32 (exact): numpy has no bf16 of
        # torch's
        src = a if a.dtype.name in ("int8", "float32", "float64") \
            else a.astype(np.float32)
        t.copy_(torch.from_numpy(np.array(src)))


def cache_from_jax(np_cache: dict, cfg: ArchConfig,
                   device: str | torch.device = "cuda") -> dict:
    """The reference's decode cache (``repro.models.transformer.
    init_cache``'s tree after any prefill merge or decode steps, leaves
    as numpy arrays: bf16 or int8 ``k``/``v`` with f32 ``k_s``/``v_s``,
    MLA ``ckv``/``krope``, SSM ``h``/``conv``) as the port's cache on
    ``device``: the batch, the length and the kv dtype read off the
    tree, every path, shape and dtype checked against the port's
    ``init_cache`` at those, the values copied."""
    dev = resolve_device(device)
    leaves = tree_items(np_cache)
    if not leaves:
        raise ValueError("an empty cache")
    names = {p.rsplit("::", 1)[-1]: np.asarray(a) for p, a in leaves.items()}
    batch = next(iter(names.values())).shape[1]
    seq = [a for n, a in names.items() if n in ("k", "ckv")]
    max_len = seq[0].shape[2] if seq else 1
    kv_dtype = "int8" if any(a.dtype.name == "int8"
                             for a in names.values()) else "bf16"
    stored = [a.dtype.name for n, a in names.items()
              if n in ("k", "ckv", "conv") and a.dtype.name != "int8"]
    dtype = _TORCH_DTYPES[stored[0]] if stored else None
    out = init_cache(cfg, batch, max_len, dtype=dtype, kv_dtype=kv_dtype,
                     device=dev)
    _copy_tree(out, np_cache)
    return out
