"""The storage-precision spec threaded through program resolution.

The port of ``repro.quant.precision``, on torch dtypes.  A precision
names **one** thing: the dtype activations and weights are *stored* in
between layers (``float32`` / ``bfloat16`` / ``float16``).  It does not
name an accumulator dtype: accumulation is always float32, everywhere:

* the GANAX kernels (``kernels/csrc/ganax_conv_sm90.cuh``) take x and
  w in the storage dtype, sum their products in f32 (registers, the
  tensor cores' f32 accumulators, an f32 split-K scratch), apply the
  fused epilogue to the f32 sum, and cast **once** at the store; their
  plain versions do the same in PyTorch;
* the oracle backends (``core/tconv.py``) contract in f32 from the
  storage-dtype operands and cast the result back, and
  :meth:`repro_torch.core.dataflow.Epilogue.apply` runs the
  bias/activation math in f32 before casting back.

int8 is *not* a storage dtype: int8 weights are a serialization format
(:mod:`repro_torch.quant.weights`), dequantized into one of these
storage dtypes at program load.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["SUPPORTED_STORAGE_DTYPES", "Precision", "canonical_dtype",
           "storage_dtype", "storage_itemsize"]

SUPPORTED_STORAGE_DTYPES = ("float32", "bfloat16", "float16")

# Accepted spellings → canonical names.  Kept explicit (rather than
# dtype parsing) so an unsupported-but-parseable dtype like "float64"
# fails loudly.
_ALIASES = {
    "float32": "float32", "f32": "float32", "fp32": "float32",
    "bfloat16": "bfloat16", "bf16": "bfloat16",
    "float16": "float16", "f16": "float16", "fp16": "float16",
    "half": "float16",
}

_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def _name(dtype) -> str:
    if isinstance(dtype, str):
        return dtype.strip().lower()
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    # a numpy dtype or scalar type, or anything with a dtype name (numpy
    # has no bfloat16 without ml_dtypes: such objects carry the name)
    name = getattr(dtype, "name", None) or getattr(dtype, "__name__", None)
    if isinstance(name, str):
        return name.lower()
    return str(dtype).lower()


def canonical_dtype(dtype) -> str:
    """Canonical storage-dtype name of ``dtype`` (a name, alias, torch
    dtype, or numpy dtype); raises ``ValueError`` for anything that is
    not a supported storage dtype."""
    canon = _ALIASES.get(_name(dtype))
    if canon is None:
        raise ValueError(
            f"unsupported storage dtype {dtype!r}; one of "
            f"{SUPPORTED_STORAGE_DTYPES} (aliases f32/bf16/f16)")
    return canon


def storage_dtype(dtype) -> torch.dtype:
    """The torch dtype of a storage-dtype name."""
    return _TORCH[canonical_dtype(dtype)]


def storage_itemsize(dtype) -> int:
    """Bytes per element at storage precision — what byte accounting
    (HBM-traffic rows, sharding footprints) must use instead of a
    hardcoded 4."""
    return storage_dtype(dtype).itemsize


@dataclasses.dataclass(frozen=True)
class Precision:
    """Hashable precision spec: storage dtype + the (fixed) f32
    accumulator.  ``Precision("bf16")`` canonicalizes on construction,
    so two spellings of the same precision compare and hash equal."""

    storage: str = "float32"

    def __post_init__(self):
        object.__setattr__(self, "storage",
                           canonical_dtype(self.storage))

    @property
    def storage_dtype(self) -> torch.dtype:
        return storage_dtype(self.storage)

    @property
    def accum_dtype(self) -> torch.dtype:
        return torch.float32

    @property
    def itemsize(self) -> int:
        return self.storage_dtype.itemsize

    @property
    def is_f32(self) -> bool:
        return self.storage == "float32"

    def describe(self) -> str:
        return f"{self.storage} storage / float32 accumulate"
