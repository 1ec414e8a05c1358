"""repro_torch.quant — mixed-precision storage and int8 weight quantization.

The port of ``repro.quant``, in three modules:

* :mod:`repro_torch.quant.precision` — the :class:`Precision` spec:
  which dtype activations and weights are *stored* in (``float32`` /
  ``bfloat16`` / ``float16``), with accumulation **always** float32.
  Programs carry the storage dtype (``GanConfig.dtype`` →
  ``ProgramSpec.dtype``); the GANAX kernels' storage-dtype instances
  and their plain versions take x and w in it, sum in f32, and cast
  once at the store.
* :mod:`repro_torch.quant.weights` — per-channel symmetric int8 weight
  quantization as a **program-export transform**:
  :func:`quantize_program` embeds int8 tensors + f32 scales into a
  version-3 program JSON; :class:`repro_torch.program.Program`
  dequantizes them into the storage dtype at load.
* :mod:`repro_torch.quant.tolerance` — the reference's checked-in
  per-Table-I-model output tolerance gates (bf16/f16/int8 vs the f32
  reference).
"""

from repro_torch.quant.precision import (SUPPORTED_STORAGE_DTYPES,
                                         Precision, canonical_dtype,
                                         storage_dtype, storage_itemsize)
from repro_torch.quant.tolerance import model_tolerance, op_tolerance
from repro_torch.quant.weights import (dequantize_params, dequantize_weight,
                                       quantize_params, quantize_program,
                                       quantize_weight)

__all__ = [
    "SUPPORTED_STORAGE_DTYPES", "Precision", "canonical_dtype",
    "storage_dtype", "storage_itemsize", "model_tolerance",
    "op_tolerance", "dequantize_params", "dequantize_weight",
    "quantize_params", "quantize_program", "quantize_weight",
]
