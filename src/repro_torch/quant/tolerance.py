"""Checked-in output-tolerance gates for low-precision execution.

The port's copy of ``repro.quant.tolerance`` (the same tables, held
equal to them by ``tests/test_torch_quant.py``).

Precision loss is a measured, versioned contract, not vibes: for every
Table-I model this module pins how far a low-precision run may drift
from the float32 reference, and the tests enforce the numbers.
Tightening a kernel? the gates document the win.  A change
that blows a gate is a numerics regression and fails CI.

Two granularities:

* :func:`model_tolerance` — full-generator gates per (model, dtype).
  Generator outputs are tanh-bounded in ``[-1, 1]``, so the output
  gate is an absolute tolerance; the gradient gate is a relative L2
  error over the whole parameter-gradient tree (gradients are not
  bounded, so an elementwise atol would be meaningless).
* :func:`op_tolerance` — single-op forward/grad gates per dtype, used
  by the backend × kind × rank × stride parity sweep on unit-normal
  inputs.

``"int8"`` gates the int8-weight deployment path (per-channel
symmetric weights dequantized into the model's storage dtype) for the
*forward* only — quantized programs are a serving artifact, there is
no int8 training path to gate.
"""

from __future__ import annotations

__all__ = ["MODEL_TOLERANCES", "OP_TOLERANCES", "model_tolerance",
           "op_tolerance"]

# Per-model gates, calibrated on the CPU CI configuration
# (channel_scale=0.0625, batch 2, seed 0, polyphase backend) with
# 5-10x headroom over the observed drift so backend choice
# (zero-insert, interpret-mode kernel) and runner-to-runner noise
# never flip them while a real numerics regression (an order of
# magnitude) still does.
#   output_atol — max |low-precision - f32| over the generator output
#                 (tanh-bounded, so absolute)
#   grad_rel    — relative L2 error of the full parameter-grad tree
#                 (None = no training gate at this precision)
MODEL_TOLERANCES: dict[str, dict[str, dict]] = {
    "3dgan": {   # observed: bf16 1.4e-5/5.4e-3, f16 1.6e-6/6.9e-4
        "bfloat16": {"output_atol": 1e-4, "grad_rel": 0.02},
        "float16":  {"output_atol": 2e-5, "grad_rel": 3e-3},
        "int8":     {"output_atol": 2e-4, "grad_rel": None},
    },
    "artgan": {  # observed: bf16 3.9e-5/3.6e-3, f16 3.8e-6/3.0e-4
        "bfloat16": {"output_atol": 2e-4, "grad_rel": 0.015},
        "float16":  {"output_atol": 2e-5, "grad_rel": 2e-3},
        "int8":     {"output_atol": 5e-4, "grad_rel": None},
    },
    "dcgan": {   # observed: bf16 3.5e-5/1.6e-3, f16 6.1e-6/5.6e-4
        "bfloat16": {"output_atol": 2e-4, "grad_rel": 0.01},
        "float16":  {"output_atol": 3e-5, "grad_rel": 3e-3},
        "int8":     {"output_atol": 5e-4, "grad_rel": None},
    },
    "discogan": {  # observed: bf16 1.2e-6/1.7e-3, f16 2e-7/1.4e-3
        "bfloat16": {"output_atol": 1e-5, "grad_rel": 0.01},
        "float16":  {"output_atol": 2e-6, "grad_rel": 6e-3},
        "int8":     {"output_atol": 2e-5, "grad_rel": None},
    },
    "gpgan": {   # observed: bf16 4.6e-5/1.6e-3, f16 5.9e-6/3.2e-4
        "bfloat16": {"output_atol": 2e-4, "grad_rel": 0.01},
        "float16":  {"output_atol": 3e-5, "grad_rel": 2e-3},
        "int8":     {"output_atol": 5e-4, "grad_rel": None},
    },
    "magan": {   # observed: bf16 1.0e-4/6.5e-3, f16 7.9e-6/2.0e-4
        "bfloat16": {"output_atol": 5e-4, "grad_rel": 0.02},
        "float16":  {"output_atol": 4e-5, "grad_rel": 2e-3},
        "int8":     {"output_atol": 8e-4, "grad_rel": None},
    },
}

# Single-op parity gates on unit-normal inputs, calibrated over the
# runnable-backend × kind × rank × stride sweep of tests/test_quant.py
# with ~3-4x headroom (observed worst cases in the comments).
#   "fwd"      — (rtol, atol) for np.testing.assert_allclose against
#                the f32 forward.
#   "grad_rel" — relative L2 ceiling per input/weight cotangent.  The
#                backward re-rounds through the low-precision operands
#                in *two* more contractions (dx conv, dw einsum), so an
#                elementwise gate would be noise-bound where the
#                cotangent crosses zero; the L2 form measures the
#                drift that matters.
OP_TOLERANCES: dict[str, dict[str, object]] = {
    # observed: fwd 2.8e-2 (rel+abs combined), grad 4.6e-3
    "bfloat16": {"fwd": (0.08, 0.08), "grad_rel": 0.02},
    # observed: fwd 2.1e-3, grad 6.6e-4
    "float16":  {"fwd": (8e-3, 8e-3), "grad_rel": 3e-3},
}


def model_tolerance(model: str, dtype: str) -> dict:
    """The checked-in gate for (Table-I model, precision); raising
    ``KeyError`` for unknown pairs is the point — a new model or
    precision must check its numbers in here before it ships."""
    return MODEL_TOLERANCES[model][dtype]


def op_tolerance(dtype: str, what: str = "fwd"):
    """The single-op parity gate: ``what="fwd"`` returns the
    ``(rtol, atol)`` allclose pair, ``what="grad_rel"`` the relative-L2
    ceiling for the cotangents."""
    return OP_TOLERANCES[dtype][what]
