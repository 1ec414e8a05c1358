"""Per-channel symmetric int8 weight quantization as an export transform.

The port of ``repro.quant.weights``.  Every parameter tensor of rank ≥ 2
(conv kernels, the z-projection matrix) is quantized **per output
channel** (its last axis) to symmetric int8 — ``scale = absmax / 127``
per channel, values rounded to ``[-127, 127]`` — while rank-1 tensors
(biases) stay float32, since they feed the f32 accumulator path anyway.

The int8 values and f32 scales come from numpy exactly as the reference
makes them, and :func:`quantize_program` writes the reference's base64
JSON (the version-3 program file's ``quantized_params``), so a file
exported by either package loads in the other.
:class:`repro_torch.program.Program` dequantizes the payload into the
spec's storage dtype once at load: the multiply runs in f32 and casts
once (round to nearest even), so the weights are bit-identical to the
reference's and two loads of one file serve bit-identically.
"""

from __future__ import annotations

import base64
import dataclasses

import numpy as np
import torch

from repro_torch.quant.precision import canonical_dtype, storage_dtype

__all__ = ["QUANT_SCHEME", "quantize_weight", "dequantize_weight",
           "quantize_params", "dequantize_params", "quantize_program",
           "validate_quantized"]

# Scheme tag written into the program JSON; a future asymmetric /
# per-group scheme bumps this string, and loaders reject unknown tags.
QUANT_SCHEME = "int8-symmetric-perchannel"


# -- array <-> JSON ----------------------------------------------------------

def _encode(arr: np.ndarray) -> dict:
    arr = np.ascontiguousarray(arr)
    return {"shape": list(arr.shape), "dtype": str(arr.dtype),
            "data": base64.b64encode(arr.tobytes()).decode("ascii")}


def _decode(doc) -> np.ndarray:
    if not isinstance(doc, dict) or \
            not {"shape", "dtype", "data"} <= set(doc):
        raise ValueError(f"bad quantized-array record: "
                         f"{sorted(doc) if isinstance(doc, dict) else doc!r}")
    dtype = np.dtype(str(doc["dtype"]))
    shape = tuple(int(v) for v in doc["shape"])
    raw = base64.b64decode(str(doc["data"]).encode("ascii"))
    n = int(np.prod(shape)) if shape else 1
    if len(raw) != n * dtype.itemsize:
        raise ValueError(f"quantized array payload is {len(raw)} bytes, "
                         f"want {n * dtype.itemsize} for shape {shape} "
                         f"{dtype}")
    return np.frombuffer(raw, dtype=dtype).reshape(shape)


def _f32_numpy(w) -> np.ndarray:
    """A parameter (torch tensor of any float dtype and device, or
    array-like) as a float32 numpy array."""
    if isinstance(w, torch.Tensor):
        return w.detach().to("cpu", torch.float32).numpy()
    return np.asarray(w, dtype=np.float32)


# -- per-tensor quantize / dequantize ----------------------------------------

def quantize_weight(w) -> tuple[np.ndarray, np.ndarray]:
    """f32 tensor → (int8 values, per-output-channel f32 scales).

    Symmetric per-channel over the **last** axis (Cout for the conv
    kernels, the projection width for ``proj_w``): ``scale =
    absmax / 127``; an all-zero channel gets scale 1 so dequantization
    stays exact (0 · 1 = 0)."""
    w = _f32_numpy(w)
    if w.ndim < 2:
        raise ValueError(f"per-channel quantization needs rank >= 2, "
                         f"got shape {w.shape}")
    absmax = np.max(np.abs(w), axis=tuple(range(w.ndim - 1)))
    scale = np.where(absmax > 0, absmax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.rint(w / scale), -127, 127).astype(np.int8)
    return q, scale


def dequantize_weight(q, scale, dtype="float32",
                      device: str | torch.device = "cpu") -> torch.Tensor:
    """(int8 values, f32 scales) → dense tensor in the storage dtype on
    ``device``.  The multiply runs in f32 and casts once."""
    q = torch.from_numpy(np.array(q, np.float32)).to(device)
    scale = torch.from_numpy(np.array(scale, np.float32)).to(device)
    return (q * scale).to(storage_dtype(dtype))


# -- whole-tree quantize / dequantize ----------------------------------------

def quantize_params(params: dict) -> dict:
    """Flat ``{name: tensor}`` param dict → JSON-able quantized blob.

    Rank ≥ 2 tensors go int8 per-channel; rank-0/1 tensors (biases)
    are kept as raw f32 — they are a rounding error of the payload and
    feed the f32 accumulator path directly."""
    out = {}
    for name in sorted(params):
        arr = _f32_numpy(params[name])
        if arr.ndim >= 2:
            q, scale = quantize_weight(arr)
            out[name] = {"kind": "int8", "values": _encode(q),
                         "scale": _encode(scale)}
        else:
            out[name] = {"kind": "raw", "values": _encode(arr)}
    return {"scheme": QUANT_SCHEME, "params": out}


def validate_quantized(blob) -> None:
    """Hard-validate a quantized blob (scheme tag, record structure,
    payload sizes) — ``ProgramSpec.from_json`` runs this so a corrupt
    file raises at load, where loaders degrade, not at first use."""
    if not isinstance(blob, dict) or blob.get("scheme") != QUANT_SCHEME:
        raise ValueError(
            f"unknown quantization scheme "
            f"{blob.get('scheme') if isinstance(blob, dict) else blob!r} "
            f"(want {QUANT_SCHEME!r})")
    params = blob.get("params")
    if not isinstance(params, dict) or not params:
        raise ValueError("quantized blob has no 'params' dict")
    for name, doc in params.items():
        kind = doc.get("kind") if isinstance(doc, dict) else None
        if kind == "int8":
            q, scale = _decode(doc["values"]), _decode(doc["scale"])
            if q.dtype != np.int8 or scale.dtype != np.float32:
                raise ValueError(f"param {name!r}: int8 record carries "
                                 f"{q.dtype}/{scale.dtype}")
            if q.ndim < 2 or scale.shape != (q.shape[-1],):
                raise ValueError(f"param {name!r}: scale shape "
                                 f"{scale.shape} does not match values "
                                 f"{q.shape}")
        elif kind == "raw":
            _decode(doc["values"])
        else:
            raise ValueError(f"param {name!r}: unknown record kind "
                             f"{kind!r}")


def dequantize_params(blob: dict, dtype="float32",
                      device: str | torch.device = "cpu"
                      ) -> dict[str, torch.Tensor]:
    """Quantized blob → ``{name: tensor}`` on ``device``: int8 weights
    dequantized into the storage ``dtype``, raw entries (biases) as
    stored f32."""
    validate_quantized(blob)
    out = {}
    for name, doc in blob["params"].items():
        if doc["kind"] == "int8":
            out[name] = dequantize_weight(_decode(doc["values"]),
                                          _decode(doc["scale"]), dtype,
                                          device)
        else:
            out[name] = torch.from_numpy(
                _decode(doc["values"]).copy()).to(device)
    return out


def quantize_program(spec, params: dict):
    """``(ProgramSpec, trained params)`` → a new spec with the int8
    weight payload embedded — the exportable v3-program form.

    Validates that ``params`` covers every parameter the spec's layers
    (plus the generator projection) read, so a wrong tree fails at
    export, not on the serving box.  ``canonical_dtype`` runs on the
    spec's storage dtype as a belt-and-braces check."""
    canonical_dtype(spec.dtype)
    required = set()
    if spec.role == "generator":
        required |= {"proj_w", "proj_b"}
    for le in spec.layers:
        required.add(le.w_param)
        if le.bias:
            required.add(le.b_param)
    missing = sorted(required - set(params))
    if missing:
        raise ValueError(f"params are missing {missing} required by "
                         f"program {spec.model}/{spec.role}")
    return dataclasses.replace(spec,
                               quantized_params=quantize_params(params))
