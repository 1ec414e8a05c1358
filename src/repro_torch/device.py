"""Device selection for the port's entry points."""

from __future__ import annotations

import torch

__all__ = ["resolve_device", "platform_of", "default_platform",
           "require_ieee_f32", "require_f32_accumulation"]


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on.

    The default is the card.  Without one, only an explicit CPU device
    runs: a CUDA request raises rather than carrying on on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the plain PyTorch versions on the CPU")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def platform_of(device: str | torch.device) -> str:
    """The tuner's platform of ``device``: ``"cpu"``, or a card's compute
    capability as ``"sm_<major><minor>"`` (``"sm_90"`` for an H100).
    Plans measured on one platform never serve another."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return "cpu"
    major, minor = torch.cuda.get_device_capability(dev)
    return f"sm_{major}{minor}"


def default_platform() -> str:
    """The platform the entry points run on by default: the card's when
    there is one, else the CPU's."""
    return platform_of("cuda") if torch.cuda.is_available() else "cpu"


def require_ieee_f32(t: torch.Tensor, *, conv: bool = False) -> None:
    """Refuse TF32 for an f32 matmul (``conv=True``: a cuDNN
    convolution) on the card: TF32 keeps about three decimal digits,
    and the port computes in full f32 everywhere."""
    if not t.is_cuda:
        return
    flag = "cudnn" if conv else "cuda.matmul"
    if (torch.backends.cudnn.allow_tf32 if conv
            else torch.backends.cuda.matmul.allow_tf32):
        raise RuntimeError(
            f"torch.backends.{flag}.allow_tf32 is True; the port "
            f"computes in full float32 (set it to False)")


def require_f32_accumulation(t: torch.Tensor) -> None:
    """Refuse reduced-precision sums for the matmuls on ``t``'s dtype on
    the card: full f32 for a float32 tensor (no TF32), and f32
    reductions for a bfloat16 or float16 one (cuBLAS may otherwise
    reduce bf16 or f16 products in that dtype; PyTorch allows it by
    default for both), as the reference accumulates in f32."""
    if not t.is_cuda:
        return
    if t.dtype == torch.float32:
        require_ieee_f32(t)
        return
    flag = {torch.bfloat16: "allow_bf16_reduced_precision_reduction",
            torch.float16: "allow_fp16_reduced_precision_reduction"
            }.get(t.dtype)
    if flag is not None and getattr(torch.backends.cuda.matmul, flag):
        raise RuntimeError(
            f"torch.backends.cuda.matmul.{flag} is True; the port "
            f"accumulates {str(t.dtype).removeprefix('torch.')} products "
            f"in f32 (set it to False)")
