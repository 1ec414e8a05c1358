"""Int8 gradient compression with error feedback (the port of
``repro.train.compress``).

Per-tensor int8 quantization with a scale of ``max|x| / 127``; the
residual of each step's quantization is added back before the next
step's (error feedback).  :func:`make_int8_grad_transform` builds the
transform over a tree of gradients and :class:`ErrorFeedbackState`
holds its residuals between steps, as ``make_train_step``'s
``grad_transform``.  ``torch.round`` rounds half to even, as
``jnp.round`` does, and the division by the scale is in f32, so the
integers are the reference's bit for bit.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.train.checkpoint import tree_leaves, tree_map, tree_unflatten

__all__ = ["quantize_int8", "dequantize_int8", "ErrorFeedbackState",
           "make_int8_grad_transform"]


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    amax = torch.clamp(torch.max(torch.abs(x)), min=1e-12)
    scale = amax / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def make_int8_grad_transform(params_template: Any):
    """``(transform, init_err)``: ``transform(grads, err) -> (grads',
    err')`` quantizes and dequantizes each leaf of ``grads`` plus its
    residual ``err`` (f32) and returns the new residuals; ``init_err()``
    is a zero residual tree shaped as ``params_template``."""
    def transform_with_state(grads, err_state):
        def one(g, e):
            g32 = g.to(torch.float32) + e
            q, s = quantize_int8(g32)
            deq = dequantize_int8(q, s)
            return deq.to(g.dtype), g32 - deq
        out = [one(g, e) for g, e in zip(tree_leaves(grads),
                                         tree_leaves(err_state))]
        return (tree_unflatten(grads, [o[0] for o in out]),
                tree_unflatten(grads, [o[1] for o in out]))

    def init_err():
        return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                              device=p.device),
                        params_template)

    return transform_with_state, init_err


class ErrorFeedbackState:
    """The transform with its residuals carried between calls:
    ``grads -> grads'``."""

    def __init__(self, params_template):
        self.transform, init = make_int8_grad_transform(params_template)
        self.err = init()

    def __call__(self, grads):
        out, self.err = self.transform(grads, self.err)
        return out
