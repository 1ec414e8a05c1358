"""Token sampling: greedy / temperature / top-k / top-p (the port of
``repro.serve.sampling``), drawing from an explicit ``torch.Generator``."""

from __future__ import annotations

import torch

__all__ = ["sample"]


def sample(logits: torch.Tensor, gen: torch.Generator | None = None, *,
           temperature: float = 1.0, top_k: int = 0,
           top_p: float = 0.0) -> torch.Tensor:
    """logits (B, V) → token ids (B,), int64.  ``temperature <= 0`` is
    greedy (the first index of the largest logit) and draws nothing;
    otherwise one draw per row from ``gen``, on the logits' device."""
    logits = logits.float()
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits / temperature
    if top_k > 0:
        kth = torch.sort(logits, dim=-1).values[:, -top_k][:, None]
        logits = torch.where(logits < kth, -torch.inf, logits)
    if top_p > 0.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        cutoff_idx = torch.sum(cum < top_p, dim=-1)
        cutoff = torch.gather(sorted_logits, -1, cutoff_idx[:, None])
        logits = torch.where(logits < cutoff, -torch.inf, logits)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=gen)[:, 0]
