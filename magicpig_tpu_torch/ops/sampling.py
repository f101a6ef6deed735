"""Token sampling: greedy and top-p with temperature (port of
`magicpig_tpu/ops/sampling.py`). Top-p draws from an explicit
`torch.Generator`, so its draws differ from JAX's."""

from __future__ import annotations

import torch


def greedy_sample(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1).to(torch.int32)


def top_p_sample(generator: torch.Generator | None, logits: torch.Tensor,
                 temperature: float = 0.6, top_p: float = 0.9) -> torch.Tensor:
    """Sample token ids from logits [..., vocab] -> int32 [...]."""
    logits = logits.float() / max(temperature, 1e-6)
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    sorted_probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(sorted_probs, dim=-1)
    # Keep tokens while the mass before them is < top_p (always keeps the
    # first token).
    keep = (cum - sorted_probs) < top_p
    cutoff = torch.where(keep, sorted_logits,
                         torch.full_like(sorted_logits, torch.inf))
    cutoff = cutoff.min(dim=-1, keepdim=True).values
    filtered = torch.where(logits >= cutoff, logits,
                           torch.full_like(logits, -torch.inf))
    probs = torch.softmax(filtered, dim=-1)
    flat = probs.reshape(-1, probs.shape[-1])
    ids = torch.multinomial(flat, 1, generator=generator)
    return ids.reshape(probs.shape[:-1]).to(torch.int32)
