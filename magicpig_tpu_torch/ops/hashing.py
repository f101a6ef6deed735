"""SimHash projection bank (port of `magicpig_tpu/ops/hashing.py`).

A bank of K*L random Gaussian directions signs every centered key and every
decode query: bit j = [x . h_j > 0]. The bank is drawn from an explicit
`torch.Generator`; it does not reproduce JAX's draw, so parity tests hand
the JAX bank to both sides.
"""

from __future__ import annotations

import torch


def make_hash_projections(head_dim: int, K: int, L: int,
                          generator: torch.Generator | None = None,
                          device: torch.device | str = "cuda") -> torch.Tensor:
    """Random Gaussian projection bank, float32 [head_dim, K*L]."""
    return torch.randn((head_dim, K * L), generator=generator, device=device)
