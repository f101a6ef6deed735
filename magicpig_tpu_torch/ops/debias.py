"""Importance-sampling debias for LSH-sampled attention (port of
`magicpig_tpu/ops/debias.py`, the exact form).

    cos   = (q . k) / (|q| |k|)           (k centered by the mean key)
    p     = 1 - arccos(cos) / pi           (per-bit match probability)
    w     = 1 - (1 - p^K)^(L-1) (L p^K + 1 - p^K)
            (probability of >= 2 of L table collisions)
    score = (q . k) / sqrt(d) - log(w + 1e-4)

Written as 1 - x with x near 1, w loses all its digits in float32 where it
is small: at K=10, L=150 log(w + 1e-4) is then off by up to ~0.05 (the
JAX package's form). The port evaluates the same w without the
cancellation, with u = p^K and 1 - u + L u = 1 + (L - 1) u:

    w = -expm1((L - 1) log1p(-u) + log1p((L - 1) u))
"""

from __future__ import annotations

import math

import torch

DEBIAS_EPS = 1e-4


def collision_weight(cos: torch.Tensor, K: int, L: int) -> torch.Tensor:
    """P[>= 2 of L tables collide] for vectors at angle arccos(cos)."""
    cos = torch.clamp(cos.float(), -1.0, 1.0)
    p_bit = 1.0 - torch.arccos(cos) / math.pi
    u = p_bit ** K                     # one table (all K bits) collides
    # log P[no table] + log(1 + P[exactly one]/P[none]); (L-1) * log1p(-1)
    # is -inf at u = 1 (w = 1), and L = 1 has w = 0 for every u.
    log_miss = (L - 1) * torch.log1p(-u) if L > 1 else torch.zeros_like(u)
    return -torch.expm1(log_miss + torch.log1p((L - 1) * u))


def debias_scores(raw_qk: torch.Tensor, q_norm: torch.Tensor,
                  k_norm: torch.Tensor, head_dim: int, K: int,
                  L: int) -> torch.Tensor:
    """Debiased attention logits from raw (unscaled) q.k products.

    raw_qk: [..., n]; q_norm: broadcastable [..., 1]; k_norm: [..., n]
    (norms of the centered keys).
    """
    raw = raw_qk.float()
    cos = raw / (q_norm.float() * k_norm.float())
    w = collision_weight(cos, K, L)
    return raw / math.sqrt(head_dim) - torch.log(w + DEBIAS_EPS)
