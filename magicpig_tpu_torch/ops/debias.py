"""Importance-sampling debias for LSH-sampled attention (port of
`magicpig_tpu/ops/debias.py`).

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

Besides this exact form ("exact"), `lsh_debias="poly"` subtracts a degree-20
polynomial in the clipped cosine fitted to log(w + 1e-4) (`log_weight_poly`,
the JAX package's fit, computed in float64 with numpy), and "none" leaves
the scaled scores unweighted (plain collision sampling: the knob that tests
whether the debias earns its keep).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

DEBIAS_EPS = 1e-4
DEBIAS_FORMS = ("exact", "poly", "none")
POLY_DEGREE = 20


def exact_log_weight(c: np.ndarray, K: int, L: int) -> np.ndarray:
    """log(w + eps) by the reference formula, in numpy float64 (the data
    the polynomial is fitted to)."""
    p_bit = 1.0 - np.arccos(np.clip(c, -1.0, 1.0)) / np.pi
    p = p_bit ** K
    q = 1.0 - p
    w = 1.0 - q ** (L - 1) * (L * p + q)
    return np.log(w + DEBIAS_EPS)


@functools.lru_cache(maxsize=8)
def log_weight_poly(K: int, L: int) -> tuple[float, ...]:
    """Power-basis coefficients, low degree first, of the degree-20
    Chebyshev fit of log(w + eps) over cos in [-1, 1] at 100001 points;
    cached per (K, L)."""
    c = np.linspace(-1.0, 1.0, 100001)
    ch = np.polynomial.chebyshev.Chebyshev.fit(c, exact_log_weight(c, K, L),
                                               POLY_DEGREE)
    coef = ch.convert(kind=np.polynomial.Polynomial).coef
    return tuple(float(a) for a in coef)


def eval_poly(c: torch.Tensor, coeffs) -> torch.Tensor:
    """Horner's rule in c's type, one rounded multiply and one rounded add
    a step (as the kernel does); c pre-clipped to [-1, 1]."""
    acc = torch.full_like(c, coeffs[-1])
    for a in coeffs[-2::-1]:
        acc = acc * c + a
    return acc


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
                  k_norm: torch.Tensor, head_dim: int, K: int, L: int,
                  debias: str = "exact") -> torch.Tensor:
    """Debiased attention logits from raw (unscaled) q.k products.

    raw_qk: [..., n]; q_norm: broadcastable [..., 1]; k_norm: [..., n]
    (norms of the centered keys); debias: one of `DEBIAS_FORMS`.
    """
    if debias not in DEBIAS_FORMS:
        raise ValueError(f"unknown debias form {debias!r}")
    raw = raw_qk.float()
    scores = raw / math.sqrt(head_dim)
    if debias == "none":
        return scores
    cos = raw / (q_norm.float() * k_norm.float())
    if debias == "poly":
        return scores - eval_poly(torch.clamp(cos, -1.0, 1.0),
                                  log_weight_poly(K, L))
    w = collision_weight(cos, K, L)
    return scores - torch.log(w + DEBIAS_EPS)
