"""Per-row symmetric int8 quantization of the offload KV cache (port of
`magicpig_tpu/ops/quant.py`, the int8 grid).

Each (head, token) row of d values gets one f32 scale, max|row| / 127; the
values are round(x / scale), half to even, clipped to +-127. Zero rows get
scale 0 and dequantize to exact zeros. The arithmetic is the JAX package's
step for step (a division, not a multiply by the reciprocal), so the two
give the same bytes, on the card too (`div_exact`).
"""

from __future__ import annotations

import torch

QMAX = 127.0


def div_exact(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c, correctly rounded on every device. Divided by a Python number,
    a CUDA tensor is multiplied by the number's rounded reciprocal instead,
    one ulp off x / c for some x (XLA does the same under jit); a divisor
    tensor on x's device keeps the true division."""
    return x / x.new_full((), c)


def quantize_rows(x: torch.Tensor):
    """[..., S, d] -> (int8 [..., S, d], scale f32 [..., S])."""
    xf = x.float()
    scale = div_exact(xf.abs().amax(dim=-1), QMAX)
    q = torch.round(xf / torch.clamp(scale, min=1e-20).unsqueeze(-1))
    return torch.clamp(q, -QMAX, QMAX).to(torch.int8), scale


def dequantize_rows(q: torch.Tensor, scale: torch.Tensor,
                    dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Inverse of quantize_rows: int8 [..., S, d] * scale [..., S]."""
    return (q.float() * scale.unsqueeze(-1)).to(dtype)
