"""Per-row symmetric quantization of the offload KV cache (port of
`magicpig_tpu/ops/quant.py`).

Each (head, token) row of d values gets one f32 scale, max|row| / qmax with
qmax = 2^(bits-1) - 1 (127 for int8, 7 for the 4-bit grid); the values are
round(x / scale), half to even, clipped to +-qmax, and stored in int8 at
either grid. Zero rows get scale 0 and dequantize to exact zeros. The
arithmetic is the JAX package's step for step (a division, not a multiply
by the reciprocal), so the two give the same bytes, on the card too
(`div_exact`). `pack_nibbles` puts two 4-bit-grid values in one byte.
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


def quantize_rows(x: torch.Tensor, bits: int = 8):
    """[..., S, d] -> (int8 [..., S, d], scale f32 [..., S]) on the
    `bits`-bit grid (2 <= bits <= 8), stored in int8."""
    if not 2 <= bits <= 8:
        raise ValueError(f"bits must be in [2, 8], got {bits}")
    qmax = float(2 ** (bits - 1) - 1)
    xf = x.float()
    scale = div_exact(xf.abs().amax(dim=-1), qmax)
    q = torch.round(xf / torch.clamp(scale, min=1e-20).unsqueeze(-1))
    return torch.clamp(q, -qmax, qmax).to(torch.int8), scale


def dequantize_rows(q: torch.Tensor, scale: torch.Tensor,
                    dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Inverse of quantize_rows: int8 [..., S, d] * scale [..., S]."""
    return (q.float() * scale.unsqueeze(-1)).to(dtype)


def pack_nibbles(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Two int8 tensors of 4-bit-grid values ([-7, 7]) as one int8 byte
    tensor: `lo` in the low nibble, `hi` in the high one."""
    lo, hi = lo.to(torch.int32), hi.to(torch.int32)
    return ((lo & 0x0F) | ((hi & 0x0F) << 4)).to(torch.uint8).view(torch.int8)


def unpack_nibbles(packed: torch.Tensor):
    """(lo, hi) int8 from `pack_nibbles` bytes: arithmetic shifts restore
    the signs ((x << 28) >> 28 sign-extends the low nibble of an int32)."""
    p = packed.to(torch.int32)
    return ((p << 28) >> 28).to(torch.int8), (p >> 4).to(torch.int8)
