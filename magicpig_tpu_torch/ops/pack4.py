"""Packed-int4 layout of the block_topk offload K (the port's counterpart of
`magicpig_tpu/ops/pack4.py`).

K on the 4-bit grid (`quantize_rows(x, bits=4)`, values in [-7, 7]) is
packed along the head dimension: byte j of a token's d/2-byte row holds
channel j in its low nibble and channel j + d/2 in its high nibble. At
d = 64 a token's K is 32 bytes, read by the block kernels as two 16-byte
loads, and the split into halves matches the group-local one of
`csrc/w4_matmul.cu`. Tokens, their f32 scales, the length mask and the
scores all stay in token order, so the store pipeline's `block_attend`
reads the same scores as with int8 K.

The JAX package packs across tokens instead: within each 512-token span,
folded row r and row r + span_rows/2 share a byte, which suits the TPU's
128 lanes and the attend's DMA slices but puts the scores, scales and length
mask in a 2*fold-group layout (`group_scales`, `group_length_mask`). The
tests convert its state (`unpack_rows`, `ungroup_scales`) into this one.
Packing is lossless, so no output depends on the layout.
"""

from __future__ import annotations

import torch

from magicpig_tpu_torch.ops.quant import pack_nibbles, unpack_nibbles


def pack_k4(k: torch.Tensor) -> torch.Tensor:
    """int8 rows on the 4-bit grid [..., d] -> packed bytes [..., d/2]."""
    d = k.shape[-1]
    if d % 2:
        raise ValueError(f"packed int4 K needs an even head dim, got {d}")
    return pack_nibbles(k[..., :d // 2], k[..., d // 2:])


def unpack_k4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of `pack_k4`: [..., d/2] bytes -> int8 [..., d]."""
    lo, hi = unpack_nibbles(packed)
    return torch.cat([lo, hi], dim=-1)


def is_packed(q: torch.Tensor, k: torch.Tensor) -> bool:
    """Is k [B, Hkv, S, d/2] packed int4 K for the queries q [B, Hq, d]?"""
    return k.dtype == torch.int8 and 2 * k.shape[-1] == q.shape[-1]
