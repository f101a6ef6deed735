"""Standalone >=2-of-L collision scan: wrapper of the hand-written kernel
`csrc/collision_words.cu`, with its plain version
`ops.bitcodes.collision_words`.

Replaces both drop-in Pallas scans of the JAX package,
`magicpig_tpu/ops/pallas/collide.py::collision_words_pallas` (pallas_call
at collide.py:76) and `magicpig_tpu/ops/pallas/mask.py::
collision_words_pallas` (pallas_call at mask.py:87, the same planes viewed
as [B, Hkv, L*K, W]): in the port's flat layout they are one function.
Counted as "collision_words". Bit-exact against the plain version; bound on
the H100 by reading every plane word once.
"""

from __future__ import annotations

import torch

from magicpig_tpu_torch.ops import bitcodes
from magicpig_tpu_torch.ops.kernels import _lib

MAX_K = 16                    # bits per table (kMaxK in collide_common.cuh)
MAX_QCODE_BYTES = 12 * 1024   # dynamic shared memory for the query codes


def check_scan_inputs(name: str, planes: torch.Tensor, q_bits: torch.Tensor,
                      hkv: int, s: int, K: int, L: int) -> None:
    """planes int32 [B, Hkv, L, K, S/32], q_bits int32 [B, Hq, L, K] on the
    card, K and L within the kernels' limits."""
    b, hq = q_bits.shape[:2]
    _lib.require_cuda(name, planes, q_bits)
    _lib.require(planes.dtype == torch.int32 and s % 32 == 0
                 and planes.shape == (b, hkv, L, K, s // 32),
                 f"{name}: planes must be int32 [B, Hkv, L, K, S/32]")
    _lib.require(q_bits.dtype == torch.int32 and q_bits.shape == (b, hq, L, K),
                 f"{name}: q_bits must be int32 [B, Hq, L, K]")
    _lib.require(hq % hkv == 0 and hq // hkv in (1, 2, 4, 8),
                 f"{name}: group size {hq}/{hkv} unsupported")
    _lib.require(1 <= K <= MAX_K and L >= 1
                 and (hq // hkv) * L * 4 <= MAX_QCODE_BYTES,
                 f"{name}: K={K}, L={L} unsupported")


def collision_words(q_bits: torch.Tensor, planes: torch.Tensor) -> torch.Tensor:
    """>=2-of-L collision words of every query head.

    q_bits: [B, Hq, L, K] int32 0/1; planes: [B, Hkv, L, K, W] int32 (the
    flat layout of `ops.bitcodes`). Returns [B, Hq, W] int32: bit j of word
    w set iff key 32w + j collides with the query in >= 2 tables. CPU
    tensors take the plain version.
    """
    if q_bits.device.type == "cpu":
        return bitcodes.collision_words(q_bits, planes)
    name = "collision_words"
    _lib.require(q_bits.device.type == "cuda",
                 f"{name}: unsupported device {q_bits.device}")
    _lib.require(planes.dim() == 5, f"{name}: planes must be [B, Hkv, L, K, W]")
    b, hq, L, K = q_bits.shape
    hkv, w = planes.shape[1], planes.shape[-1]
    check_scan_inputs(name, planes, q_bits, hkv, w * bitcodes.WORD, K, L)
    out = torch.empty((b, hq, w), dtype=torch.int32, device=q_bits.device)
    _lib.launch(name, "mp_collision_words", q_bits.device, planes, q_bits,
                out, b, w, hq, hkv, K, L)
    return out
