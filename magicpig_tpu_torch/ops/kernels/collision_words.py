"""Standalone >=2-of-L collision scan: wrapper of the hand-written kernel
`csrc/collision_words.cu`, with its plain version
`ops.bitcodes.collision_words`.

Replaces both drop-in Pallas scans of the JAX package,
`magicpig_tpu/ops/pallas/collide.py::collision_words_pallas` (pallas_call
at collide.py:76) and `magicpig_tpu/ops/pallas/mask.py::
collision_words_pallas` (pallas_call at mask.py:87, the same planes viewed
as [B, Hkv, L*K, W]): in the port's flat layout they are one function. With
a length it also applies the AND with the valid words that the JAX callers
apply right after their scan, and reads no plane word past the length.
Counted as "collision_words" ("collision_words_g<G>" at a group size of the
kernel's general tile: any but 1, 2, 3, 4 and 8). Bit-exact against the
plain version; bound on the H100 by reading every (valid) plane word once.
"""

from __future__ import annotations

import torch

from magicpig_tpu_torch.ops import bitcodes
from magicpig_tpu_torch.ops.kernels import _lib

MAX_K = 16                    # bits per table (kMaxK in collide_common.cuh)
SCAN_WORDS = 16               # words (512 tokens) a block: a power of two
                              # from 1 to 64; `chip_smoke.py` phase 2 times
                              # 16, 32 and 64 (`PERF.md`)


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
    _lib.check_group(name, hq, hkv, None)
    _lib.require(1 <= K <= MAX_K and L >= 1,
                 f"{name}: K={K}, L={L} unsupported")


def collision_words(q_bits: torch.Tensor, planes: torch.Tensor,
                    length: torch.Tensor | None = None) -> torch.Tensor:
    """>=2-of-L collision words of every query head.

    q_bits: [B, Hq, L, K] int32 0/1; planes: [B, Hkv, L, K, W] int32 (the
    flat layout of `ops.bitcodes`); length: [B] int32 or None. Returns
    [B, Hq, W] int32: bit j of word w set iff key 32w + j collides with the
    query in >= 2 tables and, with a length, lies before it (the words at
    or past it are 0, and no plane word there is read). CPU tensors take the
    plain version.
    """
    if q_bits.device.type == "cpu":
        return bitcodes.collision_words(q_bits, planes, length)
    return launch_scan(q_bits, planes, length)


def launch_scan(q_bits: torch.Tensor, planes: torch.Tensor,
                length: torch.Tensor | None = None,
                block_words: int = SCAN_WORDS) -> torch.Tensor:
    """Check the inputs and launch the kernel, `block_words` words a
    block."""
    _lib.require(q_bits.device.type == "cuda",
                 f"collision_words: unsupported device {q_bits.device}")
    _lib.require(planes.dim() == 5 and q_bits.dim() == 4,
                 "collision_words: planes must be [B, Hkv, L, K, W] and "
                 "q_bits [B, Hq, L, K]")
    b, hq, L, K = q_bits.shape
    hkv, w = planes.shape[1], planes.shape[-1]
    name = "collision_words" + (_lib.group_suffix(hq // hkv, None) if hkv else "")
    check_scan_inputs(name, planes, q_bits, hkv, w * bitcodes.WORD, K, L)
    if length is not None:
        _lib.require_cuda(name, q_bits, length)
        _lib.require(length.dtype == torch.int32 and length.shape == (b,),
                     f"{name}: length must be int32 [B]")
    out = torch.empty((b, hq, w), dtype=torch.int32, device=q_bits.device)
    _lib.launch(name, "mp_collision_words", q_bits.device, planes, q_bits,
                length, out, b, w, hq, hkv, K, L, block_words)
    return out
