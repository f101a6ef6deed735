"""Bit-plane SimHash signatures and the >=2-of-L collision scan (port of
`magicpig_tpu/ops/bitcodes.py`, flat layout only).

Each of the K sign bits of every table is kept as a packed 32-key int32
word. For a decode query:

    match(l) = AND_k ( planes[l, k] XOR (q_bit[l, k] - 1) )

(`q_bit - 1` is 0 for a 1-bit and all ones for a 0-bit, so the XOR yields
"key bit == query bit" per key), and the >=2-of-L rule is two bitwise
accumulators over the tables:

    twice |= once & match;  once |= match

Layout: planes [..., L, K, W] int32, W = S/32; token t lives in word t//32,
bit t%32. The JAX package's block-striped fold-major layout is a TPU tiling
choice; on the card the flat layout gives coalesced word reads along W.
"""

from __future__ import annotations

import torch

WORD = 32
_HASH_CHUNK = 2048     # tokens hashed at a time by build_planes


def num_words(seq_len: int) -> int:
    if seq_len % WORD:
        raise ValueError(f"sequence capacity {seq_len} must be 32-aligned")
    return seq_len // WORD


def hash_bits(x: torch.Tensor, projections: torch.Tensor, K: int) -> torch.Tensor:
    """Sign bits of the SimHash projection: [..., D] -> [..., L, K] int32."""
    proj = torch.matmul(x.float(), projections.float())
    bits = (proj > 0).to(torch.int32)
    return bits.reshape(*bits.shape[:-1], -1, K)


def _to_int32_words(words64: torch.Tensor) -> torch.Tensor:
    """Sums of distinct powers of two in [0, 2^32) -> the int32 word with
    the same bits (two's complement)."""
    words64 = torch.where(words64 >= 2 ** 31, words64 - 2 ** 32, words64)
    return words64.to(torch.int32)


def pack_bitplanes(bits: torch.Tensor) -> torch.Tensor:
    """bits: [..., S, L, K] 0/1, S % 32 == 0 -> [..., L, K, S//32] int32
    (word w bit j = bits[..., w*32+j, l, k])."""
    *lead, s, L, K = bits.shape
    w = num_words(s)
    b = bits.to(torch.int64).reshape(*lead, w, WORD, L, K)
    shifts = torch.arange(WORD, dtype=torch.int64, device=bits.device)
    words = (b << shifts.reshape(WORD, 1, 1)).sum(dim=-3)   # [..., w, L, K]
    return _to_int32_words(words).movedim(-3, -1).contiguous()


def build_planes(keys: torch.Tensor, projections: torch.Tensor,
                 K: int) -> torch.Tensor:
    """Hash and pack a key sequence, chunked over tokens so the [S, L*K]
    bit temporary never exists at full length.

    keys: [S, H, D] (centered), S % 32 == 0. Returns [H, L, K, S//32] int32.
    """
    s = keys.shape[0]
    num_words(s)
    chunk = _HASH_CHUNK
    parts = []
    for start in range(0, s, chunk):
        kc = keys[start:start + chunk]                      # [c, H, D]
        bits = hash_bits(kc, projections, K)                # [c, H, L, K]
        parts.append(pack_bitplanes(bits.transpose(0, 1)))  # [H, L, K, c/32]
    return torch.cat(parts, dim=-1)


def collision_words(q_bits: torch.Tensor, planes: torch.Tensor,
                    length: torch.Tensor | None = None) -> torch.Tensor:
    """>=2-of-L collision mask, packed 32 keys per int32 word.

    q_bits: [B, Hq, L, K] 0/1; planes: [B, Hkv, L, K, W] int32; length:
    [B] int32 or None. Returns [B, Hq, W] int32: bit j of word w is set iff
    key w*32+j collides with the query in >= 2 tables (and, with a length,
    lies before it: the result ANDed with `valid_words`).

    The (once, twice) scan over tables is associative, (o1, t1) + (o2, t2) =
    (o1 | o2, t1 | t2 | (o1 & o2)), so it runs as a pairwise tree over L.
    """
    b, hq, L, K = q_bits.shape
    hkv, w = planes.shape[1], planes.shape[-1]
    g = hq // hkv
    qsel = (q_bits.to(torch.int32) - 1).reshape(b, hkv, g, L, K, 1)
    match = None                                      # [B, Hkv, G, L, W]
    for k in range(K):
        m = planes[:, :, None, :, k] ^ qsel[:, :, :, :, k]
        match = m if match is None else match & m
    once, twice = match, torch.zeros_like(match)
    while once.shape[3] > 1:
        if once.shape[3] % 2:                         # pad with an empty table
            once = torch.cat([once, torch.zeros_like(once[:, :, :, :1])], dim=3)
            twice = torch.cat([twice, torch.zeros_like(twice[:, :, :, :1])], dim=3)
        o1, o2 = once[:, :, :, 0::2], once[:, :, :, 1::2]
        twice = twice[:, :, :, 0::2] | twice[:, :, :, 1::2] | (o1 & o2)
        once = o1 | o2
    words = twice.reshape(b, hq, w)
    if length is not None:
        words = words & valid_words(length, w)[:, None]
    return words


def valid_words(lengths: torch.Tensor, w: int) -> torch.Tensor:
    """Packed validity mask for per-request lengths: [B] -> [B, W] int32
    with the first `length` bits set."""
    base = torch.arange(w, device=lengths.device, dtype=torch.int64) * WORD
    bits = torch.clamp(lengths.to(torch.int64)[:, None] - base, 0, WORD)
    return _to_int32_words((1 << bits) - 1)


def unpack_words(words: torch.Tensor, seq_len: int) -> torch.Tensor:
    """[..., W] int32 -> bool [..., seq_len]."""
    shifts = torch.arange(WORD, dtype=torch.int32, device=words.device)
    bits = (words.unsqueeze(-1) >> shifts) & 1
    return bits.reshape(*words.shape[:-1], -1).bool()[..., :seq_len]


def sampled_mask(q_bits: torch.Tensor, planes: torch.Tensor,
                 length: torch.Tensor) -> torch.Tensor:
    """The >=2-of-L collision mask of every valid token: [B, Hq, S] bool."""
    s = planes.shape[-1] * WORD
    return unpack_words(collision_words(q_bits, planes, length), s)
