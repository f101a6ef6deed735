"""Exact block scorer of the block_topk estimator: wrappers `block_rank`
(block maxes only), `exact_scores_ranked` (scores and block maxes) and
`exact_scores` (scores only, unmasked) of the hand-written kernel
`csrc/block_score.cu`, with their plain versions `block_scores_plain` and
`exact_scores_plain`.

Replaces the TPU kernel `magicpig_tpu/ops/pallas/score.py::_scores_call`
(pallas_call at score.py:225), reached through `block_rank` (score.py:301),
`exact_scores_ranked` (score.py:272), `exact_scores_folded` (score.py:251)
and `exact_scores` (score.py:326); the last two differ only in the TPU's
folded layout, and the port's token-order scores are `exact_scores`'s
(bf16 or int8 K, counted as "exact_scores"). On the H100 it is bound by
reading K (int8 with f32 row scales, packed int4 with f32 row scales, or
bf16) once, plus the f32 score store in the `exact_scores_ranked` variant;
one block of the kernel scores one ranking block of one (request, kv head)
(for `exact_scores`, one 512-token span, or the largest power-of-two span
from 64 that divides S); the general tile's block, up to 16 of its query
heads.
Packed int4 K ([B, Hkv, S, d/2] bytes, `ops/pack4.py`, at head dims 64 and
128) is counted apart, as "block_rank_int4" and "exact_scores_ranked_int4",
the head dims other than 64 (16, 32, 64 and 128 on the card, any group
size) as "..._d<d>", and a group size of the kernel's general tile as
"..._g<G>" (`launch_name`).

The arithmetic, kernel and plain version alike: q * (1/sqrt(d)) rounded to
bf16; K as bf16 (int8 and 4-bit values are exact in it); products summed in
f32; the sum times the row's K scale; -inf at or past `length`; the block
max over the G query heads and the block's tokens. The packed kernel sums
the same products in the same order as the int8 one, so its scores equal
the int8 kernel's on the unpacked rows bit for bit.
"""

from __future__ import annotations

import math

import torch

from magicpig_tpu_torch.ops.kernels import _lib
from magicpig_tpu_torch.ops.kernels.flash_decode import head_suffix
from magicpig_tpu_torch.ops.pack4 import is_packed, unpack_k4

INT4_HEAD_DIMS = (64, 128)   # the head dims of packed int4 K
KEY_KINDS = {torch.bfloat16: 0, torch.int8: 1}   # KeyKind in block_common.cuh
KEY_INT4 = 2                                     # packed int4 K


def scaled_query(q: torch.Tensor, hkv: int) -> torch.Tensor:
    """q [B, Hq, d] -> [B, Hkv, G, d] f32: q / sqrt(d) rounded to bf16."""
    b, hq, d = q.shape
    qs = (q.float() * (1.0 / math.sqrt(d))).to(torch.bfloat16).float()
    return qs.reshape(b, hkv, hq // hkv, d)


def token_scores(q: torch.Tensor, k: torch.Tensor,
                 k_scale: torch.Tensor | None, positions: torch.Tensor,
                 length: torch.Tensor) -> torch.Tensor:
    """Scores [B, Hkv, G, N] f32 of keys k [B, Hkv, N, d] (or packed int4
    [B, Hkv, N, d/2]) at token `positions` [B, Hkv, N]: -inf where the
    position is at or past the request's length."""
    if is_packed(q, k):
        k = unpack_k4(k)
    raw = torch.matmul(scaled_query(q, k.shape[1]), k.float().transpose(-1, -2))
    if k_scale is not None:
        raw = raw * k_scale.unsqueeze(2)
    valid = positions < length.to(torch.int64)[:, None, None]
    return torch.where(valid.unsqueeze(2), raw, torch.full_like(raw, -math.inf))


def block_scores_plain(q: torch.Tensor, k: torch.Tensor,
                       k_scale: torch.Tensor | None, length: torch.Tensor,
                       block_size: int):
    """Plain version: (scores [B, Hkv, G, S] f32, block max [B, Hkv,
    S / block_size] f32)."""
    b, hkv, s = k.shape[:3]
    pos = torch.arange(s, device=k.device).expand(b, hkv, s)
    scores = token_scores(q, k, k_scale, pos, length)
    g = scores.shape[2]
    bmax = scores.reshape(b, hkv, g, s // block_size, block_size).amax(dim=(2, 4))
    return scores, bmax


def exact_scores_plain(q: torch.Tensor, k: torch.Tensor,
                       k_scale: torch.Tensor | None) -> torch.Tensor:
    """Plain version of `exact_scores`: the scores of every token."""
    b, hkv, s = k.shape[:3]
    pos = torch.arange(s, device=k.device).expand(b, hkv, s)
    full = torch.full((b,), s, dtype=torch.int32, device=k.device)
    return token_scores(q, k, k_scale, pos, full)


def key_kind(name: str, q: torch.Tensor, k: torch.Tensor,
             k_scale: torch.Tensor | None) -> int:
    """The kernels' K selector (KeyKind in block_common.cuh) after checking
    k [B, Hkv, S, d] bf16 or int8, or packed int4 [B, Hkv, S, d/2], and its
    scales (f32 [B, Hkv, S], with quantized K only)."""
    b, _, d = q.shape
    packed = is_packed(q, k)
    _lib.require(k.dim() == 4 and k.shape[0] == b
                 and k.shape[3] in (d, d // 2) and k.dtype in KEY_KINDS
                 and (k.dtype == torch.int8 or k.shape[3] == d),
                 f"{name}: k must be bf16 or int8 [B, Hkv, S, d], or packed "
                 f"int4 [B, Hkv, S, d/2]; got {k.dtype} {tuple(k.shape)}")
    quant = k.dtype == torch.int8
    _lib.require((k_scale is not None) == quant
                 and (not quant or (k_scale.dtype == torch.float32
                                    and k_scale.shape == k.shape[:3])),
                 f"{name}: k_scale must be f32 [B, Hkv, S], with quantized "
                 "K only")
    return KEY_INT4 if packed else KEY_KINDS[k.dtype]


def launch_name(base: str, int4: bool, head_dim: int, group: int = 1) -> str:
    """The launch counter of one form of the block kernels: `base`, "_int4"
    for packed int4 K, then `head_suffix` ("_d128" at head dim 128, "_g6"
    at group size 6, ...)."""
    return base + ("_int4" if int4 else "") + head_suffix(head_dim, group)


def _launch(name: str, q, k, k_scale, length, block_size: int,
            store_scores: bool, rank: bool = True):
    _lib.require(q.device.type == "cuda", f"{name}: unsupported device {q.device}")
    b, hq, d = q.shape
    kind = key_kind(name, q, k, k_scale)
    hkv, s = k.shape[1], k.shape[2]
    _lib.require_cuda(name, q, k, *([length] if rank else []),
                      *([k_scale] if kind else []))
    _lib.require(q.dtype == torch.bfloat16, f"{name}: q must be bfloat16")
    _lib.check_group(name, hq, hkv, d)
    _lib.require(kind != KEY_INT4 or d in INT4_HEAD_DIMS,
                 f"{name}: packed int4 K at head dims {INT4_HEAD_DIMS} only")
    _lib.require(block_size > 0 and block_size % 64 == 0 and s > 0
                 and s % block_size == 0,
                 f"{name}: block size {block_size} must be a multiple of 64 "
                 f"that divides S={s}")
    _lib.require(not rank or (length.dtype == torch.int32
                              and length.shape == (b,)),
                 f"{name}: length must be int32 [B]")
    f32 = dict(dtype=torch.float32, device=q.device)
    scores = torch.empty((b, hkv, hq // hkv, s), **f32) if store_scores else None
    bmax = None
    if rank:
        # Above one block of 16 heads a kv head, the blocks of heads take
        # the max of their block maxes by atomics on a -inf start.
        bmax = (torch.full((b, hkv, s // block_size), -math.inf, **f32)
                if _lib.head_blocks(hq // hkv, d, _lib.HEAD_TILE) > 1
                else torch.empty((b, hkv, s // block_size), **f32))
    _lib.launch(launch_name(name, kind == KEY_INT4, d, hq // hkv),
                "mp_block_score",
                q.device, q, k, k_scale, length, scores,
                bmax, b, s, hq, hkv, d, block_size, kind, 1.0 / math.sqrt(d))
    return scores, bmax


def block_rank(q: torch.Tensor, k: torch.Tensor, k_scale: torch.Tensor | None,
               length: torch.Tensor, block_size: int) -> torch.Tensor:
    """Per-block ranking max over the G heads of each kv head.

    q: [B, Hq, d] (raw; scaled here); k: [B, Hkv, S, d] int8, or packed
    int4 [B, Hkv, S, d/2] (`ops/pack4.py`), with k_scale [B, Hkv, S] f32,
    or bf16 with k_scale None; length: [B] int32. Returns
    [B, Hkv, S / block_size] f32, -inf for blocks wholly past the length.
    CPU tensors take the plain version.
    """
    if q.device.type == "cpu":
        return block_scores_plain(q, k, k_scale, length, block_size)[1]
    return _launch("block_rank", q, k, k_scale, length, block_size, False)[1]


def exact_scores_ranked(q: torch.Tensor, k: torch.Tensor,
                        k_scale: torch.Tensor | None, length: torch.Tensor,
                        block_size: int):
    """Masked scores and per-block ranking max (inputs as `block_rank`).
    Returns (scores [B, Hkv, G, S] f32, block max [B, Hkv, S / block_size]
    f32). CPU tensors take the plain version."""
    if q.device.type == "cpu":
        return block_scores_plain(q, k, k_scale, length, block_size)
    return _launch("exact_scores_ranked", q, k, k_scale, length, block_size,
                   True)


def exact_scores(q: torch.Tensor, k: torch.Tensor,
                 k_scale: torch.Tensor | None) -> torch.Tensor:
    """Scaled scores of every token, no length mask, no block max.

    q: [B, Hq, d] (raw; scaled here); k: [B, Hkv, S, d] int8 with k_scale
    [B, Hkv, S] f32, or bf16 with k_scale None; S a multiple of 64.
    Returns [B, Hkv, G, S] f32 in token order (the JAX package's
    `exact_scores`). CPU tensors take the plain version.
    """
    if q.device.type == "cpu":
        return exact_scores_plain(q, k, k_scale)
    name = "exact_scores"
    _lib.require(not is_packed(q, k), f"{name}: takes bf16 or int8 K")
    s = k.shape[2]
    span = next((n for n in (512, 256, 128, 64) if s % n == 0), 0)
    _lib.require(span > 0, f"{name}: S={s} must be a multiple of 64")
    return _launch(name, q, k, k_scale, None, span, True, rank=False)[0]
