"""The sparse estimators' plain versions that score every offloaded key
(port of `magicpig_tpu/ops/baselines.py`):

  * block_topk (`block_topk_decode`, `block_topk_from_scores`): exact
    scores, `block_size`-token blocks ranked by their max score over the
    GQA group and the block's tokens, the queries attending the
    `budget_blocks` best blocks of their kv head. The reference for the
    hand-written kernels (`ops/kernels/block_score.py`, `rescore_attend.py`,
    `block_attend.py`);
  * the reference's accuracy baselines, which the JAX package also
    computes in XLA and no kernel replaces: Quest (`quest_landmarks`,
    `quest_decode`: pages scored by their key min/max bound, the best
    pages attended), TopK (`topk_decode`: the n highest exact scores
    attended) and OracleSampling (`oracle_sampling_decode`: n token ids
    drawn from the exact softmax with replacement, their values averaged).

Each computes the whole [B, Hkv, G, S] score array. Decode shapes: q
[B, Hq, d], caches [B, Hkv, S, d], Hq = G * Hkv; S a multiple of the block
or page size. Each returns (out [B, Hq, d] f32, lse [B, Hq] f32) for the
LSE merge with the hot partial.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from magicpig_tpu_torch.ops.attention import _softmax_pv

_NEG_INF = -math.inf
# The base key of oracle sampling's draws (the JAX server's
# `jax.random.key(677232254)`, `runtime/server.py:686`).
OS_SEED = 677232254
_M32 = 0xFFFFFFFF


def gather_blocks(x: torch.Tensor, blk_ids: torch.Tensor,
                  block_size: int) -> torch.Tensor:
    """The selected blocks of a per-token array, in the order of blk_ids.

    x: [B, Hkv, S, ...]; blk_ids: [B, Hkv, NB'] block indices. Returns
    [B, Hkv, NB' * block_size, ...].
    """
    b, hkv, s = x.shape[:3]
    rest = x.shape[3:]
    blocks = x.reshape(b, hkv, s // block_size, block_size, *rest)
    bi = torch.arange(b, device=x.device)[:, None, None]
    hi = torch.arange(hkv, device=x.device)[None, :, None]
    sel = blocks[bi, hi, blk_ids.long()]              # [B, Hkv, NB', bs, ...]
    return sel.reshape(b, hkv, -1, *rest)


def block_topk_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      length: torch.Tensor, block_size: int,
                      budget_blocks: int, k_scale: torch.Tensor | None = None,
                      v_scale: torch.Tensor | None = None):
    """Exact scores, block ranking and attention over the best blocks.

    q: [B, Hq, d]; k, v: [B, Hkv, S, d] (bf16, or int8 with per-row f32
    k_scale / v_scale [B, Hkv, S]); length: [B] valid tokens. With int8 K
    the query is rounded to bf16 and the scale applied after the dot, as in
    the JAX function. Returns (out [B, Hq, d] f32, lse [B, Hq] f32).
    """
    b, hq, d = q.shape
    hkv = k.shape[1]
    qh = q.reshape(b, hkv, hq // hkv, d)
    scale = 1.0 / torch.sqrt(torch.tensor(float(d)))    # f32, as in JAX
    if k_scale is not None:
        raw = torch.matmul(qh.to(torch.bfloat16).float(),
                           k.float().transpose(-1, -2))
        scores = raw * (k_scale[:, :, None, :] * scale)
    else:
        scores = torch.matmul(qh.float(), k.float().transpose(-1, -2)) * scale
    return block_topk_from_scores(scores, v, length, block_size,
                                  budget_blocks, v_scale=v_scale)


def block_topk_from_scores(scores: torch.Tensor, v: torch.Tensor,
                           length: torch.Tensor, block_size: int,
                           budget_blocks: int,
                           v_scale: torch.Tensor | None = None):
    """Block selection and attention from scaled scores [B, Hkv, G, S] f32.
    int8 V is dequantized to bf16 before the weighted sum, as in JAX."""
    b, hkv, g, s = scores.shape
    d = v.shape[-1]
    nb = s // block_size
    budget_blocks = min(budget_blocks, nb)
    valid = (torch.arange(s, device=scores.device)[None, :]
             < length.to(torch.int64)[:, None])[:, None, None]
    scores = torch.where(valid, scores, torch.full_like(scores, -math.inf))
    blk_score = scores.reshape(b, hkv, g, nb, block_size).amax(dim=(2, 4))
    blk_ids = torch.topk(blk_score, budget_blocks, dim=-1).indices
    s_sel = gather_blocks(scores.transpose(2, 3), blk_ids,
                          block_size).transpose(2, 3)    # [B, Hkv, G, N]
    v_sel = gather_blocks(v, blk_ids, block_size)        # [B, Hkv, N, d]
    if v_scale is not None:
        vs_sel = gather_blocks(v_scale, blk_ids, block_size)
        v_sel = (v_sel.float() * vs_sel.unsqueeze(-1)).to(torch.bfloat16)
    out, lse = _softmax_pv(s_sel, v_sel)
    return out.reshape(b, hkv * g, d), lse.reshape(b, hkv * g)


def _scale(d: int) -> float:
    """1 / sqrt(d) rounded as the JAX functions compute it in f32 (a host
    number, so that a captured step takes it as a kernel argument)."""
    return float(np.float32(1.0) / np.sqrt(np.float32(d)))


def _heads(q: torch.Tensor, hkv: int) -> torch.Tensor:
    """q [B, Hq, d] -> [B, Hkv, G, d]."""
    b, hq, d = q.shape
    return q.reshape(b, hkv, hq // hkv, d)


def _valid(length: torch.Tensor, s: int, device) -> torch.Tensor:
    """[B, 1, 1, S] bool: token j < length[b]."""
    return (torch.arange(s, device=device)[None, :]
            < length.to(torch.int64)[:, None])[:, None, None]


def _masked_softmax_wv(scores: torch.Tensor, mask: torch.Tensor,
                       v: torch.Tensor):
    """Softmax over the masked-in scores [B, Hkv, G, S] and the weighted
    sum of v [B, Hkv, S, d]: (out [B, Hq, d] f32, lse [B, Hq] f32)."""
    b, hkv, g, _ = scores.shape
    scores = torch.where(mask, scores, torch.full_like(scores, _NEG_INF))
    out, lse = _softmax_pv(scores, v)
    return out.reshape(b, hkv * g, -1), lse.reshape(b, hkv * g)


def masked_scores(q: torch.Tensor, k: torch.Tensor,
                 length: torch.Tensor) -> torch.Tensor:
    """q . k / sqrt(d) of every head [B, Hkv, G, S] f32, -inf at and past
    each request's length. The query keeps its values (f32 products, as
    JAX's einsum promotes a bf16 cache to the query's f32)."""
    qh = _heads(q, k.shape[1])
    scores = torch.matmul(qh.float(), k.float().transpose(-1, -2))
    scores = scores * _scale(q.shape[-1])
    valid = _valid(length, k.shape[2], k.device)
    return torch.where(valid, scores, torch.full_like(scores, _NEG_INF))


def quest_landmarks(k: torch.Tensor, page_size: int):
    """Per-page elementwise min and max of keys [B, Hkv, S, d] (S a
    multiple of page_size): (k_min, k_max) [B, Hkv, S / page, d]."""
    b, hkv, s, d = k.shape
    pages = k.reshape(b, hkv, s // page_size, page_size, d)
    return pages.amin(dim=3), pages.amax(dim=3)


def quest_select(q: torch.Tensor, k_min: torch.Tensor, k_max: torch.Tensor,
                 length: torch.Tensor, page_size: int, budget_pages: int,
                 s: int) -> torch.Tensor:
    """Quest's token mask [B, Hkv, G, S]: the `budget_pages` pages of best
    bound sum_d max(q min, q max) per query head, within each length.

    The bound is computed as q . mid + |q| . half (mid and half the page's
    centre and half-width), the JAX function's identity, so that pages rank
    as they do there. The chosen pages are scattered into a page mask
    [B, Hkv, G, n_pages] and read per token, where JAX compares a
    [B, Hkv, G, budget, S] array."""
    hkv, n_pages = k_min.shape[1], k_min.shape[2]
    qh = _heads(q, hkv).float()
    lo, hi = k_min.float(), k_max.float()
    mid, half = (lo + hi) * 0.5, (hi - lo) * 0.5
    page_score = (torch.matmul(qh, mid.transpose(-1, -2))
                  + torch.matmul(qh.abs(), half.transpose(-1, -2)))
    page_valid = (torch.arange(n_pages, device=q.device)[None, :] * page_size
                  < length.to(torch.int64)[:, None])[:, None, None]
    page_score = torch.where(page_valid, page_score,
                             torch.full_like(page_score, _NEG_INF))
    top = torch.topk(page_score, budget_pages, dim=-1).indices
    chosen = torch.zeros_like(page_score, dtype=torch.bool)
    chosen.scatter_(-1, top, True)
    page_of_token = torch.arange(s, device=q.device) // page_size
    return chosen[..., page_of_token] & _valid(length, s, q.device)


def quest_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 k_min: torch.Tensor, k_max: torch.Tensor,
                 length: torch.Tensor, page_size: int, budget_pages: int):
    """Quest: attention over the tokens of the `budget_pages` best pages
    (`quest_select`). The query is rounded to the cache's type before the
    exact scores, as in the JAX function."""
    mask = quest_select(q, k_min, k_max, length, page_size, budget_pages,
                        k.shape[2])
    qh = _heads(q, k.shape[1]).to(k.dtype)
    scores = torch.matmul(qh.float(), k.float().transpose(-1, -2))
    return _masked_softmax_wv(scores * _scale(q.shape[-1]), mask, v)


def topk_select(scores: torch.Tensor, n_tokens: int) -> torch.Tensor:
    """TopK's token mask: every valid score at least the n-th highest of
    its head (ties admit more than n tokens; with fewer than n valid
    tokens, all of them)."""
    thresh = torch.topk(scores, n_tokens, dim=-1).values[..., -1:]
    return (scores >= thresh) & ~torch.isneginf(scores)


def topk_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                length: torch.Tensor, n_tokens: int):
    """Oracle top-k: exact scores, softmax over the n highest of each
    query head (`topk_select`)."""
    scores = masked_scores(q, k, length)
    return _masked_softmax_wv(scores, topk_select(scores, n_tokens), v)


def _mul32(x, c: int):
    """x * c mod 2^32 for x in [0, 2^32) (an int, or int64 tensor values),
    with no int64 overflow: c is split in 16-bit halves."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _mix32(x):
    """A 32-bit integer finalizer (xor-shift-multiply, "lowbias32") of an
    int or an int64 tensor: a bijection of [0, 2^32) whose outputs look
    independent for consecutive inputs."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def counter_uniforms(seed: int, step: torch.Tensor, layer: int,
                     shape) -> torch.Tensor:
    """Uniforms in [0, 1) f32 of `shape`, a function of (seed, the device
    scalar `step`, layer, element index) alone: a counter-based hash on the
    device, so the draws are the same eagerly, in a captured CUDA graph
    (which reads `step` anew at each replay) and on any device."""
    key = _mix32(_mix32((step.to(torch.int64) & _M32) ^ (seed & _M32))
                 ^ _mix32(layer & _M32))
    idx = torch.arange(math.prod(shape), dtype=torch.int64, device=step.device)
    x = _mix32(_mix32(_mul32(idx, 0x9E3779B1) ^ key))
    return ((x >> 8).to(torch.float32) * 2.0 ** -24).reshape(shape)


def sample_ids(scores: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Token ids drawn from softmax(scores) over the last axis of
    [B, Hkv, G, S] (-inf never drawn) by inverting its CDF at the uniforms
    u [B, Hkv, G, n]: [B, Hkv, G, n] int64. A head with no valid score
    draws the last row, which its -inf LSE then weights by 0."""
    m = torch.max(scores, dim=-1, keepdim=True).values
    m_safe = torch.where(torch.isneginf(m), torch.zeros_like(m), m)
    cdf = torch.cumsum(torch.exp(scores - m_safe), dim=-1)
    ids = torch.searchsorted(cdf, u * cdf[..., -1:], right=True)
    return ids.clamp(max=scores.shape[-1] - 1)


def oracle_sampling_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           length: torch.Tensor, n_samples: int,
                           u: torch.Tensor):
    """Oracle sampling: n_samples token ids per query head drawn with
    replacement from the exact softmax over the valid keys (`sample_ids`
    at the uniforms u [B, Hkv, G, n_samples]), the f32 mean of their value
    rows, and the exact LSE of the region, which weighs the estimate in the
    partial merge."""
    b, hq, d = q.shape
    hkv = k.shape[1]
    scores = masked_scores(q, k, length)
    ids = sample_ids(scores, u)                              # [B, Hkv, G, n]
    bi = torch.arange(b, device=q.device)[:, None, None, None]
    hi = torch.arange(hkv, device=q.device)[None, :, None, None]
    out = v[bi, hi, ids].float().mean(dim=3)                 # [B, Hkv, G, d]
    lse = torch.logsumexp(scores, dim=-1)         # -inf with no valid key
    return out.reshape(b, hq, d), lse.reshape(b, hq)
