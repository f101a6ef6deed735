"""The block_topk estimator's plain oracle (port of
`magicpig_tpu/ops/baselines.py::block_topk_decode` and
`block_topk_from_scores`).

Every offloaded key is scored exactly; `block_size`-token blocks are ranked
by their max score over the GQA group and the block's tokens, and the
queries attend over the `budget_blocks` best blocks of their kv head. It
computes the whole [B, Hkv, G, S] score array, so it is a reference for the
hand-written kernels (`ops/kernels/block_score.py`, `rescore_attend.py`,
`block_attend.py`), not a fast path. Decode shapes: q [B, Hq, d], caches
[B, Hkv, S, d], Hq = G * Hkv; S a multiple of block_size.
"""

from __future__ import annotations

import math

import torch

from magicpig_tpu_torch.ops.attention import _softmax_pv


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
