"""Attention in plain PyTorch (port of `magicpig_tpu/ops/attention.py`).

These functions are the plain versions of the port's hand-written kernels
(`ops/kernels/`): the CPU runs them, and on the card each kernel is held
against them.

  * `flash_prefill`: causal attention of a query span against the KV
    prefix, online softmax over KV blocks; with
    `flash_prefill_train_forward` / `flash_prefill_train_backward` the
    training pair of the custom gradient (FlashAttention-2 backward);
  * `full_decode`: one-query dense attention over a cache range (an
    explicit length and an optional first row), returning (out, lse) for
    the LSE merge;
  * `collision_mask` / `lsh_masked_decode`: the LSH-sampled estimator in its
    dense masked form (>=2-of-L collision mask + debias, exact, polynomial
    or none, + masked softmax);
  * `mask_to_budget_ids` / `lsh_sampled_decode`: the same estimator in its
    budgeted-gather form (the sampled ids of each head compacted to a
    static budget, the rows gathered, the exact debias). It has no kernel:
    the JAX package computes it in XLA too.

Decode paths take GQA-shaped inputs: q [B, Hq, d] over caches [B, Hkv, S, d]
with Hq = G * Hkv. Products take their inputs' values exactly and sum in
float32; probabilities are rounded to the value cache's type before the
weighted sum of V, as in the JAX functions. int8 caches come with per-token
f32 scales [B, Hkv, S], as the TPU kernels take them: the K scale multiplies
the score after the dot, and the V scale multiplies the probability, the
product rounded to bf16 before the weighted sum of V.
"""

from __future__ import annotations

import math

import torch

from magicpig_tpu_torch.ops.debias import debias_scores
from magicpig_tpu_torch.ops.quant import dequantize_rows

_NEG_INF = -math.inf
_PREFILL_BLOCK = 512   # keys per step of the plain prefill's online softmax


def _safe_denom(l: torch.Tensor) -> torch.Tensor:
    """l == 0 only when every score is -inf (the numerator is 0 too)."""
    return torch.where(l > 0, l, torch.ones_like(l))


def _finish(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor):
    """(max, sum, weighted V) -> (out, natural-log lse); empty rows give
    (0, -inf)."""
    out = acc / _safe_denom(l).unsqueeze(-1)
    lse = torch.where(l > 0, m + torch.log(_safe_denom(l)),
                      torch.full_like(l, _NEG_INF))
    return out, lse


def _softmax_pv(scores: torch.Tensor, v: torch.Tensor,
                v_scale: torch.Tensor | None = None):
    """Masked softmax over the last axis of f32 scores [B, Hkv, G, S] and
    the weighted sum of v [B, Hkv, S, d] (int8 with v_scale [B, Hkv, S]).
    Returns (out f32, lse f32)."""
    m = torch.max(scores, dim=-1).values
    m_safe = torch.where(torch.isneginf(m), torch.zeros_like(m), m)
    p = torch.exp(scores - m_safe.unsqueeze(-1))
    l = torch.sum(p, dim=-1)
    if v_scale is None:
        pv = p.to(v.dtype)
    else:
        pv = (p * v_scale[:, :, None, :]).to(torch.bfloat16)
    acc = torch.matmul(pv.float(), v.float())
    return _finish(m_safe, l, acc)


def _raw_scores(qh: torch.Tensor, k: torch.Tensor,
                k_scale: torch.Tensor | None) -> torch.Tensor:
    """q . k for qh [B, Hkv, G, d] over k [B, Hkv, S, d] -> [B, Hkv, G, S],
    times the per-token K scale for int8 k."""
    raw = torch.matmul(qh, k.float().transpose(-1, -2))
    return raw if k_scale is None else raw * k_scale[:, :, None, :]


def per_batch(x, b: int, device) -> torch.Tensor:
    """An int, or a [B] tensor, as int64 [B] on `device`."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int64).expand(b)
    return torch.full((b,), int(x), dtype=torch.int64, device=device)


def _fp_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, kv_len: torch.Tensor,
             window: int | None) -> torch.Tensor:
    """[B, Sq, Bk] visibility of keys at k_pos [Bk] to queries at q_pos
    [B, Sq]: causal, below kv_len [B], and inside the window."""
    mask = ((k_pos[None, None, :] <= q_pos[:, :, None])
            & (k_pos[None, None, :] < kv_len[:, None, None]))
    if window is not None:
        mask = mask & (q_pos[:, :, None] - k_pos[None, None, :] < window)
    return mask


def flash_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  length: torch.Tensor, q_offset: torch.Tensor | None = None,
                  window: int | None = None, return_lse: bool = False,
                  sm_scale: float | None = None,
                  block_k: int = _PREFILL_BLOCK):
    """Causal attention of a query span against the filled KV prefix.

    q: [B, Sq, Hq, d], queries at absolute positions q_offset[b] + i;
    k, v: [B, Skv, Hkv, d]; length: [B] valid keys; q_offset: [B] or None;
    window: query t sees keys in (t - window, t], or None for full causal;
    sm_scale: the score scale (None: 1 / sqrt(d)); block_k: keys per step
    of the online softmax. Returns out [B, Sq, Hq, d] in q.dtype, plus lse
    [B, Sq, Hq] f32 (-inf where nothing was attended) when return_lse.
    """
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = 1.0 / math.sqrt(d) if sm_scale is None else sm_scale
    dev = q.device
    qh = q.float().permute(0, 2, 1, 3).reshape(b, hkv, g, sq, d)
    q_pos = (per_batch(0 if q_offset is None else q_offset, b, dev)[:, None]
             + torch.arange(sq, device=dev))                 # [B, Sq]
    kv_len = per_batch(length, b, dev)

    m = torch.full((b, hkv, g, sq), _NEG_INF, device=dev)
    l = torch.zeros((b, hkv, g, sq), device=dev)
    acc = torch.zeros((b, hkv, g, sq, d), device=dev)
    for start in range(0, skv, block_k):
        stop = min(start + block_k, skv)
        kb = k[:, start:stop].float().permute(0, 2, 1, 3)     # [B,Hkv,bk,d]
        vb = v[:, start:stop].permute(0, 2, 1, 3)
        k_pos = torch.arange(start, stop, device=dev)
        s = torch.matmul(qh, kb.unsqueeze(2).transpose(-1, -2)) * scale
        mask = _fp_mask(q_pos, k_pos, kv_len, window)
        s = torch.where(mask[:, None, None], s,
                        torch.full_like(s, _NEG_INF))
        m_new = torch.maximum(m, torch.max(s, dim=-1).values)
        m_safe = torch.where(torch.isneginf(m_new), torch.zeros_like(m_new),
                             m_new)
        p = torch.exp(s - m_safe.unsqueeze(-1))
        alpha = torch.exp(torch.where(torch.isneginf(m),
                                      torch.zeros_like(m), m - m_safe))
        l = l * alpha + torch.sum(p, dim=-1)
        acc = acc * alpha.unsqueeze(-1) + torch.matmul(
            p.to(vb.dtype).float(), vb.float().unsqueeze(2))
        m = m_new
    out, lse = _finish(m, l, acc)
    out = out.reshape(b, hq, sq, d).permute(0, 2, 1, 3).to(q.dtype)
    if return_lse:
        return out, lse.reshape(b, hq, sq).permute(0, 2, 1)
    return out


def check_train_blocks(skv: int, block_k: int) -> None:
    """The training attention's block rule (JAX's `_fp_train_bwd`)."""
    if skv % block_k:
        raise ValueError(f"flash backward requires skv % block_k == 0 "
                         f"(skv={skv}, block_k={block_k})")


def flash_prefill_train_forward(q, k, v, q_offset, kv_len, block_k: int,
                                sm_scale: float | None = None,
                                window: int | None = None):
    """The training forward (JAX's `_fp_train_fwd`): every block of k/v,
    `block_k` keys at a time; q_offset and kv_len an int or [B]. Returns
    (out [B, Sq, Hq, d] in q.dtype, lse [B, Sq, Hq] f32, -inf where nothing
    was attended)."""
    check_train_blocks(k.shape[1], block_k)
    return flash_prefill(q, k, v, kv_len, q_offset=q_offset, window=window,
                         return_lse=True, sm_scale=sm_scale, block_k=block_k)


def flash_prefill_train_backward(q, k, v, out, lse, do, q_offset, kv_len,
                                 block_k: int, sm_scale: float | None = None,
                                 window: int | None = None):
    """The FlashAttention-2 backward of the training forward (JAX's
    `_fp_train_bwd`): p = exp(s - lse) recomputed block by block, delta =
    rowsum(dO * O), the G query heads of a group summed into dK and dV.
    lse: [B, Sq, Hq] f32 from the forward; do: dL/d out. Raises ValueError
    unless skv % block_k == 0. Returns (dq, dk, dv) in the dtypes of q, k
    and v."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    check_train_blocks(skv, block_k)
    scale = 1.0 / math.sqrt(d) if sm_scale is None else sm_scale
    dev = q.device

    def heads(x):                                    # [B, Sq, Hq, ...]
        return x.permute(0, 2, 1, *range(3, x.dim())).reshape(
            b, hkv, g, sq, *x.shape[3:])

    qh = heads(q).float()
    doh = heads(do).float()
    delta = torch.sum(doh * heads(out).float(), dim=-1)       # [B,Hkv,G,Sq]
    lse = heads(lse)
    # exp(-inf - 0) = 0 covers masked slots; lse_safe keeps the rows that
    # attend nothing (lse == -inf) free of NaNs.
    lse_safe = torch.where(torch.isneginf(lse), torch.zeros_like(lse), lse)
    q_pos = (per_batch(q_offset, b, dev)[:, None]
             + torch.arange(sq, device=dev))
    kv_len = per_batch(kv_len, b, dev)
    dq = torch.zeros((b, hkv, g, sq, d), device=dev)
    dks, dvs = [], []
    for start in range(0, skv, block_k):
        kb = k[:, start:start + block_k].float().permute(0, 2, 1, 3)
        vb = v[:, start:start + block_k].float().permute(0, 2, 1, 3)
        k_pos = torch.arange(start, start + block_k, device=dev)
        s = torch.matmul(qh, kb.unsqueeze(2).transpose(-1, -2)) * scale
        mask = _fp_mask(q_pos, k_pos, kv_len, window)[:, None, None]
        p = torch.where(mask, torch.exp(s - lse_safe.unsqueeze(-1)),
                        torch.zeros_like(s))                 # [B,Hkv,G,Sq,Bk]
        dvs.append(torch.einsum("bhgqk,bhgqd->bhkd", p, doh))
        dp = torch.matmul(doh, vb.unsqueeze(2).transpose(-1, -2))
        ds = (p * (dp - delta.unsqueeze(-1)) * scale).to(k.dtype).float()
        dq = dq + torch.matmul(ds, kb.unsqueeze(2))
        dks.append(torch.einsum("bhgqk,bhgqd->bhkd", ds, qh))
    dq = dq.reshape(b, hq, sq, d).permute(0, 2, 1, 3).to(q.dtype)
    dk = torch.cat(dks, dim=2).permute(0, 2, 1, 3).to(k.dtype)
    dv = torch.cat(dvs, dim=2).permute(0, 2, 1, 3).to(v.dtype)
    return dq, dk, dv


def full_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                length: torch.Tensor, k_scale: torch.Tensor | None = None,
                v_scale: torch.Tensor | None = None,
                start: torch.Tensor | None = None):
    """Single-token decode attention over a cache range, with LSE.

    q: [B, Hq, d]; k, v: [B, Hkv, S, d] (int8 with k_scale, v_scale
    [B, Hkv, S]); length: [B] valid tokens; start: [B] first valid token
    (None: 0), so request b attends rows [start[b], length[b]): a sliding
    window's lower bound, which the JAX package applies as an `extra_mask`.
    Returns (out [B, Hq, d] f32, lse [B, Hq] f32, natural log).
    """
    b, hq, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    scale = 1.0 / math.sqrt(d)
    qh = q.float().reshape(b, hkv, hq // hkv, d)
    scores = _raw_scores(qh, k, k_scale) * scale
    rows = torch.arange(s, device=q.device)[None, :]
    valid = rows < length.to(torch.int64)[:, None]           # [B, S]
    if start is not None:
        valid = valid & (rows >= start.to(torch.int64)[:, None])
    scores = torch.where(valid[:, None, None], scores,
                         torch.full_like(scores, _NEG_INF))
    out, lse = _softmax_pv(scores, v, v_scale)
    return out.reshape(b, hq, d), lse.reshape(b, hq)


def collision_mask(q_codes: torch.Tensor, k_codes: torch.Tensor) -> torch.Tensor:
    """>=2-of-L-tables collision mask from per-table bucket codes.

    q_codes: [B, Hq, L]; k_codes: [B, Hkv, L, S]. Returns bool [B, Hq, S],
    `(q == k).sum(tables) >= 2`.
    """
    b, hq, L = q_codes.shape
    hkv, s = k_codes.shape[1], k_codes.shape[3]
    g = hq // hkv
    qc = q_codes.to(k_codes.dtype).reshape(b, hkv, g, L, 1)
    count = (qc == k_codes[:, :, None]).to(torch.int16).sum(dim=3)
    return (count >= 2).reshape(b, hq, s)


def lsh_masked_decode(q: torch.Tensor, k_centered: torch.Tensor,
                      v: torch.Tensor, k_norm: torch.Tensor,
                      mask: torch.Tensor, length: torch.Tensor, K: int,
                      L: int, k_scale: torch.Tensor | None = None,
                      v_scale: torch.Tensor | None = None,
                      debias: str = "exact"):
    """Dense masked form of LSH-sampled attention.

    q: [B, Hq, d]; k_centered, v: [B, Hkv, S, d] (int8 with k_scale,
    v_scale [B, Hkv, S]); k_norm: [B, Hkv, S] norms of the (dequantized)
    centered keys; mask: [B, Hq, S] sampled; length: [B] valid offload
    length; debias: "exact", "poly" or "none" (`ops/debias.py`). Returns
    (out [B, Hq, d] f32, lse [B, Hq] f32).
    """
    b, hq, d = q.shape
    hkv, s = k_centered.shape[1], k_centered.shape[2]
    g = hq // hkv
    qh = q.float().reshape(b, hkv, g, d)
    raw = _raw_scores(qh, k_centered, k_scale)               # [B,Hkv,G,S]
    q_norm = torch.linalg.vector_norm(qh, dim=-1, keepdim=True)
    scores = debias_scores(raw, q_norm, k_norm[:, :, None, :], d, K, L,
                           debias)
    valid = (torch.arange(s, device=q.device)[None, :]
             < length.to(torch.int64)[:, None])[:, None, None]
    full_mask = mask.reshape(b, hkv, g, s) & valid
    scores = torch.where(full_mask, scores, torch.full_like(scores, _NEG_INF))
    out, lse = _softmax_pv(scores, v, v_scale)
    return out.reshape(b, hq, d), lse.reshape(b, hq)


def mask_to_budget_ids(mask: torch.Tensor, budget: int):
    """Compact a sample mask [..., S] to `budget` token ids and validity.

    The ids of set bits come first, lowest first, then those of clear bits,
    lowest first: past the budget the highest set ids are dropped. This is
    the order of the JAX package's `lax.top_k` over the int8 mask (stable);
    `torch.topk` promises no order among ties, so a stable sort gives it.
    Returns (ids [..., budget] int32, valid [..., budget] bool).
    """
    order = torch.sort(mask.to(torch.int8), dim=-1, descending=True,
                       stable=True).indices[..., :budget]
    return order.to(torch.int32), torch.gather(mask.bool(), -1, order)


def _gather_rows(cache: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """cache [B, Hkv, S, ...] rows at ids [B, Hkv, N] -> [B, Hkv, N, ...]."""
    idx = ids.long().reshape(*ids.shape, *([1] * (cache.dim() - 3)))
    return torch.gather(cache, 2, idx.expand(*ids.shape, *cache.shape[3:]))


def lsh_sampled_decode(q: torch.Tensor, k_centered: torch.Tensor,
                       v: torch.Tensor, k_norm: torch.Tensor,
                       ids: torch.Tensor, ids_valid: torch.Tensor, K: int,
                       L: int, k_scale: torch.Tensor | None = None,
                       v_scale: torch.Tensor | None = None):
    """Budgeted-gather form of LSH-sampled attention.

    q: [B, Hq, d]; k_centered, v: [B, Hkv, S, d] (int8 with k_scale,
    v_scale [B, Hkv, S]: the gathered rows are dequantized to bf16, the
    values the JAX package gathers from its dequantized cache); k_norm:
    [B, Hkv, S]; ids, ids_valid: [B, Hq, budget] from `mask_to_budget_ids`.
    Applies the exact debias with the key norm clamped at 1e-20. Equals
    `lsh_masked_decode` wherever the budget covers every sampled key.
    Returns (out [B, Hq, d] f32, lse [B, Hq] f32).
    """
    b, hq, d = q.shape
    hkv = k_centered.shape[1]
    g, budget = hq // hkv, ids.shape[-1]
    idh = ids.reshape(b, hkv, g * budget)
    kg, vg = _gather_rows(k_centered, idh), _gather_rows(v, idh)
    if k_scale is not None:
        kg = dequantize_rows(kg, _gather_rows(k_scale, idh))
        vg = dequantize_rows(vg, _gather_rows(v_scale, idh))
    kg = kg.reshape(b, hkv, g, budget, d)
    vg = vg.reshape(b, hkv, g, budget, d)
    kn = _gather_rows(k_norm, idh).reshape(b, hkv, g, budget)
    qh = q.float().reshape(b, hkv, g, 1, d)
    raw = torch.matmul(qh, kg.float().transpose(-1, -2)).squeeze(-2)
    q_norm = torch.linalg.vector_norm(qh, dim=-1)            # [B,Hkv,G,1]
    scores = debias_scores(raw, q_norm, torch.clamp(kn, min=1e-20), d, K, L)
    scores = torch.where(ids_valid.reshape(b, hkv, g, budget), scores,
                         torch.full_like(scores, _NEG_INF))
    m = torch.max(scores, dim=-1).values
    m_safe = torch.where(torch.isneginf(m), torch.zeros_like(m), m)
    p = torch.exp(scores - m_safe.unsqueeze(-1))
    l = torch.sum(p, dim=-1)
    acc = torch.matmul(p.to(vg.dtype).float().unsqueeze(-2),
                       vg.float()).squeeze(-2)
    out, lse = _finish(m_safe, l, acc)
    return out.reshape(b, hq, d), lse.reshape(b, hq)
