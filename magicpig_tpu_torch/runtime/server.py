"""Attention-server layer ops: the dense layers and the sparse layers'
estimators, "lsh", "block_topk" and the reference's baselines "quest",
"topk" and "oracle_sampling" (port of `magicpig_tpu/runtime/server.py`).

  * fill (prefill time): `fill_dense_layer` / `fill_sparse_layer` store a
    request's prompt K/V (the dense layers' bf16 or int8 per row with f32
    scales); the sparse fill splits sink + local (hot) from the offloaded
    middle. For "lsh" it centers keys by the mean offload key and stores
    the centered-key norms and SimHash bit-planes; for "quest" it stores
    each page's key minima and maxima (from the keys before any
    quantization; rows past the length count as +-max, so that the page
    holding the length takes its bounds from its valid rows); the others
    store the offload K/V as they are. Each stores the offload quantized
    per row with f32 scales when `offload_quant` is "int8" or "int4" (K on
    the 8- or 4-bit grid, V on the 8-bit one); lsh then computes the norms
    and signatures from the centered keys quantized and dequantized, the
    keys decode scores against, and quantizes those again for storage, as
    the JAX fill does; block_topk with int4 packs K two channels a byte
    (`ops/pack4.py`);
  * decode (step time): `decode_dense_layer` appends the new token and runs
    flash decode over the prefix; `decode_sparse_layer` runs flash decode
    over the hot region and the estimator over the offload region, and
    merges the two by LSE. The lsh partial in the masked mode runs the
    fused LSH kernel for even L and, for odd L, the collision scan and the
    masked attend (`lsh_decode`), with `LSHConfig.lsh_debias`; in the
    sampled mode it runs the collision scan, compacts each head's sampled
    keys to the static budget and attends the gathered rows with the exact
    debias. block_topk runs the block scorer, top-k blocks, and an attend
    over them; the block kernels take packed int4 K as stored.

With a sliding window (`ModelConfig.sliding_window`, Mistral v0.1) the
sparse fill clips the offload region to the prompt's last `window` tokens
(older ones can never re-enter the window), the dense decode attends the
rows in the window, and the sparse decode drops each sink token from the
hot partial once the position has moved a window past it; both pass that
lower bound to flash decode as its `start`, computed on the device from
the state's lengths, so that a captured decode step replays it anew.

The state is updated in place (see `runtime/state.py`). Fill takes the
prompt's K/V at its true length, [P, Hkv, d] with P a host integer.
"""

from __future__ import annotations

import math

import torch

from magicpig_tpu_torch.config import LSHConfig
from magicpig_tpu_torch.ops.attention import (
    lsh_sampled_decode,
    mask_to_budget_ids,
)
from magicpig_tpu_torch.ops.baselines import (
    OS_SEED,
    counter_uniforms,
    oracle_sampling_decode,
    quest_decode,
    quest_landmarks,
    topk_decode,
)
from magicpig_tpu_torch.ops.bitcodes import (
    WORD,
    build_planes,
    hash_bits,
    unpack_words,
)
from magicpig_tpu_torch.ops.kernels import (
    block_attend,
    block_rank,
    collision_words,
    exact_scores_ranked,
    flash_decode,
    lsh_decode,
    rescore_attend,
)
from magicpig_tpu_torch.ops.merge import merge_partials
from magicpig_tpu_torch.ops.pack4 import pack_k4
from magicpig_tpu_torch.ops.quant import dequantize_rows, quantize_rows
from magicpig_tpu_torch.runtime.state import DecodeState


def fill_dense_layer(state: DecodeState, di: int, req: int,
                     k_full: torch.Tensor, v_full: torch.Tensor) -> None:
    """Store a request's prompt K/V [P, Hkv, d] for a dense layer (int8 per
    row with f32 scales when the state has dense scales)."""
    p = k_full.shape[0]
    if state.dense_k_scale:
        k_full, k_scale = quantize_rows(k_full)
        v_full, v_scale = quantize_rows(v_full)
        state.dense_k_scale[di][req, :, :p] = k_scale.T
        state.dense_v_scale[di][req, :, :p] = v_scale.T
    state.dense_k[di][req, :, :p] = k_full.transpose(0, 1)
    state.dense_v[di][req, :, :p] = v_full.transpose(0, 1)
    state.dense_len[req] = p


def _split_offload(k_full: torch.Tensor, v_full: torch.Tensor,
                   lsh: LSHConfig, window: int | None = None):
    """Sink/local/offload partition of a prompt's K/V [P, Hkv, d].

    With a sliding `window` the offload starts at max(sink, P - window):
    older tokens can never re-enter the window, so the estimators never
    see them. (Decode moves the window past this clip by at most the
    generation buffer; the offload keys in that sliver stay, as in the JAX
    package.)

    Returns (off_k, off_v [off_len, Hkv, d], hot_k, hot_v
    [sink + local, Hkv, d]), un-centered; off_len = P - sink - local
    without a window.
    """
    p = k_full.shape[0]
    sink, local = lsh.num_sink_tokens, lsh.num_local_tokens
    off_start = sink if window is None else max(sink, p - window)
    off = slice(off_start, max(p - local, off_start))
    hot_k = torch.cat([k_full[:sink], k_full[p - local:]], dim=0)
    hot_v = torch.cat([v_full[:sink], v_full[p - local:]], dim=0)
    return k_full[off], v_full[off], hot_k, hot_v


def fill_sparse_layer(state: DecodeState, si: int, req: int,
                      k_full: torch.Tensor, v_full: torch.Tensor,
                      projections: torch.Tensor, lsh: LSHConfig,
                      window: int | None = None) -> None:
    """Partition a prompt's K/V [P, Hkv, d] into hot + offload (the offload
    clipped to a sliding `window`) and build the estimator's state (module
    docstring)."""
    off_k, off_v, hot_k, hot_v = _split_offload(k_full, v_full, lsh, window)
    off_len, hot_len = off_k.shape[0], hot_k.shape[0]
    if lsh.estimator == "lsh":
        off_k, hot_k = _fill_lsh(state, si, req, off_k, hot_k, projections,
                                 lsh)
    elif lsh.estimator == "quest":
        _fill_quest(state, si, req, off_k, lsh.quest_page_size)
    if lsh.offload_quantized:
        off_k, k_scale = quantize_rows(off_k, lsh.offload_k_bits)
        off_v, v_scale = quantize_rows(off_v)
        if lsh.packed_k4(off_k.shape[-1]):
            off_k = pack_k4(off_k)
        state.off_k_scale[si][req, :, :off_len] = k_scale.T
        state.off_v_scale[si][req, :, :off_len] = v_scale.T
    state.off_k[si][req, :, :off_len] = off_k.transpose(0, 1)
    state.off_v[si][req, :, :off_len] = off_v.transpose(0, 1)
    state.hot_k[si][req, :, :hot_len] = hot_k.transpose(0, 1)
    state.hot_v[si][req, :, :hot_len] = hot_v.transpose(0, 1)
    state.off_len[req] = off_len
    state.hot_len[req] = hot_len


def _fill_lsh(state: DecodeState, si: int, req: int, off_k: torch.Tensor,
              hot_k: torch.Tensor, projections: torch.Tensor,
              lsh: LSHConfig):
    """The LSH state of one request: the mean offload key, centered-key
    norms and the bit-plane signatures of the centered keys (with quantized
    offload, of the centered keys quantized at `offload_k_bits` and
    dequantized: the keys decode scores against). Returns the centered
    offload (f32) and hot keys."""
    off_len, hkv, d = off_k.shape
    off_f = off_k.float()
    avg = off_f.sum(dim=0) / max(off_len, 1)                 # [Hkv, d]
    # Signatures of whole words: pad the centered keys with zero rows (a
    # zero key hashes to all-zero bits) up to the next word boundary; words
    # past it stay zero.
    n_pad = -(-off_len // WORD) * WORD
    centered = torch.zeros((n_pad, hkv, d), dtype=torch.float32,
                           device=off_k.device)
    centered[:off_len] = off_f - avg
    if lsh.offload_quantized:
        centered = dequantize_rows(
            *quantize_rows(centered, lsh.offload_k_bits), torch.float32)
    planes = state.planes[si]
    planes[req].zero_()
    planes[req, ..., :n_pad // WORD] = build_planes(centered, projections, lsh.K)
    state.k_norm[si][req].zero_()
    state.k_norm[si][req, :, :off_len] = torch.linalg.vector_norm(
        centered[:off_len], dim=-1).T
    state.avg_k[si][req] = avg
    return centered[:off_len], hot_k.float() - avg


def _fill_quest(state: DecodeState, si: int, req: int, off_k: torch.Tensor,
                page_size: int) -> None:
    """Quest's page landmarks of one request from its offload keys
    [off_len, Hkv, d] (before any quantization): rows past off_len count as
    +max for the minima and -max for the maxima (the largest finite value
    of the cache dtype), so the page holding the length takes its bounds
    from its valid rows and wholly empty pages hold +-max (decode masks
    them by the length). Cast to the cache dtype."""
    off_len, hkv, d = off_k.shape
    cap = state.off_v[si].shape[2]
    big = torch.finfo(off_k.dtype).max
    lo = torch.full((hkv, cap, d), big, dtype=torch.float32,
                    device=off_k.device)
    hi = torch.full_like(lo, -big)
    lo[:, :off_len] = off_k.float().transpose(0, 1)
    hi[:, :off_len] = lo[:, :off_len]
    state.quest_min[si][req] = quest_landmarks(lo[None], page_size)[0][0]
    state.quest_max[si][req] = quest_landmarks(hi[None], page_size)[1][0]


def _append_at(lens: torch.Tensor, cap: int):
    """Where `_append` writes request b's row: at lens[b], clamped to the
    cache's last row as `jax.lax.dynamic_update_slice` clamps its start.
    The batched step decodes free slots too, so their lengths grow past
    their caches; what they write there feeds only their own outputs,
    which nobody reads, until a fill resets the slot."""
    rows = torch.arange(lens.shape[0], device=lens.device)
    return rows, lens.clamp(max=cap - 1).long()


def _append(cache: torch.Tensor, new: torch.Tensor, at) -> None:
    """cache[b, :, at[1][b]] = new[b] for every request (in place); rows
    [B, Hkv, S, d] or row scales [B, Hkv, S]; `at` from `_append_at`."""
    cache[at[0], :, at[1]] = new.to(cache.dtype)


def decode_dense_layer(state: DecodeState, di: int, q: torch.Tensor,
                       k_new: torch.Tensor, v_new: torch.Tensor,
                       window: int | None = None) -> torch.Tensor:
    """Append + full attention over the prefix, or with a sliding `window`
    over its last `window` rows (the query at row dense_len sees rows j
    with dense_len - j < window). q: [B, Hq, d]; k/v_new: [B, Hkv, d].
    Returns out [B, Hq, d] f32. With dense int8 the new row is quantized
    and its scales appended too."""
    k_scale = v_scale = None
    at = _append_at(state.dense_len, state.dense_k[di].shape[2])
    if state.dense_k_scale:
        k_new, k_sc = quantize_rows(k_new)
        v_new, v_sc = quantize_rows(v_new)
        k_scale, v_scale = state.dense_k_scale[di], state.dense_v_scale[di]
        _append(k_scale, k_sc, at)
        _append(v_scale, v_sc, at)
    _append(state.dense_k[di], k_new, at)
    _append(state.dense_v[di], v_new, at)
    start = (None if window is None else
             torch.clamp(state.dense_len + 1 - window, min=0))
    out, _ = flash_decode(q, state.dense_k[di], state.dense_v[di],
                          state.dense_len + 1, k_scale, v_scale, start)
    return out


def _lsh_partial(state: DecodeState, si: int, q: torch.Tensor,
                 projections: torch.Tensor, lsh: LSHConfig):
    """LSH-sampled partial over the offload region: (out, lse, sampled
    fraction as a device scalar). Quantized offload passes its scales.

    The sampled mode follows the JAX server: its budget comes from the
    offload capacity, and it applies the exact debias whatever
    `lsh_debias` says."""
    q_bits = hash_bits(q, projections, lsh.K)                # [B, Hq, L, K]
    quant = lsh.offload_quantized
    k, v, k_norm, planes = (state.off_k[si], state.off_v[si],
                            state.k_norm[si], state.planes[si])
    k_scale = state.off_k_scale[si] if quant else None
    v_scale = state.off_v_scale[si] if quant else None
    n_valid = torch.clamp(state.off_len.sum() * q.shape[1], min=1)
    if lsh.decode_mode == "masked":
        out, lse, cnt = lsh_decode(q, k, v, k_norm, planes, q_bits,
                                   state.off_len, lsh.K, lsh.L, k_scale,
                                   v_scale, lsh.lsh_debias)
        return out, lse, cnt.sum() / n_valid
    off_cap = k.shape[2]
    words = collision_words(q_bits, planes, state.off_len)   # valid tokens
    mask = unpack_words(words, off_cap)                      # [B, Hq, S]
    ids, ids_valid = mask_to_budget_ids(mask, lsh.sample_budget(off_cap))
    # Quantized rows are gathered with their scales, then dequantized.
    out, lse = lsh_sampled_decode(q, k, v, k_norm, ids, ids_valid, lsh.K,
                                  lsh.L, k_scale, v_scale)
    return out, lse, mask.sum() / n_valid


def _static_budget(n: int, frac: float, floor: int) -> int:
    """A budget of frac * n items, at least `floor`, at most n."""
    return max(floor, min(n, int(math.ceil(n * frac))))


def _realized_frac(budget_tokens: int, off_len: torch.Tensor) -> torch.Tensor:
    """Workload metric of a budgeted estimator: the budget clamped to each
    request's offload length, over the mean offload length (so it never
    exceeds 1 and compares with the LSH path's sampled fraction)."""
    lens = off_len.float()
    covered = torch.clamp(lens, max=float(budget_tokens))
    return covered.mean() / torch.clamp(lens.mean(), min=1.0)


def _block_topk_partial(state: DecodeState, si: int, q: torch.Tensor,
                        lsh: LSHConfig):
    """Block-top-k partial over the offload region: (out, lse, realized
    fraction as a device scalar). Quantized offload (int8, or packed int4
    K) with the "rescore" pipeline ranks by block max and rescores the
    chosen blocks; otherwise the scores are stored and the chosen blocks
    attended from them."""
    bs = lsh.block_topk_block_size
    nb = state.off_k[si].shape[2] // bs
    blocks = min(_static_budget(nb, lsh.block_topk_budget_frac, floor=1), nb)
    quant = lsh.offload_quantized
    k, v, length = state.off_k[si], state.off_v[si], state.off_len
    k_scale = state.off_k_scale[si] if quant else None
    v_scale = state.off_v_scale[si] if quant else None
    if quant and lsh.block_topk_pipeline == "rescore":
        blk_max = block_rank(q, k, k_scale, length, bs)
        blk_ids = torch.topk(blk_max, blocks, dim=-1).indices.to(torch.int32)
        out, lse = rescore_attend(q, blk_ids, k, k_scale, v, v_scale, length,
                                  bs)
    else:
        scores, blk_max = exact_scores_ranked(q, k, k_scale, length, bs)
        blk_ids = torch.topk(blk_max, blocks, dim=-1).indices.to(torch.int32)
        out, lse = block_attend(scores, blk_ids, v, v_scale, bs)
    return out, lse, _realized_frac(blocks * bs, length)


def _off_kv(state: DecodeState, si: int, lsh: LSHConfig):
    """The offload K/V [B, Hkv, off_cap, d] as the baselines read them:
    dequantized to bf16 when quantized (the 4-bit K grid is stored in the
    int8 layout for them), else as stored."""
    k, v = state.off_k[si], state.off_v[si]
    if lsh.offload_quantized:
        k = dequantize_rows(k, state.off_k_scale[si], torch.bfloat16)
        v = dequantize_rows(v, state.off_v_scale[si], torch.bfloat16)
    return k, v


def _baseline_partial(state: DecodeState, si: int, q: torch.Tensor,
                      lsh: LSHConfig):
    """Quest, TopK or OracleSampling over the offload region: (out, lse,
    realized fraction as a device scalar). Budgets are static, from the
    offload capacity (Quest's in pages, at least 1; the others' in tokens,
    at least 16); oracle sampling's uniforms come from the state's decode
    step and the layer."""
    off_cap = state.off_v[si].shape[2]
    k, v = _off_kv(state, si, lsh)
    length = state.off_len
    if lsh.estimator == "quest":
        page = lsh.quest_page_size
        pages = _static_budget(off_cap // page, lsh.quest_budget_frac, floor=1)
        out, lse = quest_decode(q, k, v, state.quest_min[si],
                                state.quest_max[si], length, page, pages)
        return out, lse, _realized_frac(pages * page, length)
    if lsh.estimator == "topk":
        n = _static_budget(off_cap, lsh.topk_budget_frac, floor=16)
        out, lse = topk_decode(q, k, v, length, n)
        return out, lse, _realized_frac(n, length)
    n = _static_budget(off_cap, lsh.os_budget_frac, floor=16)
    b, hq, _ = q.shape
    hkv = k.shape[1]
    u = counter_uniforms(OS_SEED, state.step, si, (b, hkv, hq // hkv, n))
    out, lse = oracle_sampling_decode(q, k, v, length, n, u)
    return out, lse, _realized_frac(n, length)


def decode_sparse_layer(state: DecodeState, si: int, q: torch.Tensor,
                        k_new: torch.Tensor, v_new: torch.Tensor,
                        projections: torch.Tensor, lsh: LSHConfig,
                        window: int | None = None):
    """Hot dense partial + the estimator's partial over the offload region,
    merged by LSE. With a sliding `window`, sink token i (hot row i, at
    absolute position i) drops out of the hot partial once pos - i >=
    window; every later hot row is inside the window (`LLM` refuses a
    window no larger than the hot capacity). Returns (out [B, Hq, d] f32,
    sampled or covered fraction as a device scalar)."""
    if lsh.estimator == "lsh":
        k_new = (k_new.float() - state.avg_k[si]).to(k_new.dtype)
    at = _append_at(state.hot_len, state.hot_k[si].shape[2])
    _append(state.hot_k[si], k_new, at)
    _append(state.hot_v[si], v_new, at)
    start = (None if window is None else
             torch.clamp(state.pos - window + 1, 0, lsh.num_sink_tokens))
    o_hot, lse_hot = flash_decode(q, state.hot_k[si], state.hot_v[si],
                                  state.hot_len + 1, start=start)
    if lsh.estimator == "lsh":
        o_off, lse_off, frac = _lsh_partial(state, si, q, projections, lsh)
    elif lsh.estimator == "block_topk":
        o_off, lse_off, frac = _block_topk_partial(state, si, q, lsh)
    else:
        o_off, lse_off, frac = _baseline_partial(state, si, q, lsh)
    out, _ = merge_partials([o_hot, o_off], [lse_hot, lse_off])
    return out, frac
