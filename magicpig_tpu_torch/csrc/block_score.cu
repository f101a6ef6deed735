// Exact block scorer of the block_topk estimator: the scaled scores q.K of
// every offloaded key for the G query heads of its kv head, with the
// per-row K scale and the length mask, and the max of each ranking block
// over the G heads and the block's tokens. One kernel, three variants by
// compile-time flags: block max only (block_rank), scores and block max
// (exact_scores_ranked), or scores only, unmasked (exact_scores).
//
// Replaces magicpig_tpu/ops/pallas/score.py::_scores_call (the pallas_call
// at score.py:225), reached through block_rank (score.py:301),
// exact_scores_ranked (score.py:272), and exact_scores_folded (score.py:251)
// and exact_scores (score.py:326), whose token-order scores the port's
// layout stores directly (bf16 or int8 K); int8 K with f32 row scales, packed
// int4 K with f32 row scales (its packed=True form, score.py:62-92, in the
// port's layout: two channels a byte, tokens in order), or bf16 K.
//
// Bound on the H100: reading K once (32 bytes a token and kv head in packed
// int4, 64 in int8, 128 in bf16 at d = 64; twice that at d = 128, a
// template instance of the same kernel) plus its scales, and in the
// score-storing variants writing 4 bytes a token and query head; ~2 flops
// per byte, so device memory bounds it. A thread-a-token design (eight
// 16-byte loads a row, G x 64 fmaf on CUDA cores reading q from shared
// memory, at d = 64) lost to a
// bf16 matmul by 1.4x on the H100; this one streams K through shared memory
// and runs the dot on the tensor cores. One block of four warps takes one
// (ranking block, kv head, request), 2048 blocks at B = 2, Hkv = 8, S = 64K
// (blocks of 2048 keys, four ranking blocks each, measured slower: fewer
// warps in flight); a block wholly at or past the request's length writes
// -inf and reads no K (exact_scores masks nothing: every token is scored).
// Each warp owns every fourth 32-key tile of the block and streams it
// through its own ring of shared-memory stages (two for rows of 128 bytes
// or more, four for the narrower ones; measured at d = 64; bf16 at d = 128
// takes 71 KB, dynamic shared memory) with 16-byte cp.async copies,
// neighbouring lanes on neighbouring bytes, rows at or past the length
// zero-filled and never read (bf16 units swizzled so that the lanes'
// 16-byte reads hit distinct
// banks); no block barrier until the block max. The dot is the score
// routine of block_common.cuh (mma.sync, int8 and int4 widened to bf16 in
// registers, exact), which the rescore calls too. The epilogue scales by
// the row's K scale, masks at the length, stages the tile in shared memory
// so that each head's 32 scores leave as 16-byte streaming stores, and
// takes the block max by warp shuffles and one shared-memory reduce.
// Head dims 16 and 32 read their rows as 64 channels with zeros past d
// (block_common.cuh, `frag_dim`). Group sizes: the exact instances (1, 2, 4
// and 8 at d = 64 and 128, and 3 at 128), else the general tile
// (block_score.cuh, `block_score_tile_kernel`): a block takes up to 16
// query heads of its kv head (ceil(G / 16) blocks above that), K arrives by
// bulk copies into a ring under mbarriers and is widened once for every
// head of the block, and the blocks of heads of one kv head combine their
// block maxes by an atomic max.
#include "block_score.cuh"

namespace {

// Group sizes 1, 2, 4 and 8, and 3 at head dim 128 only.
template <typename KT, int kD>
int dispatch(int g, const void* q, const void* k, const void* k_scale,
             const void* length, void* scores, void* block_max, int batch,
             int s_cap, int hkv, int block_size, float sm_scale,
             cudaStream_t st) {
  switch (g) {
    case 1: return launch<1, KT, kD>(q, k, k_scale, length, scores,
                                     block_max, batch, s_cap, hkv,
                                     block_size, sm_scale, st);
    case 2: return launch<2, KT, kD>(q, k, k_scale, length, scores,
                                     block_max, batch, s_cap, hkv,
                                     block_size, sm_scale, st);
    case 3:
      if constexpr (kD == 128)
        return launch<3, KT, kD>(q, k, k_scale, length, scores, block_max,
                                 batch, s_cap, hkv, block_size, sm_scale, st);
      return static_cast<int>(cudaErrorInvalidValue);
    case 4: return launch<4, KT, kD>(q, k, k_scale, length, scores,
                                     block_max, batch, s_cap, hkv,
                                     block_size, sm_scale, st);
    case 8: return launch<8, KT, kD>(q, k, k_scale, length, scores,
                                     block_max, batch, s_cap, hkv,
                                     block_size, sm_scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int kD>
int dispatch_kind(int k_kind, int g, const void* q, const void* k,
                  const void* k_scale, const void* length, void* scores,
                  void* block_max, int batch, int s_cap, int hkv,
                  int block_size, float sm_scale, cudaStream_t st) {
  switch (k_kind) {
    case mp::kKeyBf16:
      return dispatch<__nv_bfloat16, kD>(g, q, k, k_scale, length, scores,
                                         block_max, batch, s_cap, hkv,
                                         block_size, sm_scale, st);
    case mp::kKeyInt8:
      return dispatch<int8_t, kD>(g, q, k, k_scale, length, scores,
                                  block_max, batch, s_cap, hkv, block_size,
                                  sm_scale, st);
    case mp::kKeyInt4:
      return dispatch<mp::Int4x2, kD>(g, q, k, k_scale, length, scores,
                                      block_max, batch, s_cap, hkv,
                                      block_size, sm_scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// scores may be null (block max only), or block_max null (scores only,
// unmasked: length unused); k_kind is a KeyKind, and k_scale is null
// exactly for bf16 K; head_dim 16, 32, 64 or 128 (packed int4 at 64 and
// 128); hq any multiple of hkv (exact instances at hq / hkv 1, 2, 4 and 8,
// and 3 at head dim 128; the general tile otherwise). Above 16 query heads
// a kv head block_max must hold -inf at the call (its blocks of heads
// combine their maxes by an atomic max).
extern "C" int mp_block_score(const void* q, const void* k,
                              const void* k_scale, const void* length,
                              void* scores, void* block_max, int batch,
                              int s_cap, int hq, int hkv, int head_dim,
                              int block_size, int k_kind, float sm_scale,
                              void* stream) {
  if (!mp::head_dim_ok(head_dim) || hkv <= 0 || hq < hkv || hq % hkv != 0 ||
      block_size <= 0 || block_size % 64 != 0 || s_cap % block_size != 0 ||
      (k_kind != mp::kKeyBf16) != (k_scale != nullptr) ||
      (k_kind == mp::kKeyInt4 && head_dim < 64) ||
      (scores == nullptr && block_max == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int g = hq / hkv;
  if (!mp::exact_group(g, head_dim))
    return mp::block_score_part(k_kind, head_dim, g, q, k, k_scale, length,
                                scores, block_max, batch, s_cap, hkv,
                                block_size, sm_scale, st);
  if (head_dim == 128)
    return dispatch_kind<128>(k_kind, g, q, k, k_scale, length,
                              scores, block_max, batch, s_cap, hkv,
                              block_size, sm_scale, st);
  return dispatch_kind<64>(k_kind, g, q, k, k_scale, length, scores,
                           block_max, batch, s_cap, hkv, block_size,
                           sm_scale, st);
}
