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
// int4, 64 in int8, 128 in bf16) plus its scales, and in the
// exact_scores_ranked variant
// writing 4 bytes a token and query head (both score-storing variants);
// ~2 flops per byte, so device
// memory bounds it. Design: the TPU grid walks (request, kv head, 64K-token
// tile) in order on one core; here one block of 128 threads takes one
// (ranking block, kv head, request), 2048 blocks at B = 2, Hkv = 8, S = 64K.
// A block wholly at or past the request's length writes -inf and reads no
// K (exact_scores masks nothing: every token is scored). Each thread scores whole tokens: it loads a key row in 16-byte pieces
// and sums against the G bf16-rounded queries held in shared memory (one
// shared function, token_scores, that the rescore kernel calls too). The
// block max is a warp shuffle and a shared-memory reduce, stored once.
#include "block_common.cuh"

namespace {

// kRank: mask at the length and store the block max (else score every
// token, store no block max; length and block_max are unused).
template <int G, typename KT, bool kStoreScores, bool kRank>
__global__ void __launch_bounds__(mp::kBlkThreads)
block_score_kernel(const __nv_bfloat16* __restrict__ q,
                   const KT* __restrict__ k,
                   const float* __restrict__ k_scale,
                   const int* __restrict__ length,
                   float* __restrict__ scores,
                   float* __restrict__ block_max, int s_cap, int hkv,
                   int block_size, float sm_scale) {
  using namespace mp;
  __shared__ float qs[G][kBlkD];
  __shared__ float red[kBlkThreads / 32];

  const int blk = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int nb = gridDim.x;
  const int tid = threadIdx.x;
  const int len = kRank ? min(length[b], s_cap) : s_cap;
  const int t0 = blk * block_size;
  const size_t head = static_cast<size_t>(b) * hkv + kh;
  float* sc = kStoreScores ? scores + head * G * s_cap : nullptr;

  if (t0 >= len) {
    if (kStoreScores)
      for (int i = tid; i < G * block_size; i += kBlkThreads)
        sc[static_cast<size_t>(i / block_size) * s_cap + t0 +
           i % block_size] = kNegInf;
    if (tid == 0) block_max[head * nb + blk] = kNegInf;
    return;
  }
  load_scaled_q<G>(qs, q + head * G * kBlkD, sm_scale, tid);
  __syncthreads();

  constexpr int kRow = KeyRow<KT>::kElems;
  const KT* k_h = k + head * s_cap * kRow;
  const float* ks_h = k_scale != nullptr ? k_scale + head * s_cap : nullptr;
  float mx = kNegInf;
  for (int i = tid; i < block_size; i += kBlkThreads) {
    const int t = t0 + i;
    float s[G];
    if (t < len) {
      token_scores<G>(k_h + static_cast<size_t>(t) * kRow,
                      ks_h != nullptr ? ks_h[t] : 1.f, qs, s);
    } else {
#pragma unroll
      for (int g = 0; g < G; ++g) s[g] = kNegInf;
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      mx = fmaxf(mx, s[g]);
      if (kStoreScores) sc[static_cast<size_t>(g) * s_cap + t] = s[g];
    }
  }
  if (!kRank) return;
  mx = warp_max(mx);
  if ((tid & 31) == 0) red[tid >> 5] = mx;
  __syncthreads();
  if (tid == 0) {
    float m = red[0];
#pragma unroll
    for (int w = 1; w < kBlkThreads / 32; ++w) m = fmaxf(m, red[w]);
    block_max[head * nb + blk] = m;
  }
}

template <int G, typename KT>
int launch(const void* q, const void* k, const void* k_scale,
           const void* length, void* scores, void* block_max, int batch,
           int s_cap, int hkv, int block_size, float sm_scale,
           cudaStream_t stream) {
  dim3 grid(s_cap / block_size, hkv, batch);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const KT*>(k);
  const auto* ks = static_cast<const float*>(k_scale);
  const auto* lp = static_cast<const int*>(length);
  auto* bm = static_cast<float*>(block_max);
  auto* sc = static_cast<float*>(scores);
  if (block_max == nullptr)
    block_score_kernel<G, KT, true, false><<<grid, mp::kBlkThreads, 0,
                                             stream>>>(
        qp, kp, ks, lp, sc, bm, s_cap, hkv, block_size, sm_scale);
  else if (scores != nullptr)
    block_score_kernel<G, KT, true, true><<<grid, mp::kBlkThreads, 0,
                                            stream>>>(
        qp, kp, ks, lp, sc, bm, s_cap, hkv, block_size, sm_scale);
  else
    block_score_kernel<G, KT, false, true><<<grid, mp::kBlkThreads, 0,
                                             stream>>>(
        qp, kp, ks, lp, nullptr, bm, s_cap, hkv, block_size, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename KT>
int dispatch(int g, const void* q, const void* k, const void* k_scale,
             const void* length, void* scores, void* block_max, int batch,
             int s_cap, int hkv, int block_size, float sm_scale,
             cudaStream_t st) {
  switch (g) {
    case 1: return launch<1, KT>(q, k, k_scale, length, scores, block_max,
                                 batch, s_cap, hkv, block_size, sm_scale, st);
    case 2: return launch<2, KT>(q, k, k_scale, length, scores, block_max,
                                 batch, s_cap, hkv, block_size, sm_scale, st);
    case 4: return launch<4, KT>(q, k, k_scale, length, scores, block_max,
                                 batch, s_cap, hkv, block_size, sm_scale, st);
    case 8: return launch<8, KT>(q, k, k_scale, length, scores, block_max,
                                 batch, s_cap, hkv, block_size, sm_scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// scores may be null (block max only), or block_max null (scores only,
// unmasked: length unused); k_kind is a KeyKind, and k_scale is null
// exactly for bf16 K.
extern "C" int mp_block_score(const void* q, const void* k,
                              const void* k_scale, const void* length,
                              void* scores, void* block_max, int batch,
                              int s_cap, int hq, int hkv, int head_dim,
                              int block_size, int k_kind, float sm_scale,
                              void* stream) {
  if (head_dim != mp::kBlkD || hq % hkv != 0 || block_size <= 0 ||
      block_size % 64 != 0 || s_cap % block_size != 0 ||
      (k_kind != mp::kKeyBf16) != (k_scale != nullptr) ||
      (scores == nullptr && block_max == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (k_kind) {
    case mp::kKeyBf16:
      return dispatch<__nv_bfloat16>(hq / hkv, q, k, k_scale, length, scores,
                                     block_max, batch, s_cap, hkv,
                                     block_size, sm_scale, st);
    case mp::kKeyInt8:
      return dispatch<int8_t>(hq / hkv, q, k, k_scale, length, scores,
                              block_max, batch, s_cap, hkv, block_size,
                              sm_scale, st);
    case mp::kKeyInt4:
      return dispatch<mp::Int4x2>(hq / hkv, q, k, k_scale, length, scores,
                                  block_max, batch, s_cap, hkv, block_size,
                                  sm_scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
