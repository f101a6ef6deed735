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
#include <type_traits>

#include "block_common.cuh"
#include "hopper_common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTileKeys = 32;      // keys a warp takes at a time
constexpr int kScPad = 36;         // staged score row stride (floats)

// A warp's stage: the tile's key rows, then their 32 f32 scales. Two
// stages for rows of 128 bytes or more (bf16 at d = 64; int8 and bf16 at
// d = 128), four for the narrower ones. bf16 at d = 128 (256-byte rows)
// takes 71 KB, above the 48 KB a block gets without the dynamic-size
// attribute (set at the first launch).
template <typename KT, int kD>
struct Ring {
  static constexpr int kRowBytes = mp::key_row_bytes<KT, kD>();
  static constexpr int kStages = kRowBytes >= 128 ? 2 : 4;
  static constexpr int kBytes = kTileKeys * kRowBytes + kTileKeys * 4;
  static constexpr int kSmem =
      kWarps * kStages * kBytes + kWarps * 8 * kScPad * 4;
  static_assert(kSmem <= 227 * 1024, "a block's shared memory on the H100");
};

// kRank: mask at the length and store the block max (else score every
// token, store no block max; length and block_max are unused). kD: the
// head dim, 64 or 128.
template <int G, typename KT, bool kStoreScores, bool kRank, int kD>
__global__ void __launch_bounds__(kThreads)
block_score_kernel(const __nv_bfloat16* __restrict__ q,
                   const KT* __restrict__ k,
                   const float* __restrict__ k_scale,
                   const int* __restrict__ length,
                   float* __restrict__ scores,
                   float* __restrict__ block_max, int s_cap, int hkv,
                   int block_size, float sm_scale) {
  using namespace mp;
  using R = Ring<KT, kD>;
  constexpr bool kBf16 = std::is_same<KT, __nv_bfloat16>::value;
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ float red[kWarps];

  const int blk = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int nb = gridDim.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int len = kRank ? min(length[b], s_cap) : s_cap;
  const int t0 = blk * block_size;
  const size_t head = static_cast<size_t>(b) * hkv + kh;
  float* sc = kStoreScores ? scores + head * G * s_cap : nullptr;

  if (t0 >= len) {
    if (kStoreScores)
      for (int i = tid; i < G * block_size; i += kThreads)
        sc[static_cast<size_t>(i / block_size) * s_cap + t0 +
           i % block_size] = kNegInf;
    if (tid == 0) block_max[head * nb + blk] = kNegInf;
    return;
  }
  const int stop = min(len, t0 + block_size);
  uint32_t qb[kD / 16][2];
  load_q_frag<G, kD>(q + head * G * kD, sm_scale, lane, qb);

  const uint8_t* k_h = reinterpret_cast<const uint8_t*>(k) +
                       head * s_cap * R::kRowBytes;
  const float* ks_h = kBf16 ? nullptr : k_scale + head * s_cap;
  uint8_t* ring = smem + warp * R::kStages * R::kBytes;
  float* staged = reinterpret_cast<float*>(smem + kWarps * R::kStages * R::kBytes) +
                  warp * 8 * kScPad;
  // This warp's tiles: warp, warp + 4, ...; the first `nv` have a key
  // below the length.
  const int ntiles = block_size / kTileKeys;
  const int nvalid = (stop - t0 + kTileKeys - 1) / kTileKeys;
  const int mine = (ntiles - warp + kWarps - 1) / kWarps;
  const int nv = nvalid > warp ? (nvalid - warp + kWarps - 1) / kWarps : 0;

  auto fetch = [&](int j) {
    const int tok0 = t0 + (warp + kWarps * j) * kTileKeys;
    uint8_t* dst = ring + (j % R::kStages) * R::kBytes;
    constexpr int kUnits = R::kRowBytes / 16;
#pragma unroll
    for (int c = lane; c < kTileKeys * kUnits; c += 32) {
      const int r = c / kUnits, u = c % kUnits;
      const bool ok = tok0 + r < stop;
      const uint8_t* src = k_h +
          static_cast<size_t>(ok ? tok0 + r : tok0) * R::kRowBytes + 16 * u;
      hp::cp_async_16(dst + r * R::kRowBytes + 16 * (kBf16 ? u ^ (r & 1) : u),
                      src, ok);
    }
    if (!kBf16 && lane < kTileKeys / 4)
      hp::cp_async_16(dst + kTileKeys * R::kRowBytes + 16 * lane,
                      ks_h + tok0 + 4 * lane);
  };

  const int r = lane >> 2, t = lane & 3;
  float mx = kNegInf;
#pragma unroll
  for (int j = 0; j < R::kStages - 1; ++j) {
    if (j < nv) fetch(j);
    hp::cp_async_commit();
  }
  for (int j = 0; j < nv; ++j) {
    if (j + R::kStages - 1 < nv) fetch(j + R::kStages - 1);
    hp::cp_async_commit();
    hp::cp_async_wait<R::kStages - 1>();
    __syncwarp();
    const uint8_t* st = ring + (j % R::kStages) * R::kBytes;
    const float* scl = reinterpret_cast<const float*>(st + kTileKeys * R::kRowBytes);
    const int tok0 = t0 + (warp + kWarps * j) * kTileKeys;
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int ka = 16 * m + r, kb = ka + 8;
      uint4 xa[kD / 32], xb[kD / 32];
      key_chunks<kD>(st + ka * R::kRowBytes, t, ka & 1, xa, k);
      key_chunks<kD>(st + kb * R::kRowBytes, t, kb & 1, xb, k);
      uint32_t wa[kD / 8], wb[kD / 8];
      key_words<kD>(xa, t, wa, k);
      key_words<kD>(xb, t, wb, k);
      float d[4];
      mma_scores<kD>(wa, wb, qb, d);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = i < 2 ? ka : kb, h = 2 * t + (i & 1);
        const float s = tok0 + key < stop
                            ? score_of(d[i], kBf16 ? 1.f : scl[key])
                            : kNegInf;
        if (h < G) {
          mx = fmaxf(mx, s);
          if (kStoreScores) staged[h * kScPad + key] = s;
        }
      }
    }
    if (kStoreScores) {
      __syncwarp();
      for (int c = lane; c < G * kTileKeys / 4; c += 32) {
        const int h = c / (kTileKeys / 4), p = c % (kTileKeys / 4);
        __stcs(reinterpret_cast<float4*>(sc + static_cast<size_t>(h) * s_cap +
                                         tok0 + 4 * p),
               *reinterpret_cast<const float4*>(staged + h * kScPad + 4 * p));
      }
    }
    __syncwarp();
  }
  if (kStoreScores)   // this warp's tiles wholly past the length
    for (int j = nv; j < mine; ++j) {
      const int tok0 = t0 + (warp + kWarps * j) * kTileKeys;
      for (int c = lane; c < G * kTileKeys / 4; c += 32)
        *reinterpret_cast<float4*>(sc + static_cast<size_t>(c / (kTileKeys / 4)) *
                                            s_cap + tok0 + 4 * (c % (kTileKeys / 4))) =
            make_float4(kNegInf, kNegInf, kNegInf, kNegInf);
    }
  if (!kRank) return;
  mx = warp_max(mx);
  if (lane == 0) red[warp] = mx;
  __syncthreads();
  if (tid == 0) {
    float m = red[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) m = fmaxf(m, red[w]);
    block_max[head * nb + blk] = m;
  }
}

// One variant: its shared memory allowed at its first launch (bf16 at d =
// 128 needs more than the default 48 KB).
template <int G, typename KT, bool kStoreScores, bool kRank, int kD>
int launch_variant(const void* q, const void* k, const void* k_scale,
                   const void* length, void* scores, void* block_max,
                   int batch, int s_cap, int hkv, int block_size,
                   float sm_scale, cudaStream_t stream) {
  constexpr int kSmem = Ring<KT, kD>::kSmem;
  auto* kernel = block_score_kernel<G, KT, kStoreScores, kRank, kD>;
  static unsigned smem_set = 0;
  const cudaError_t err = hp::allow_smem(kernel, kSmem, smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(s_cap / block_size, hkv, batch);
  kernel<<<grid, kThreads, kSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const KT*>(k),
      static_cast<const float*>(k_scale), static_cast<const int*>(length),
      static_cast<float*>(scores), static_cast<float*>(block_max), s_cap,
      hkv, block_size, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <int G, typename KT, int kD>
int launch(const void* q, const void* k, const void* k_scale,
           const void* length, void* scores, void* block_max, int batch,
           int s_cap, int hkv, int block_size, float sm_scale,
           cudaStream_t stream) {
  if (block_max == nullptr)
    return launch_variant<G, KT, true, false, kD>(
        q, k, k_scale, length, scores, block_max, batch, s_cap, hkv,
        block_size, sm_scale, stream);
  if (scores != nullptr)
    return launch_variant<G, KT, true, true, kD>(
        q, k, k_scale, length, scores, block_max, batch, s_cap, hkv,
        block_size, sm_scale, stream);
  return launch_variant<G, KT, false, true, kD>(
      q, k, k_scale, length, nullptr, block_max, batch, s_cap, hkv,
      block_size, sm_scale, stream);
}

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
// exactly for bf16 K; head_dim 64 or 128; hq / hkv 1, 2, 4 or 8, or 3 at
// head dim 128.
extern "C" int mp_block_score(const void* q, const void* k,
                              const void* k_scale, const void* length,
                              void* scores, void* block_max, int batch,
                              int s_cap, int hq, int hkv, int head_dim,
                              int block_size, int k_kind, float sm_scale,
                              void* stream) {
  if ((head_dim != 64 && head_dim != 128) || hkv <= 0 || hq % hkv != 0 ||
      block_size <= 0 || block_size % 64 != 0 || s_cap % block_size != 0 ||
      (k_kind != mp::kKeyBf16) != (k_scale != nullptr) ||
      (scores == nullptr && block_max == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (head_dim == 128)
    return dispatch_kind<128>(k_kind, hq / hkv, q, k, k_scale, length,
                              scores, block_max, batch, s_cap, hkv,
                              block_size, sm_scale, st);
  return dispatch_kind<64>(k_kind, hq / hkv, q, k, k_scale, length, scores,
                           block_max, batch, s_cap, hkv, block_size,
                           sm_scale, st);
}
