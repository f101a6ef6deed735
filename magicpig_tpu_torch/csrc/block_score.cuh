// The block scorer's kernel and launch templates (block_score.cu: the
// design, the exact instances and the C entry; block_score_part.cu: the
// general tile's instances, compiled beside them).
#pragma once

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
// head dim, 16, 32, 64 or 128. kPart: the general tile, `group` query
// heads a kv head in sub-groups of G (else group == G).
template <int G, typename KT, bool kStoreScores, bool kRank, int kD,
          bool kPart>
__global__ void __launch_bounds__(kThreads)
block_score_kernel(const __nv_bfloat16* __restrict__ q,
                   const KT* __restrict__ k,
                   const float* __restrict__ k_scale,
                   const int* __restrict__ length,
                   float* __restrict__ scores,
                   float* __restrict__ block_max, int s_cap, int hkv,
                   int group_, int block_size, float sm_scale) {
  using namespace mp;
  using R = Ring<KT, kD>;
  constexpr bool kBf16 = std::is_same<KT, __nv_bfloat16>::value;
  constexpr int kDP = frag_dim(kD);
  const int group = kPart ? group_ : G;
  const int nsub = kPart ? group_blocks(group, G) : 1;
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ float red[kWarps];

  const int blk = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int nb = gridDim.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int len = kRank ? min(length[b], s_cap) : s_cap;
  const int t0 = blk * block_size;
  const size_t head = static_cast<size_t>(b) * hkv + kh;
  float* sc = kStoreScores ? scores + head * group * s_cap : nullptr;

  if (t0 >= len) {
    if (kStoreScores)
      for (int i = tid; i < group * block_size; i += kThreads)
        sc[static_cast<size_t>(i / block_size) * s_cap + t0 +
           i % block_size] = kNegInf;
    if (tid == 0) block_max[head * nb + blk] = kNegInf;
    return;
  }
  const int stop = min(len, t0 + block_size);
  uint32_t qb[kDP / 16][2];
  if constexpr (!kPart) load_q_frag<G, kD>(q + head * G * kD, sm_scale, lane, qb);

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
    for (int sub = 0; sub < nsub; ++sub) {   // one pass for the exact instances
      const int g0 = sub * G, gn = kPart ? min(G, group - g0) : G;
      if constexpr (kPart)
        load_q_frag<G, kD>(q + (head * group + g0) * kD, sm_scale, lane, qb,
                           gn);
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int ka = 16 * m + r, kb = ka + 8;
        uint4 xa[kDP / 32], xb[kDP / 32];
        key_chunks<kD>(st + ka * R::kRowBytes, t, ka & 1, xa, k);
        key_chunks<kD>(st + kb * R::kRowBytes, t, kb & 1, xb, k);
        uint32_t wa[kDP / 8], wb[kDP / 8];
        key_words<kDP>(xa, t, wa, k);
        key_words<kDP>(xb, t, wb, k);
        float d[4];
        mma_scores<kDP>(wa, wb, qb, d);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int key = i < 2 ? ka : kb, h = 2 * t + (i & 1);
          const float s = tok0 + key < stop
                              ? score_of(d[i], kBf16 ? 1.f : scl[key])
                              : kNegInf;
          if (h < gn) {
            mx = fmaxf(mx, s);
            if (kStoreScores) staged[h * kScPad + key] = s;
          }
        }
      }
      if (kStoreScores) {
        __syncwarp();
        for (int c = lane; c < gn * kTileKeys / 4; c += 32) {
          const int h = c / (kTileKeys / 4), p = c % (kTileKeys / 4);
          __stcs(reinterpret_cast<float4*>(
                     sc + static_cast<size_t>(g0 + h) * s_cap + tok0 + 4 * p),
                 *reinterpret_cast<const float4*>(staged + h * kScPad + 4 * p));
        }
      }
      __syncwarp();
    }
  }
  if (kStoreScores)   // this warp's tiles wholly past the length
    for (int j = nv; j < mine; ++j) {
      const int tok0 = t0 + (warp + kWarps * j) * kTileKeys;
      for (int c = lane; c < group * kTileKeys / 4; c += 32)
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
template <int G, typename KT, bool kStoreScores, bool kRank, int kD,
          bool kPart>
int launch_variant(const void* q, const void* k, const void* k_scale,
                   const void* length, void* scores, void* block_max,
                   int batch, int s_cap, int hkv, int group, int block_size,
                   float sm_scale, cudaStream_t stream) {
  constexpr int kSmem = Ring<KT, kD>::kSmem;
  auto* kernel = block_score_kernel<G, KT, kStoreScores, kRank, kD, kPart>;
  static unsigned smem_set = 0;
  const cudaError_t err = hp::allow_smem(kernel, kSmem, smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(s_cap / block_size, hkv, batch);
  kernel<<<grid, kThreads, kSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const KT*>(k),
      static_cast<const float*>(k_scale), static_cast<const int*>(length),
      static_cast<float*>(scores), static_cast<float*>(block_max), s_cap,
      hkv, group, block_size, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

// The variant that `scores` and `block_max` ask for (either may be null).
template <int G, typename KT, int kD, bool kPart = false>
int launch(const void* q, const void* k, const void* k_scale,
           const void* length, void* scores, void* block_max, int batch,
           int s_cap, int hkv, int block_size, float sm_scale,
           cudaStream_t stream, int group = G) {
  if (block_max == nullptr)
    return launch_variant<G, KT, true, false, kD, kPart>(
        q, k, k_scale, length, scores, block_max, batch, s_cap, hkv, group,
        block_size, sm_scale, stream);
  if (scores != nullptr)
    return launch_variant<G, KT, true, true, kD, kPart>(
        q, k, k_scale, length, scores, block_max, batch, s_cap, hkv, group,
        block_size, sm_scale, stream);
  return launch_variant<G, KT, false, true, kD, kPart>(
      q, k, k_scale, length, nullptr, block_max, batch, s_cap, hkv, group,
      block_size, sm_scale, stream);
}

}  // namespace

namespace mp {

// The general tile of every K kind and head dim (block_score_part.cu): k_kind
// a KeyKind (packed int4 at d = 64 and 128 only), `group` query heads a kv
// head; the other arguments as mp_block_score's.
int block_score_part(int k_kind, int head_dim, int group, const void* q,
                     const void* k, const void* k_scale, const void* length,
                     void* scores, void* block_max, int batch, int s_cap,
                     int hkv, int block_size, float sm_scale,
                     cudaStream_t st);

}  // namespace mp
