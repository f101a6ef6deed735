// Building blocks shared by the split-sequence decode kernels
// (flash_decode.cu, lsh_fused.cu): one block of 128 threads walks one
// 512-token split of one (request, kv head) in 64-token tiles; the G query
// heads of the kv head share each tile. Partials are (out / l, lse) per
// (split, request, query head); launch_merge combines them by LSE.
//
// K/V come as bf16 rows, or as int8 rows with one f32 scale per (token,
// kv head) row: an int8 tile is widened to bf16 in shared memory (exact)
// and its scales kept beside it; the K scale multiplies the score after the
// dot and the V scale multiplies the probability in the P.V sum, as in the
// TPU kernels.
#pragma once

#include "common.cuh"

namespace mp {

constexpr int kDecD = 64;          // head dim
constexpr int kDecThreads = 128;
constexpr int kDecTile = 64;       // tokens per shared-memory tile
constexpr int kDecChunk = 512;     // tokens per split (one block)
constexpr int kDecPad = kDecD + 8; // row stride (bf16): 16-byte reads of
                                   // 8 consecutive rows hit distinct banks

template <int G>
struct __align__(16) DecodeTileSmem {
  __nv_bfloat16 ks[kDecTile][kDecPad];
  __nv_bfloat16 vs[kDecTile][kDecPad];
  float ksc[kDecTile];     // int8 K/V only: the tile's row scales
  float vsc[kDecTile];
  float qf[G][kDecD];      // query (pre-scaled for dense decode)
  float ps[G][kDecTile];   // scores, then probabilities, of one tile
  float alpha[G];          // rescale of the accumulators for this tile
  float m[G];
  float l[G];
};

// Rows t0..t0+63 of K and V into shared memory; rows at or past `stop`,
// and rows whose bit in `rowmask` (two words, or null for all) is clear,
// are zero-filled instead of read.
template <int G>
__device__ __forceinline__ void load_kv_tile(DecodeTileSmem<G>& sm,
                                             const __nv_bfloat16* k_h,
                                             const __nv_bfloat16* v_h, int t0,
                                             int stop, int tid,
                                             const uint32_t* rowmask) {
  for (int c = tid; c < kDecTile * (kDecD / 8); c += kDecThreads) {
    const int row = c / (kDecD / 8);
    const int col = (c % (kDecD / 8)) * 8;
    const int t = t0 + row;
    bool need = t < stop;
    if (rowmask != nullptr) need = need && ((rowmask[row >> 5] >> (row & 31)) & 1u);
    uint4 kx = make_uint4(0, 0, 0, 0), vx = make_uint4(0, 0, 0, 0);
    if (need) {
      kx = *reinterpret_cast<const uint4*>(k_h + static_cast<size_t>(t) * kDecD + col);
      vx = *reinterpret_cast<const uint4*>(v_h + static_cast<size_t>(t) * kDecD + col);
    }
    *reinterpret_cast<uint4*>(&sm.ks[row][col]) = kx;
    *reinterpret_cast<uint4*>(&sm.vs[row][col]) = vx;
  }
}

// The same for int8 rows with f32 scales (k_s, v_s: the head's [S]
// scales): rows are widened to bf16, exact for int8 values; a row not read
// gets zeros and scale 0.
template <int G>
__device__ __forceinline__ void load_kv_tile(DecodeTileSmem<G>& sm,
                                             const int8_t* k_h,
                                             const int8_t* v_h,
                                             const float* k_s,
                                             const float* v_s, int t0,
                                             int stop, int tid,
                                             const uint32_t* rowmask) {
  for (int c = tid; c < kDecTile * (kDecD / 8); c += kDecThreads) {
    const int row = c / (kDecD / 8);
    const int col = (c % (kDecD / 8)) * 8;
    const int t = t0 + row;
    bool need = t < stop;
    if (rowmask != nullptr) need = need && ((rowmask[row >> 5] >> (row & 31)) & 1u);
    uint2 kx = make_uint2(0, 0), vx = make_uint2(0, 0);
    if (need) {
      kx = *reinterpret_cast<const uint2*>(k_h + static_cast<size_t>(t) * kDecD + col);
      vx = *reinterpret_cast<const uint2*>(v_h + static_cast<size_t>(t) * kDecD + col);
    }
    *reinterpret_cast<uint4*>(&sm.ks[row][col]) = widen_int8x8(kx);
    *reinterpret_cast<uint4*>(&sm.vs[row][col]) = widen_int8x8(vx);
    if (col == 0) {
      sm.ksc[row] = need ? k_s[t] : 0.f;
      sm.vsc[row] = need ? v_s[t] : 0.f;
    }
  }
}

__device__ __forceinline__ float row_dot(const __nv_bfloat16 (&krow)[kDecPad],
                                         const float* q) {
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < kDecD / 8; ++i)
    acc += dot8(*reinterpret_cast<const uint4*>(&krow[8 * i]), q + 8 * i);
  return acc;
}

template <int G>
__device__ __forceinline__ void write_empty_partial(float* part_o,
                                                    float* part_lse,
                                                    float* part_cnt,
                                                    size_t part, int tid) {
  for (int i = tid; i < G * kDecD; i += kDecThreads)
    part_o[part * kDecD + i] = 0.f;
  if (tid < G) {
    part_lse[part + tid] = kNegInf;
    if (part_cnt != nullptr) part_cnt[part + tid] = 0.f;
  }
}

// Online softmax over tiles of log2-unit scores in sm.ps. Warp w owns the
// running (max, sum) of heads w, w + 4, ...; each thread owns G*64/128 output
// accumulators.
template <int G>
struct OnlineSoftmax {
  static constexpr int kWarps = kDecThreads / 32;
  static constexpr int kHeadsPerWarp = (G + kWarps - 1) / kWarps;
  static constexpr int kAcc = (G * kDecD + kDecThreads - 1) / kDecThreads;
  float m[kHeadsPerWarp];
  float l[kHeadsPerWarp];
  float acc[kAcc];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int i = 0; i < kHeadsPerWarp; ++i) {
      m[i] = kNegInf;
      l[i] = 0.f;
    }
#pragma unroll
    for (int r = 0; r < kAcc; ++r) acc[r] = 0.f;
  }

  template <bool kScaleV>
  static __device__ __forceinline__ float p_of(const DecodeTileSmem<G>& sm,
                                               int g, int j) {
    return kScaleV ? sm.ps[g][j] * sm.vsc[j] : sm.ps[g][j];
  }

  // Scores -> probabilities in place; sets sm.alpha. Needs a barrier
  // before and after.
  __device__ __forceinline__ void softmax_tile(DecodeTileSmem<G>& sm,
                                               int tid) {
    const int warp = tid >> 5, lane = tid & 31;
#pragma unroll
    for (int i = 0; i < kHeadsPerWarp; ++i) {
      const int g = warp + kWarps * i;
      if (g >= G) break;
      const float x0 = sm.ps[g][lane], x1 = sm.ps[g][lane + 32];
      const float mx = warp_max(fmaxf(x0, x1));
      const float mn = fmaxf(m[i], mx);
      const float mu = mn == kNegInf ? 0.f : mn;
      const float al = exp2f(m[i] - mu);
      const float p0 = exp2f(x0 - mu), p1 = exp2f(x1 - mu);
      sm.ps[g][lane] = p0;
      sm.ps[g][lane + 32] = p1;
      l[i] = l[i] * al + warp_sum(p0 + p1);
      m[i] = mn;
      if (lane == 0) sm.alpha[g] = al;
    }
  }

  // kScaleV: int8 V, each probability times its row's V scale.
  template <bool kScaleV>
  __device__ __forceinline__ void accumulate_pv(const DecodeTileSmem<G>& sm,
                                                int tid) {
#pragma unroll
    for (int r = 0; r < kAcc; ++r) {
      const int idx = tid + r * kDecThreads;
      if (idx < G * kDecD) {
        const int g = idx / kDecD, d = idx % kDecD;
        float a = acc[r] * sm.alpha[g];
#pragma unroll 8
        for (int j = 0; j < kDecTile; ++j)
          a = fmaf(p_of<kScaleV>(sm, g, j), __bfloat162float(sm.vs[j][d]), a);
        acc[r] = a;
      }
    }
  }

  // The same over only the tile's rows set in `rowmask` (two words, the
  // same for every thread): rows outside it have probability 0 for every
  // head, so the sum is unchanged, term for term.
  template <bool kScaleV>
  __device__ __forceinline__ void accumulate_pv_rows(
      const DecodeTileSmem<G>& sm, int tid, const uint32_t* rowmask) {
    const uint32_t w0 = rowmask[0], w1 = rowmask[1];
#pragma unroll
    for (int r = 0; r < kAcc; ++r) {
      const int idx = tid + r * kDecThreads;
      if (idx < G * kDecD) {
        const int g = idx / kDecD, d = idx % kDecD;
        float a = acc[r] * sm.alpha[g];
        for (uint32_t m = w0; m != 0u; m &= m - 1u) {
          const int j = __ffs(m) - 1;
          a = fmaf(p_of<kScaleV>(sm, g, j), __bfloat162float(sm.vs[j][d]), a);
        }
        for (uint32_t m = w1; m != 0u; m &= m - 1u) {
          const int j = 32 + __ffs(m) - 1;
          a = fmaf(p_of<kScaleV>(sm, g, j), __bfloat162float(sm.vs[j][d]), a);
        }
        acc[r] = a;
      }
    }
  }

  // Normalised partial output and its natural-log LSE.
  __device__ __forceinline__ void write_partial(DecodeTileSmem<G>& sm,
                                                float* part_o,
                                                float* part_lse, size_t part,
                                                int tid) {
    const int warp = tid >> 5, lane = tid & 31;
#pragma unroll
    for (int i = 0; i < kHeadsPerWarp; ++i) {
      const int g = warp + kWarps * i;
      if (g < G && lane == 0) {
        sm.m[g] = m[i];
        sm.l[g] = l[i];
      }
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kAcc; ++r) {
      const int idx = tid + r * kDecThreads;
      if (idx < G * kDecD) {
        const float li = sm.l[idx / kDecD];
        part_o[part * kDecD + idx] = li > 0.f ? acc[r] / li : 0.f;
      }
    }
    if (tid < G)
      part_lse[part + tid] =
          sm.l[tid] > 0.f ? sm.m[tid] * kLn2 + logf(sm.l[tid]) : kNegInf;
  }
};

// Merge `nsplit` partials of `rows` (request, query head) rows each:
// part_o [nsplit, rows, 64], part_lse and part_cnt [nsplit, rows] (part_cnt
// and cnt may be null). Defined in flash_decode.cu.
int launch_merge(const float* part_o, const float* part_lse,
                 const float* part_cnt, float* out, float* lse, float* cnt,
                 int nsplit, int rows, cudaStream_t stream);

}  // namespace mp
